"""One run of one cell: set-up, the measured (or traced) window, and the
check of what the timed path produced against the plain reference.

A cell is found by name in BENCHMARK.json; its configuration, traffic mix
and limits are files of their own (configs/, traffic/, workloads/), and
each metric is a reader of its own (end_to_end/, metrics/) that takes the
Window below and returns a number, or None where it finds nothing to read.
Whatever depends on the model is its family's (families/<family>.py, named
by the configuration file's `family`, `ipsr` where it names none): see
load_family.

The program under test is `deepinpainting_torch`; the benchmark takes from
it only the entry points it times and their counters.  Kinds of traffic:

  train   the family's train step fed by data/iterator.py::device_batches
          from a pool of seeded uint8 batches; the first steps are the
          warm-up and the steps the reference follows
  closed  the family's serving session from client threads, each sending
          its next request when its last one is answered
  open    the serving session on a seeded Poisson schedule, each request
          timed from when it was due
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import drivers, images
from . import trace as T
from . import weights as W

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WARM_STEPS = 3               # train: the steps the reference follows
FORBIDDEN = ("jax", "jaxlib", "flax", "deepinpainting_tpu")
DEFAULT_FAMILY = "ipsr"


@dataclass
class Cell:
    name: str
    config: Dict                    # the configuration file's fields
    traffic: Dict                   # the traffic file's parameters
    chips: int
    limits: Dict[str, float]
    end_to_end: List[tuple]
    per_layer: List[tuple]
    family: str = DEFAULT_FAMILY
    home: Path = HERE               # the folder of its files


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json",
              home: Path = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json with its files: the configuration
    file where BENCHMARK.json names it, relative to the file's folder, and
    the traffic, workload, family and reader files under `home`."""
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((Path(bench_path).parent / conf["file"]).read_text())
    traffic = json.loads((home / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    own = json.loads((home / "workloads" / f"{name}.json").read_text())

    def listed(metrics):
        return [(m["name"], m["unit"]) for m in metrics
                if name in m.get("workloads", [name])]

    return Cell(name, config, traffic, w["chips"], own["limits"],
                listed(bench["end_to_end"]), listed(bench["per_layer"]),
                config.get("family", DEFAULT_FAMILY), Path(home))


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(kind: str, name: str, home: Path = HERE) -> Callable:
    """The `read` function of <home>/<kind>/<name>.py."""
    return _load_file(Path(home) / kind / f"{name}.py",
                      f"portbench.{kind}.{name.replace('.', '_')}").read


def load_family(name: str, home: Path = HERE):
    """The module <home>/families/<name>.py: a model family's part of the
    benchmark.  It holds, by these names,

      check_cell(config, kind, limits)   raise for a cell it does not state
      program_config(fields)             the program's configuration object
                                         (fine_size, batch_size, dtype,
                                         metrics_every, beta1 and its own)
      networks(cfg, train)               {name: module} on the meta device
      leaf_std(cfg)                      (net, key, shape) -> the std of a
                                         leaf's normal draw, or None
                                         (weights.draw)
      train_state(cfg, nets), train_step(cfg, dev)
                                         the program's state and its step
                                         (state, batch) -> (state, metrics)
      trained(state)                     {name: (module, Adam)} it trains
      session(cfg, nets, traffic, dev)   the serving session: .run(**inputs)
                                         answers uint8 [B,H,W,3], .close(),
                                         ._batcher counts calls and items
      inputs(pool, rows)                 {name: array} of pool rows: a train
                                         batch, or a request's arguments
      flops(kind, shapes, cfg)           {dtype: operations an image}
      launches()                         {kernel: launches so far}
      bounds(window, cfg, pool, dev)     {kernel: least seconds of the
                                         window's launches}
      missing(window)                    kernels.missing on a card
      train_reference(cfg, weights, batches, dev, prec=None)
      serve_reference(cfg, weights, batch, dev, prec=None)
                                         the plain reference's readings and
                                         uint8 answers (prec: a control's)
      train_numbers(program, reference, cfg), serve_numbers(answers,
      reference)                         {number: value} compared
      train_note(...), serve_note(answers)
                                         a line for the run's log
      control(cfg)                       (context, prec): calibrate.py's
    """
    return _load_file(Path(home) / "families" / f"{name}.py",
                      f"portbench.families.{name}")


def family_of(cell: Cell):
    return load_family(cell.family, cell.home)


def program_config(cell: Cell, **override):
    """The program's configuration of the cell (fields of the config
    file, `override` on top)."""
    return family_of(cell).program_config({**cell.config, **override})


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is one the program must not
    load: JAX, its libraries, or the JAX package."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


@dataclass
class Window:
    """What a window produced, for the metric readers."""
    kind: str                       # 'train' or 'serve'
    seconds: float                  # first timed step/request -> last end
    steps: int = 0
    images: int = 0                 # images trained on, or answered
    latencies: List[float] = field(default_factory=list)   # serve, s
    attempted: int = 0
    failed: int = 0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Optional[T.Trace] = None
    flops: Dict[str, float] = field(default_factory=dict)  # an image
    rows: list = field(default_factory=list)     # pool rows of each step or
                                                 # request answered
    bounds: Dict[str, float] = field(default_factory=dict)  # kernel: least s


# ---- the program's networks and weights -------------------------------------

def _load(nets: Dict, weights: Dict, dev) -> None:
    for name, net in nets.items():
        net.to_empty(device=dev)
        net.load_state_dict(weights[name], strict=True)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches(family) -> Dict[str, int]:
    return {f"{k}_launches": v for k, v in family.launches().items()}


# ---- train ------------------------------------------------------------------

def _rows(batch: int, i: int) -> slice:
    return slice(i * batch, (i + 1) * batch)


def _batches(pool, inputs, batch: int, stop: threading.Event):
    """The family's inputs of pool batch i % n until stopped."""
    n = len(pool["image"]) // batch
    i = 0
    while not stop.is_set():
        yield inputs(pool, _rows(batch, i % n))
        i += 1


def _adam_first_grads(trained: Dict, beta1: float) -> Dict[str, float]:
    """Each leaf's first gradient as its optimiser took it: exp_avg /
    (1 - beta1) after one step, as norms (0 where it took none)."""
    import torch
    keys, vals = [], []
    for net, (module, opt) in trained.items():
        for k, p in module.named_parameters():
            keys.append(f"{net}.{k}")
            m = opt.state[p].get("exp_avg", torch.zeros_like(p))
            vals.append(torch.linalg.vector_norm(m.double()) / (1.0 - beta1))
    return dict(zip(keys, torch.stack(vals).cpu().tolist()))


def _deltas(trained: Dict, weights) -> Dict[str, float]:
    """Each leaf's change from the initial weights, as norms."""
    import torch
    keys, vals = [], []
    for net, (module, _) in trained.items():
        for k, p in module.named_parameters():
            keys.append(f"{net}.{k}")
            vals.append(torch.linalg.vector_norm(
                (p.detach() - weights[net][k]).double()))
    return dict(zip(keys, torch.stack(vals).cpu().tolist()))


@dataclass
class TrainSetup:
    family: object
    cfg: object
    dev: object
    weights: Dict
    pool: Dict
    state: object
    step: Callable
    feed: object
    stop: threading.Event
    readings: Dict
    shapes: Dict


def train_setup(cell: Cell, cfg, seed: int, dev) -> TrainSetup:
    """The step object from the seed, driven through its first steps by the
    window's own call and feed; the readings the reference is held to."""
    from deepinpainting_torch.data.iterator import device_batches
    fam = family_of(cell)
    t = cell.traffic
    clock = _Phases()
    nets = fam.networks(cfg, train=True)
    shapes = W.shapes_of(nets)
    weights = W.draw(shapes, seed, dev, fam.leaf_std(cfg))
    _load(nets, weights, dev)
    state = fam.train_state(cfg, nets)
    step = fam.train_step(cfg, dev)
    clock.mark("weights", dev)
    n = t["pool_batches"] * cfg.batch_size
    pool = images.pool(seed, n, cfg.fine_size, dev)
    stop = threading.Event()
    feed = device_batches(_batches(pool, fam.inputs, cfg.batch_size, stop),
                          dev)
    clock.mark("inputs", dev)
    losses, grad1 = [], None
    for k in range(WARM_STEPS):
        state, m = step(state, next(feed))
        losses.append({name: float(v) for name, v in m.items()})
        if k == 0:
            grad1 = _adam_first_grads(fam.trained(state), cfg.beta1)
        clock.mark(f"step {k + 1}", dev)
    readings = {"losses": losses, "grad1": grad1,
                "delta3": _deltas(fam.trained(state), weights)}
    clock.log()
    return TrainSetup(fam, cfg, dev, weights, pool, state, step, feed, stop,
                      readings, shapes)


def close_feed(s: TrainSetup) -> None:
    """Stop the feed and drain it, so that its thread ends."""
    s.stop.set()
    for _ in s.feed:
        pass


def train_window(s: TrainSetup, seconds: float, traced: bool) -> Window:
    """Steps until `seconds` have passed; images over all of the time,
    ending in a synchronise."""
    from torch.profiler import record_function
    cfg, dev = s.cfg, s.dev
    before = _launches(s.family)
    waits: List[float] = []
    steps = failed = 0
    b = cfg.batch_size
    cap = T.capture(lambda: _sync(dev)) if traced \
        else contextlib.nullcontext()
    _sync(dev)
    with cap as got:
        t0 = time.perf_counter()
        while True:
            with record_function("portbench.data.wait"):
                a = time.perf_counter()
                batch = next(s.feed)
                waits.append(time.perf_counter() - a)
            with record_function("portbench.step"):
                s.state, m = s.step(s.state, batch)
            steps += 1
            if steps % cfg.metrics_every == 0:
                with record_function("portbench.metrics_fetch"):
                    if not all(math.isfinite(float(v)) for v in m.values()):
                        failed += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)
        t1 = time.perf_counter()
    after = _launches(s.family)
    n_batches = len(s.pool["image"]) // b
    return Window("train", t1 - t0, steps=steps, images=steps * b,
                  attempted=steps, failed=failed, spans={"data.wait": waits},
                  counters={k: after[k] - before[k] for k in after},
                  trace=got.trace if traced else None,
                  rows=[_rows(b, (WARM_STEPS + k) % n_batches)
                        for k in range(steps)])


def train_reference(s: TrainSetup, prec=None, half: bool = False) -> Dict:
    """The reference's readings over the same first steps from the same
    weights and batches (with `half`, the first half of each batch only:
    a fault for the check's calibration)."""
    b = s.cfg.batch_size
    rows = b // 2 if half else b
    batches = [s.family.inputs(s.pool, slice(k * b, k * b + rows))
               for k in range(WARM_STEPS)]
    out = s.family.train_reference(s.cfg, s.weights, batches, s.dev, prec)
    _free()
    return out


def _log(msg: str) -> None:
    import sys
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class _Phases:
    """Seconds of each phase of a set-up, for the run's log."""

    def __init__(self):
        self.t = time.perf_counter()
        self.marks = []

    def mark(self, name: str, dev) -> None:
        _sync(dev)
        now = time.perf_counter()
        self.marks.append(f"{name} {now - self.t:.3f}")
        self.t = now

    def log(self) -> None:
        _log("set-up s: " + ", ".join(self.marks))


def _free() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_train(cell: Cell, cfg, seed: int, seconds: float, traced: bool, dev,
              started: float) -> Dict:
    import torch
    s = train_setup(cell, cfg, seed, dev)
    _sync(dev)
    setup_s = time.time() - started
    window = train_window(s, seconds, traced)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    close_feed(s)
    fam = s.family
    window.flops = fam.flops("train", s.shapes, cfg)
    window.bounds = fam.bounds(window, cfg, s.pool, dev)
    program = s.readings
    s.state = s.step = s.feed = None
    _free()
    reference = train_reference(s)
    numbers = fam.train_numbers(program, reference, cfg)
    _log(fam.train_note(program, reference))
    if dev.type == "cuda":
        numbers["kernels.missing"] = fam.missing(window)
    return {"setup_s": setup_s, "window": window, "numbers": numbers,
            "memory_peak_bytes": int(peak)}


# ---- serve ------------------------------------------------------------------

@dataclass
class ServeSetup:
    family: object
    cfg: object
    dev: object
    weights: Dict
    pool: Dict
    session: object
    keep: np.ndarray
    shapes: Dict


def serve_setup(cell: Cell, cfg, seed: int, dev) -> ServeSetup:
    """The session over seeded weights, every batch size the coalescer can
    form warmed, and the seeded sample of pool entries whose answers are
    checked."""
    fam = family_of(cell)
    t = cell.traffic
    clock = _Phases()
    nets = fam.networks(cfg, train=False)
    shapes = W.shapes_of(nets)
    weights = W.draw(shapes, seed, dev, fam.leaf_std(cfg))
    _load(nets, weights, dev)
    session = fam.session(cfg, nets, t, dev)
    clock.mark("weights", dev)
    pool = images.pool(seed, t["pool"], cfg.fine_size, dev)
    clock.mark("inputs", dev)
    for b in range(1, t["max_batch"] + 1):
        session.run(**fam.inputs(pool, slice(0, b)))
        clock.mark(f"B={b}", dev)
    clock.log()
    keep = np.random.default_rng(seed).choice(t["pool"], size=t["sample"],
                                              replace=False)
    return ServeSetup(fam, cfg, dev, weights, pool, session, np.sort(keep),
                      shapes)


def serve_window(s: ServeSetup, traffic: Dict, seed: int, seconds: float,
                 traced: bool):
    """The cell's load for `seconds`; returns (Window, {pool index: [the
    uint8 answers it got]}, lateness of the generator in s)."""
    pool, session, inputs = s.pool, s.session, s.family.inputs
    keep = set(int(i) for i in s.keep)
    n_pool = len(pool["image"])

    def call(i):
        return session.run(**inputs(pool, slice(i, i + 1)))[0]

    batcher = session._batcher
    before = {"batches_run": batcher.batches_run,
              "items_served": batcher.items_served, **_launches(s.family)}
    cap = T.capture(lambda: _sync(s.dev)) if traced \
        else contextlib.nullcontext()
    with cap as got:
        if traffic["kind"] == "closed":
            rec = drivers.closed_loop(call, traffic["clients"], seconds,
                                      keep, n_pool)
        else:
            rec = drivers.open_loop(call, traffic["rate"], seconds,
                                    seed, traffic["senders"], keep, n_pool)
    after = {"batches_run": batcher.batches_run,
             "items_served": batcher.items_served, **_launches(s.family)}
    done = [r for r in rec.requests if r.ok]
    w = Window("serve", rec.seconds, images=len(done),
               latencies=[r.done - r.due for r in rec.requests],
               attempted=len(rec.requests),
               failed=len(rec.requests) - len(done),
               counters={k: after[k] - before[k] for k in after},
               trace=got.trace if traced else None,
               rows=[r.index % n_pool for r in done])
    return w, rec.answers, rec.lateness


def serve_reference(s: ServeSetup, answers: Dict, prec=None) -> Dict:
    """The reference's answer to each checked pool entry, uint8 on the
    host, in batches of 8."""
    idx = sorted(answers)
    out = {}
    for lo in range(0, len(idx), 8):
        part = np.array(idx[lo:lo + 8])
        u8 = s.family.serve_reference(s.cfg, s.weights,
                                      s.family.inputs(s.pool, part), s.dev,
                                      prec).cpu().numpy()
        out.update(zip(part.tolist(), u8))
    return out


def run_serve(cell: Cell, cfg, seed: int, seconds: float, traced: bool, dev,
              started: float) -> Dict:
    import torch
    s = serve_setup(cell, cfg, seed, dev)
    _sync(dev)
    setup_s = time.time() - started
    window, answers, lateness = serve_window(s, cell.traffic, seed, seconds,
                                             traced)
    if lateness:
        _log(f"open-loop generator late by p50 "
             f"{np.percentile(lateness, 50) * 1e3:.3f} ms, p99 "
             f"{np.percentile(lateness, 99) * 1e3:.3f} ms, max "
             f"{max(lateness) * 1e3:.3f} ms")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    s.session.close()
    s.session = None
    fam = s.family
    window.flops = fam.flops("serve", s.shapes, cfg)
    window.bounds = fam.bounds(window, cfg, s.pool, dev)
    _free()
    reference = serve_reference(s, answers)
    numbers = fam.serve_numbers(answers, reference)
    _log(fam.serve_note(answers))
    if dev.type == "cuda":
        numbers["kernels.missing"] = fam.missing(window)
    return {"setup_s": setup_s, "window": window, "numbers": numbers,
            "memory_peak_bytes": int(peak)}


# ---- one run ----------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", started: Optional[float] = None,
             cfg_override: Optional[Dict] = None) -> Dict:
    """One run: the result object that run.py prints as its last line.
    `cfg_override` shrinks the configuration for tests."""
    import torch
    from deepinpainting_torch.device import resolve_device
    started = time.time() if started is None else started
    dev = resolve_device(device)            # on a card: TF32 off
    cfg = program_config(cell, **(cfg_override or {}))
    kind = cell.traffic["kind"]
    trace_s = min(seconds, cell.traffic.get("trace_seconds", seconds)) \
        if traced else seconds
    run = run_train if kind == "train" else run_serve
    out = run(cell, cfg, seed, trace_s, traced, dev, started)
    window: Window = out["window"]
    metrics = {}
    wanted = cell.per_layer if traced else cell.end_to_end
    for name, unit in wanted:
        if name == "setup_s":
            value = out["setup_s"]
        else:
            value = load_reader("metrics" if traced else "end_to_end",
                                name, cell.home)(window)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    numbers = out["numbers"]
    _log("numbers not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in numbers.items() if k not in cell.limits))
    checks = {k: {"value": numbers[k], "limit": limit}
              for k, limit in cell.limits.items() if k in numbers}
    correct = window.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": device_info}
    if traced and window.trace is not None:
        device_info["busy_s"] = window.trace.busy_s
        device_info["window_s"] = window.trace.window_s
        result["breakdown"] = window.trace.breakdown()
    result["checks"] = checks
    return result
