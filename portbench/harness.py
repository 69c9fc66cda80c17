"""One run of one cell: set-up, the measured (or traced) window, and the
check of what the timed path produced against the plain reference.

A cell is found by name in BENCHMARK.json; its configuration, traffic mix
and limits are files of their own (configs/, traffic/, workloads/), and
each metric is a reader of its own (end_to_end/, metrics/) that takes the
Window below and returns a number, or None where it finds nothing to read.

The program under test is `deepinpainting_torch`; the benchmark takes from
it only the entry points it times and their counters.  Kinds of traffic:

  train   make_train_step's step fed by data/iterator.py::device_batches
          from a pool of seeded uint8 batches; the first steps are the
          warm-up and the steps the reference follows
  closed  InferenceSession.run from client threads, each sending its next
          request when its last one is answered
  open    InferenceSession.run on a seeded Poisson schedule, each request
          timed from when it was due
"""

from __future__ import annotations

import contextlib
import dataclasses
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

from . import compare, counts, drivers, images
from . import trace as T
from . import weights as W

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WARM_STEPS = 3               # train: the steps the reference follows
FORBIDDEN = ("jax", "jaxlib", "flax", "deepinpainting_tpu")


@dataclass
class Cell:
    name: str
    config: Dict                    # the configuration file's fields
    traffic: Dict                   # the traffic file's parameters
    chips: int
    limits: Dict[str, float]
    end_to_end: List[tuple]
    per_layer: List[tuple]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell `name` of BENCHMARK.json with its files."""
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    own = json.loads((HERE / "workloads" / f"{name}.json").read_text())

    def listed(metrics):
        return [(m["name"], m["unit"]) for m in metrics
                if name in m.get("workloads", [name])]

    return Cell(name, config, traffic, w["chips"], own["limits"],
                listed(bench["end_to_end"]), listed(bench["per_layer"]))


def program_config(cell: Cell, **override):
    """The program's Config of the cell (fields of the config file)."""
    from deepinpainting_torch.config import Config
    names = {f.name for f in dataclasses.fields(Config)}
    fields = {k: v for k, v in cell.config.items() if k in names}
    fields.update(override)
    return Config(**fields)


def load_reader(kind: str, name: str) -> Callable:
    """The `read` function of <kind>/<name>.py."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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
    scan_bound_s: float = 0.0
    kbar_bound_s: float = 0.0


# ---- the program's networks and weights -------------------------------------

def _program_nets(cfg, train: bool) -> Dict:
    """The program's networks built on the meta device (no host init)."""
    import torch
    from deepinpainting_torch.engine import inpaint as TI
    with torch.device("meta"):
        models = TI.build_models(cfg)
        nets = {"G": models.G, "P": models.P, "vgg": models.vgg}
        if train:
            disc = TI.build_discriminators(cfg)
            nets.update(D=disc.D, F=disc.F)
    return nets


def _load(nets: Dict, weights: Dict, dev) -> None:
    for name, net in nets.items():
        net.to_empty(device=dev)
        net.load_state_dict(weights[name], strict=True)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> Dict[str, int]:
    from deepinpainting_torch.ops import attention_cuda as TAC
    return {"scan": TAC.launches, "kbar": TAC.kbar_launches}


def _masked_counts(masks: np.ndarray, cfg, dev) -> np.ndarray:
    """Masked attention positions of each hole in the pool."""
    import torch
    from .reference.step import feature_flags
    out = []
    for lo in range(0, len(masks), 64):
        m = (torch.as_tensor(masks[lo:lo + 64], device=dev) > 0).float()
        _, flag = feature_flags(m, cfg.threshold, cfg.mask_thred)
        out.append(flag.sum(1).cpu().numpy())
    return np.concatenate(out).astype(np.int64)


# ---- train ------------------------------------------------------------------

def _batches(pool, refs, batch: int, stop: threading.Event):
    """Pool batch i % n as {'image', 'mask', 'ref'} until stopped."""
    n = len(pool["image"]) // batch
    i = 0
    while not stop.is_set():
        sl = slice((i % n) * batch, (i % n + 1) * batch)
        yield {"image": pool["image"][sl], "mask": pool["mask"][sl],
               "ref": pool["image"][refs[sl]]}
        i += 1


def _adam_first_grads(state, beta1: float) -> Dict[str, float]:
    """Each leaf's first gradient as its optimiser took it: exp_avg /
    (1 - beta1) after one step, as norms (0 where it took none)."""
    import torch
    keys, vals = [], []
    for net in ("G", "P", "D", "F"):
        opt = getattr(state, f"opt_{net}")
        for k, p in getattr(state, net).named_parameters():
            keys.append(f"{net}.{k}")
            m = opt.state[p].get("exp_avg", torch.zeros_like(p))
            vals.append(torch.linalg.vector_norm(m.double()) / (1.0 - beta1))
    return dict(zip(keys, torch.stack(vals).cpu().tolist()))


def _deltas(state, weights) -> Dict[str, float]:
    """Each leaf's change from the initial weights, as norms."""
    import torch
    keys, vals = [], []
    for net in ("G", "P", "D", "F"):
        for k, p in getattr(state, net).named_parameters():
            keys.append(f"{net}.{k}")
            vals.append(torch.linalg.vector_norm(
                (p.detach() - weights[net][k]).double()))
    return dict(zip(keys, torch.stack(vals).cpu().tolist()))


@dataclass
class TrainSetup:
    cfg: object
    dev: object
    weights: Dict
    pool: Dict
    refs: np.ndarray
    state: object
    step: Callable
    feed: object
    stop: threading.Event
    readings: Dict
    masked: np.ndarray          # masked attention positions a pool batch
    shapes: Dict


def train_setup(cell: Cell, cfg, seed: int, dev) -> TrainSetup:
    """The step object from the seed, driven through its first steps by the
    window's own call and feed; the readings the reference is held to."""
    from deepinpainting_torch.data.iterator import device_batches
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.engine.state import create_train_state
    t = cell.traffic
    clock = _Phases()
    nets = _program_nets(cfg, train=True)
    shapes = W.shapes_of(nets)
    weights = W.draw(shapes, seed, dev, cfg.init_gain, cfg.init_type)
    _load(nets, weights, dev)
    state = create_train_state(cfg, nets["G"], nets["P"], nets["D"],
                               nets["F"], nets["vgg"].eval())
    step = TI.make_train_step(cfg, dev)
    clock.mark("weights", dev)
    n = t["pool_batches"] * cfg.batch_size
    pool = images.pool(seed, n, cfg.fine_size, dev)
    refs = images.ref_index(n)
    stop = threading.Event()
    feed = device_batches(_batches(pool, refs, cfg.batch_size, stop), dev)
    clock.mark("inputs", dev)
    losses, grad1 = [], None
    for k in range(WARM_STEPS):
        state, m = step(state, next(feed))
        losses.append({name: float(v) for name, v in m.items()})
        if k == 0:
            grad1 = _adam_first_grads(state, cfg.beta1)
        clock.mark(f"step {k + 1}", dev)
    readings = {"losses": losses, "grad1": grad1,
                "delta3": _deltas(state, weights)}
    clock.log()
    masked = _masked_counts(pool["mask"], cfg, dev).reshape(
        -1, cfg.batch_size).sum(1)
    return TrainSetup(cfg, dev, weights, pool, refs, state, step, feed, stop,
                      readings, masked, shapes)


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
    before = _launches()
    waits: List[float] = []
    steps = failed = 0
    scan_s = 0.0                # the scan's least time, one launch a step
    b = cfg.batch_size
    n = (cfg.fine_size // 8) ** 2
    c = cfg.ngf * 8
    batches = len(s.masked)
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
            i = (WARM_STEPS + steps) % batches
            scan_s += counts.scan_seconds(b * n, int(s.masked[i]), c)
            steps += 1
            if steps % cfg.metrics_every == 0:
                with record_function("portbench.metrics_fetch"):
                    if not all(math.isfinite(float(v)) for v in m.values()):
                        failed += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)
        t1 = time.perf_counter()
    after = _launches()
    launched = {k: after[k] - before[k] for k in after}
    per_step = {k: v / steps for k, v in launched.items()}
    w = Window("train", t1 - t0, steps=steps, images=steps * b,
               attempted=steps, failed=failed, spans={"data.wait": waits},
               counters={"scan_launches": launched["scan"],
                         "kbar_launches": launched["kbar"]},
               trace=got.trace if traced else None)
    # every launch of a step (the recompute's too) reads that step's batch
    w.scan_bound_s = per_step["scan"] * scan_s
    w.kbar_bound_s = launched["kbar"] * counts.kbar_seconds(b, n)
    return w


def train_reference(s: TrainSetup, prec=None, half: bool = False) -> Dict:
    """The reference's readings over the same first steps from the same
    weights and batches (with `half`, the first half of each batch only:
    a fault for the check's calibration)."""
    from .reference import step as R
    cfg = s.cfg
    prec = prec or R.Precision(_torch_dtype(cfg.dtype))
    ref = R.TrainReference(s.weights, R.config_dict(cfg), prec, s.dev)
    losses = []
    rows = cfg.batch_size // 2 if half else cfg.batch_size
    for k in range(WARM_STEPS):
        sl = slice(k * cfg.batch_size, k * cfg.batch_size + rows)
        losses.append(ref.step({"image": s.pool["image"][sl],
                                "mask": s.pool["mask"][sl],
                                "ref": s.pool["image"][s.refs[sl]]}))
    grad1 = R.leaf_norms(ref.first_grads)
    deltas = R.leaf_norms({net: {k: ref.w[net][k] - s.weights[net][k]
                                 for k in ref.w[net]}
                           for net in R.TRAINED})
    del ref
    _free()
    return {"losses": losses, "grad1": grad1, "delta3": deltas}


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


def _torch_dtype(name: str):
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _free() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_train(cell: Cell, cfg, seed: int, seconds: float, traced: bool, dev,
              started: float) -> Dict:
    import torch
    from .reference import step as R
    s = train_setup(cell, cfg, seed, dev)
    _sync(dev)
    setup_s = time.time() - started
    window = train_window(s, seconds, traced)
    window.flops = counts.train_flops(s.shapes, cfg.fine_size, cfg.dtype)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    close_feed(s)
    program = s.readings
    s.state = s.step = s.feed = None
    _free()
    reference = train_reference(s)
    numbers = compare.train_numbers(program, reference, cfg.gan_weight)
    _log(f"worst leaves {compare.train_worst_leaves(program, reference)}")
    if dev.type == "cuda":
        numbers["kernels.missing"] = float(
            max(0, window.steps - window.counters["scan_launches"])
            + max(0, window.steps - window.counters["kbar_launches"]))
    return {"setup_s": setup_s, "window": window, "numbers": numbers,
            "memory_peak_bytes": int(peak)}


# ---- serve ------------------------------------------------------------------

@dataclass
class ServeSetup:
    cfg: object
    dev: object
    weights: Dict
    pool: Dict
    refs: np.ndarray
    session: object
    keep: np.ndarray
    shapes: Dict


def serve_setup(cell: Cell, cfg, seed: int, dev) -> ServeSetup:
    """The session over seeded weights, every batch size the coalescer can
    form warmed, and the seeded sample of pool entries whose answers are
    checked."""
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.serve.app import InferenceSession
    t = cell.traffic
    clock = _Phases()
    nets = _program_nets(cfg, train=False)
    shapes = W.shapes_of(nets)
    weights = W.draw(shapes, seed, dev, cfg.init_gain, cfg.init_type)
    _load(nets, weights, dev)
    models = TI.Models(nets["G"].eval(), nets["P"].eval(), nets["vgg"].eval())
    session = InferenceSession(cfg, state=models, max_batch=t["max_batch"],
                               batch_wait_ms=t["batch_wait_ms"], device=dev)
    clock.mark("weights", dev)
    pool = images.pool(seed, t["pool"], cfg.fine_size, dev)
    refs = images.ref_index(t["pool"])
    clock.mark("inputs", dev)
    for b in range(1, t["max_batch"] + 1):
        session.run(pool["image"][:b], pool["mask"][:b],
                    pool["image"][refs[:b]])
        clock.mark(f"B={b}", dev)
    clock.log()
    keep = np.random.default_rng(seed).choice(t["pool"], size=t["sample"],
                                              replace=False)
    return ServeSetup(cfg, dev, weights, pool, refs, session, np.sort(keep),
                      shapes)


def serve_window(s: ServeSetup, traffic: Dict, seed: int, seconds: float,
                 traced: bool):
    """The cell's load for `seconds`; returns (Window, {pool index: [the
    uint8 answers it got]}, lateness of the generator in s)."""
    pool, refs, session = s.pool, s.refs, s.session
    keep = set(int(i) for i in s.keep)
    n_pool = len(pool["image"])

    def call(i):
        return session.run(pool["image"][i:i + 1], pool["mask"][i:i + 1],
                           pool["image"][refs[i]][None])[0]

    batcher = session._batcher
    before = {"batches_run": batcher.batches_run,
              "items_served": batcher.items_served, **_launches()}
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
             "items_served": batcher.items_served, **_launches()}
    d = {k: after[k] - before[k] for k in after}
    masked = _masked_counts(pool["mask"], s.cfg, s.dev)
    n = (s.cfg.fine_size // 8) ** 2
    c = s.cfg.ngf * 8
    done = [r for r in rec.requests if r.ok]
    w = Window("serve", rec.seconds, images=len(done),
               latencies=[r.done - r.due for r in rec.requests],
               attempted=len(rec.requests),
               failed=len(rec.requests) - len(done),
               counters={"batches_run": d["batches_run"],
                         "items_served": d["items_served"],
                         "scan_launches": d["scan"],
                         "kbar_launches": d["kbar"]},
               trace=got.trace if traced else None)
    w.scan_bound_s = sum(counts.scan_seconds(n, int(masked[r.index % n_pool]),
                                             c) for r in done)
    return w, rec.answers, rec.lateness


def serve_reference(s: ServeSetup, answers: Dict, prec=None) -> Dict:
    """The reference's answer to each checked pool entry, uint8 on the
    host, in batches of 8."""
    from .reference import step as R
    cfg = s.cfg
    prec = prec or R.Precision(_torch_dtype(cfg.dtype))
    idx = sorted(answers)
    out = {}
    for lo in range(0, len(idx), 8):
        part = np.array(idx[lo:lo + 8])
        u8 = R.serve(s.weights, s.pool["image"][part], s.pool["mask"][part],
                     s.pool["image"][s.refs[part]], R.config_dict(cfg), prec,
                     s.dev).cpu().numpy()
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
    window.flops = counts.serve_flops(s.shapes, cfg.fine_size, cfg.dtype)
    if lateness:
        _log(f"open-loop generator late by p50 "
             f"{np.percentile(lateness, 50) * 1e3:.3f} ms, p99 "
             f"{np.percentile(lateness, 99) * 1e3:.3f} ms, max "
             f"{max(lateness) * 1e3:.3f} ms")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    s.session.close()
    s.session = None
    _free()
    reference = serve_reference(s, answers)
    numbers = compare.serve_numbers(answers, reference)
    _log(f"{sum(len(v) for v in answers.values())} answers to "
         f"{len(answers)} pool entries checked; the program's own answers to "
         f"one request differ by up to {compare.serve_self_spread(answers)!r}"
         " levels")
    if dev.type == "cuda":
        numbers["kernels.missing"] = float(max(
            0, window.counters["batches_run"]
            - window.counters["scan_launches"]))
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
                                name)(window)
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
