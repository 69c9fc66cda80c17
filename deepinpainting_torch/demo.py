"""The quality protocols of the port: the JAX package's recorded training
runs (artifacts/*, the JAX repository's round5_runs.sh) through the
port's own entry points, on the card, each held to JAX's records.

    python -m deepinpainting_torch.demo --out build/demo          # f32
    python -m deepinpainting_torch.demo --out build/demo --protocol bf16 \
        --protocol bn
    python -m deepinpainting_torch.demo --out build/demo --protocol all

A protocol (PROTOCOLS) is one recorded run of the JAX package:
  1. data: data/synth.py in this process (the JAX repository's
     make_synth_data.py, byte for byte, so the data are those of the JAX
     runs), under --out/data, shared by the protocols that ask for the
     same generator arguments;
  2. training: `_cli train` in this process with COMMON (round5_runs.sh's
     COMMON: 128 px, batch 8, 10 + 10 epochs, a checkpoint every 5, the
     NaN guard), the protocol's overrides, refs = images, the validation
     images, and --seed; a protocol in pieces resumes with
     --continue_train --which_epoch, as JAX's 256 px run did;
  3. evaluations: `_cli evaluate` of the recorded epochs on the held-out
     images (PSNR and SSIM, utils/metrics.py), some with an eval-time
     override (--quant int8, --faithful_known_replacement); each one's
     per-image lines go to a log of JAX's format under --out/logs;
  4. the f32 protocol also measures int8's fake_B against f32 on its last
     checkpoint and serves that checkpoint: make_app on ThreadingWSGIServer
     at an ephemeral 127.0.0.1 port, one multipart POST, the result back;
  5. every checkpoint epoch that no later evaluation or resume reads is
     deleted (a checkpoint is 1.8 GB).

The band rule (the JAX records beside each protocol, with the file and
line that hold them; tests/test_torch_protocols.py reads them back):
  * PSNR: the range of JAX's records of that evaluation, +- 0.14 dB (JAX's
    run-to-run spread: 28.04 and 28.11 dB on one protocol);
  * SSIM: from the lowest record - 0.005 up to the highest record + 0.012
    + 0.005.  The 0.012 is the offset between TPU and CPU evaluations of
    one JAX checkpoint (artifacts/train_demo/eval_epoch20.log:36 0.803,
    BENCH_NOTES.md:358 0.815); the port evaluates in full f32, as the CPU
    run did.  No band is widened in any other way;
  * int8 and the known-replacement A/B are differences against the f32 /
    faithful evaluation of the same port checkpoint, not absolute: int8
    dPSNR >= JAX's dPSNR - 0.14 and dSSIM >= JAX's dSSIM - 0.005 (at 128
    px -0.14 dB and -0.007); known replacement |dPSNR - JAX's| <= 0.14
    (JAX's is 0.00).  The per-image largest |dPSNR| is reported beside
    JAX's 0.072 dB, not judged.
A figure outside its band on the first seed reruns the protocol at the
next seed; a figure outside its band on both makes main() exit 1, naming
the protocol, the figure, both seeds' values and the band.

The last line of the output is one JSON object: each protocol's figures
at each seed run, its bands, and the misses.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

SPREAD_PSNR = 0.14        # JAX's run-to-run spread (dB)
SPREAD_SSIM = 0.005
TPU_SSIM_OFFSET = 0.012   # CPU minus TPU SSIM of one JAX checkpoint

# round5_runs.sh's COMMON, less the data directories
COMMON = ("--fine_size", "128", "--batch_size", "8", "--niter", "10",
          "--niter_decay", "10", "--save_epoch_freq", "5",
          "--display_freq", "400", "--debug_nan", "true")
# the generator arguments (data/synth.py) of each recorded dataset
DATA = {"synth": ("--n", "300", "--n_valid", "32", "--size", "256"),
        "synth512": ("--n", "300", "--n_valid", "32", "--size", "512"),
        "synth256": ("--n", "2000", "--n_valid", "64", "--n_masks", "128",
                     "--size", "256", "--seed", "7")}


@dataclass(frozen=True)
class Record:
    """One JAX evaluation: PSNR and SSIM averages, and the file:line of
    the repository that holds both numbers."""
    psnr: float
    ssim: float
    source: str


@dataclass(frozen=True)
class Evaluation:
    """One evaluation of a protocol's checkpoint.  kind 'abs' is held to
    the band of `records`; 'int8' and 'kr' are differences against the
    evaluation `base` of the same checkpoint, held to JAX's difference
    between `records` = (JAX's base, JAX's this)."""
    name: str
    epoch: int
    records: tuple
    flags: tuple = ()
    kind: str = "abs"
    base: str = ""


@dataclass(frozen=True)
class Protocol:
    name: str
    overrides: tuple
    evaluations: tuple
    data: str = "synth"
    max_images: int = 32
    pieces: tuple = ((),)     # the extra train flags of each run in turn
    serve: bool = False       # the f32 demo's POST and int8 fake_B gap


def _log(name: str, line: int = 36) -> str:
    return f"artifacts/{name}:{line}"


_TRUNC_OFF = ("--faithful_backward_truncation", "false")
_COSIS_OFF = ("--faithful_detached_cosis", "false")
_KR_OFF = ("--faithful_known_replacement", "false")

PROTOCOLS = {p.name: p for p in (
    Protocol("f32", (), (
        Evaluation("e5", 5, (
            Record(25.11, 0.735, _log("train_demo/eval_epoch05.log")),
            Record(24.67, 0.727, _log("kr_ablation/eval_faithful_e05.log")))),
        Evaluation("e20", 20, (
            Record(28.04, 0.803, _log("train_demo/eval_epoch20.log")),
            Record(28.11, 0.802,
                   _log("kr_ablation/eval_faithful_e20_kr_true.log")),
            Record(28.04, 0.815, "BENCH_NOTES.md:358"))),
        Evaluation("e20_kr", 20, (
            Record(28.11, 0.802,
                   _log("kr_ablation/eval_faithful_e20_kr_true.log")),
            Record(28.11, 0.802,
                   _log("kr_ablation/eval_faithful_e20_kr_false.log"))),
            flags=_KR_OFF, kind="kr", base="e20"),
        Evaluation("e20_int8", 20, (
            Record(28.04, 0.815, "BENCH_NOTES.md:358"),
            Record(28.04, 0.813, "BENCH_NOTES.md:359")),
            flags=("--quant", "int8"), kind="int8", base="e20")),
        serve=True),
    Protocol("bf16", ("--dtype", "bfloat16"), (
        Evaluation("e5", 5, (
            Record(24.59, 0.748, _log("train_demo_bf16/eval_bf16_e05.log")),)),
        Evaluation("e20", 20, (
            Record(28.13, 0.807,
                   _log("train_demo_bf16/eval_bf16_e20.log")),)))),
    Protocol("bn", ("--norm", "batch"), (
        Evaluation("e5", 5, (
            Record(25.98, 0.718, _log("train_demo_bn/eval_bn_e05.log")),)),
        Evaluation("e20", 20, (
            Record(28.83, 0.807, _log("train_demo_bn/eval_bn_e20.log")),)))),
    Protocol("trunc", _TRUNC_OFF, (
        Evaluation("e5", 5, (Record(24.88, 0.736, _log(
            "train_demo_corrected/eval_trunc_e05.log")),)),
        Evaluation("e20", 20, (Record(28.05, 0.802, _log(
            "train_demo_corrected/eval_trunc_e20.log")),)))),
    Protocol("cosis", _COSIS_OFF, (
        Evaluation("e5", 5, (Record(23.18, 0.597, _log(
            "train_demo_corrected/eval_cosis_e05.log")),)),
        Evaluation("e20", 20, (Record(26.39, 0.750, _log(
            "train_demo_corrected/eval_cosis_e20.log")),)))),
    Protocol("corrected", _TRUNC_OFF + _COSIS_OFF, (
        Evaluation("e5", 5, (Record(21.04, 0.505, _log(
            "train_demo_corrected/eval_corrected_e05.log")),)),
        Evaluation("e20", 20, (Record(24.71, 0.706, _log(
            "train_demo_corrected/eval_corrected_e20.log")),)))),
    Protocol("kr", _KR_OFF, (
        Evaluation("e5", 5, (Record(25.38, 0.741, _log(
            "kr_ablation/eval_kr_corrected_e05.log")),)),
        Evaluation("e20", 20, (Record(28.18, 0.805, _log(
            "kr_ablation/eval_kr_corrected_e20.log")),)),
        Evaluation("e20_faithful", 20, (Record(27.74, 0.793, _log(
            "kr_ablation/eval_kr_corrected_e20_kr_true.log")),),
            flags=("--faithful_known_replacement", "true")))),
    Protocol("512", ("--fine_size", "512", "--dtype", "bfloat16",
                     "--remat", "true", "--remat_depth", "1"), (
        Evaluation("e5", 5, (
            Record(25.97, 0.997, _log("train512/eval512_e05.log")),)),
        Evaluation("e20", 20, (
            Record(28.01, 0.991, _log("train512/eval512_e20.log")),))),
        data="synth512"),
    # JAX's run stopped at epoch 30, resumed to 40 and resumed to 60
    # (artifacts/train256/README.md: two resumes); each piece stops on the
    # 60-epoch schedule, and the resumed run starts at the rate its
    # checkpoint holds, as JAX's did
    Protocol("256", ("--fine_size", "256", "--niter", "30",
                     "--niter_decay", "30", "--save_epoch_freq", "10"), (
        Evaluation("e30", 30, (
            Record(29.52, 0.871, _log("train256/eval_epoch30.log", 68)),)),
        Evaluation("e40", 40, (
            Record(28.85, 0.888, _log("train256/eval_epoch40.log", 68)),)),
        Evaluation("e60", 60, (
            Record(25.68, 0.911, _log("train256/eval_epoch60.log", 68)),)),
        Evaluation("e60_int8", 60, (
            Record(25.68, 0.912, "BENCH_NOTES.md:360"),
            Record(25.62, 0.894, "BENCH_NOTES.md:361")),
            flags=("--quant", "int8"), kind="int8", base="e60")),
        data="synth256", max_images=64,
        pieces=(("--stop_epoch", "30"),
                ("--continue_train", "true", "--which_epoch", "30",
                 "--stop_epoch", "40"),
                ("--continue_train", "true", "--which_epoch", "40"))),
)}
ORDER = tuple(PROTOCOLS)          # `all`: 256 px last, the longest


@dataclass(frozen=True)
class Cut:
    """A cut depth of the same runner (chip_smoke.py phase 14, the CPU
    tests): `data` replaces the protocol's generator arguments, `train`
    follows its overrides (fewer epochs, and on the CPU a tiny width),
    one piece runs, and the evaluations of the protocol's last recorded
    epoch run at the piece's last epoch if `evaluate`.  Nothing at a cut
    depth is judged."""
    data: tuple
    train: tuple
    evaluate: bool = True


# ---- the band rule ---------------------------------------------------------

def bands(proto: Protocol) -> dict:
    """{figure: (low, high)} by the band rule (module docstring); high is
    None where the rule sets no upper end."""
    out = {}
    for ev in proto.evaluations:
        if ev.kind == "abs":
            ps = [r.psnr for r in ev.records]
            ss = [r.ssim for r in ev.records]
            out[f"psnr_{ev.name}"] = (min(ps) - SPREAD_PSNR,
                                      max(ps) + SPREAD_PSNR)
            out[f"ssim_{ev.name}"] = (
                min(ss) - SPREAD_SSIM,
                max(ss) + TPU_SSIM_OFFSET + SPREAD_SSIM)
            continue
        base, this = ev.records
        dp, ds = this.psnr - base.psnr, this.ssim - base.ssim
        if ev.kind == "int8":
            out[f"d_psnr_{ev.name}"] = (dp - SPREAD_PSNR, None)
            out[f"d_ssim_{ev.name}"] = (ds - SPREAD_SSIM, None)
        elif ev.kind == "kr":
            out[f"d_psnr_{ev.name}"] = (dp - SPREAD_PSNR, dp + SPREAD_PSNR)
        else:
            raise ValueError(f"evaluation kind {ev.kind!r}")
    return {k: (round(lo, 6), None if hi is None else round(hi, 6))
            for k, (lo, hi) in out.items()}


def judge(proto: Protocol, figures: dict) -> list:
    """The figures of one seed's run outside their bands (a figure that
    is missing counts as outside)."""
    return [k for k, (lo, hi) in bands(proto).items()
            if not lo <= figures.get(k, math.nan) <= (
                math.inf if hi is None else hi)]


def report(results: dict) -> int:
    """Print the misses and the JSON line of `results` ({protocol name:
    [figures of each seed run]}); 1 if a figure missed on every seed
    run, else 0."""
    misses = []
    for name, runs in results.items():
        proto = PROTOCOLS[name]
        band = bands(proto)
        missed = set.intersection(*(set(judge(proto, r)) for r in runs))
        if any(r.get("served_ok") is False for r in runs):
            missed.add("served")
        for k in sorted(missed):
            values = ", ".join(f"seed {r['seed']} {r.get(k)}" for r in runs)
            misses.append({"protocol": name, "figure": k,
                           "values": {r["seed"]: r.get(k) for r in runs},
                           "band": band.get(k)})
            print(f"[demo] MISS {name} {k}: {values}, band {band.get(k)}",
                  file=sys.stderr, flush=True)
    print(json.dumps({"protocols": {
        name: {"runs": runs, "bands": bands(PROTOCOLS[name]),
               "jax_records": {ev.name: [dataclasses.asdict(r)
                                         for r in ev.records]
                               for ev in PROTOCOLS[name].evaluations}}
        for name, runs in results.items()}, "misses": misses}))
    return 1 if misses else 0


# ---- the runner ------------------------------------------------------------

def _launches() -> dict:
    """The kernels' launch counters (ops/attention_cuda.py), which count
    on the card only."""
    from .ops import attention_cuda as TAC
    return {"scan_stream": TAC.launches, "kbar_build": TAC.kbar_launches}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def make_data(out: Path, args: tuple) -> tuple:
    """data/synth.py's dataset of the generator arguments `args` into
    out/data/<args>, once: a generator that finds the directory in place
    uses it, and one that loses a race to write it drops its own copy (the
    same seed draws the same data).  Returns (directory, seconds)."""
    from .data import synth

    final = out / "data" / "_".join(a.lstrip("-") for a in args)
    if (final / "valid").is_dir():
        return final, 0.0
    tmp = final.with_name(f"{final.name}.tmp{os.getpid()}")
    final.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    a = synth.parse_args(["--out", str(tmp), *args])
    synth.write(a.out, a.n, a.n_valid, a.n_masks, a.size, a.seed)
    try:
        os.rename(tmp, final)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        if not (final / "valid").is_dir():
            raise
    return final, time.perf_counter() - t0


def train_config(argv) -> "Config":
    """The Config that `_cli train argv` trains (every Config field is a
    flag of it, argparse's last occurrence winning)."""
    from . import _cli
    from .config import Config
    ap = argparse.ArgumentParser(add_help=False)
    _cli.add_config_flags(ap)
    args, _ = ap.parse_known_args(list(argv))
    return Config(**vars(args))


def last_epoch(argv) -> int:
    """The last epoch that `_cli train argv` trains."""
    cfg = train_config(argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--stop_epoch", type=int, default=0)
    stop = ap.parse_known_args(list(argv))[0].stop_epoch
    return min(cfg.niter + cfg.niter_decay, stop or math.inf)


def _prune(run_dir: Path, keep) -> None:
    """Delete every checkpoint epoch of the run but `keep`."""
    for f in run_dir.glob("epoch_*.pt"):
        if int(f.stem.split("_")[1]) not in keep:
            f.unlink()


def per_image(log_text: str) -> tuple:
    """(PSNR list, SSIM list) of the per-image lines of an evaluation's
    log (evaluator.py's 'N. PSNR : x, SSIM : y', JAX's format)."""
    pairs = re.findall(r"^\d+\. PSNR : (\S+), SSIM : (\S+)$", log_text,
                       re.MULTILINE)
    return [float(p) for p, _ in pairs], [float(q) for _, q in pairs]


def int8_fake_b_gap(cfg, epoch: int, valid: Path, masks: Path,
                    max_images: int, device: str) -> dict:
    """Mean |fake_B int8 - fake_B f32| (NHWC in [-1, 1]) of the eval step
    over the first `max_images` held-out images of the run's checkpoint
    `epoch`, both modes on the same batches."""
    import numpy as np
    import torch

    from .data.dataset import SelfRefDataset
    from .data.iterator import BatchIterator, device_batches
    from .engine.checkpoint import CheckpointManager
    from .device import resolve_device
    from .engine.inpaint import make_eval_step

    device = resolve_device(device)
    models = CheckpointManager(cfg).restore_models(epoch, device)
    steps = [make_eval_step(cfg.replace(quant=q), device)
             for q in ("none", "int8")]
    ds = SelfRefDataset(str(valid), str(masks), cfg.fine_size)
    it = BatchIterator(ds, cfg.batch_size, shuffle=False, drop_last=False)
    total, n, largest = 0.0, 0, 0.0
    for batch in device_batches(iter(it), device):
        f32, q = (step(models, batch)["fake_B"] for step in steps)
        take = min(f32.shape[0], max_images - n)
        d = (q[:take] - f32[:take]).abs()
        total += float(d.sum())
        largest = max(largest, float(d.max()))
        n += take
        if n >= max_images:
            break
    per = 3 * cfg.fine_size ** 2
    return {"mean_d": total / (n * per), "max_d": largest, "images": n,
            "finite": bool(np.isfinite(total))}


def serve_once(cfg, epoch: int, valid: Path, masks: Path, out: Path,
               device: str) -> dict:
    """The checkpoint behind make_app on ThreadingWSGIServer at an
    ephemeral 127.0.0.1 port: one multipart POST, the result back."""
    from PIL import Image

    from .serve.app import make_app, post_over_socket

    images, holes = sorted(valid.iterdir()), sorted(masks.iterdir())
    app = make_app(cfg, epoch, str(out / "static"), device=device)
    try:
        status, location, ms, jpg = post_over_socket(app, {
            "srcImage": images[0].read_bytes(),
            "binaryMask": holes[0].read_bytes(),
            "refImage": images[1].read_bytes()})
    finally:
        app.session.close()
    size = Image.open(io.BytesIO(jpg)).size
    return {"status": status, "location": location, "post_ms": ms,
            "result_size": list(size), "result_bytes": len(jpg),
            "ok": (status == 302 and location == "/result"
                   and size == (cfg.fine_size, cfg.fine_size))}


def run_protocol(proto: Protocol, out: Path, seed: int, device: str,
                 cut: Optional[Cut] = None) -> dict:
    """Train and evaluate `proto` at `seed` under `out` (at a cut depth
    if `cut`); returns the
    run's figures, each evaluation's under its figure names, and the
    kernels' launches of training and evaluation."""
    from . import _cli
    from .config import Config

    out = Path(out).resolve()
    logs = out / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    data, data_s = make_data(out, cut.data if cut else DATA[proto.data])
    valid, masks = data / "valid", data / "mask"
    name = f"{proto.name}_seed{seed}"
    ckpt = out / "checkpoints"
    run_dir = ckpt / name
    shutil.rmtree(run_dir, ignore_errors=True)
    common = ["--dataroot", str(data / "img"), "--maskroot", str(masks),
              "--refroot", str(data / "img"), "--validroot", str(valid),
              "--validrefroot", str(valid), *COMMON, *proto.overrides]
    pieces = [common + list(p) for p in proto.pieces]
    evaluations = list(proto.evaluations)
    if cut is not None:
        last = max(ev.epoch for ev in evaluations)
        pieces = [pieces[0] + list(cut.train)]
        evaluations = [dataclasses.replace(ev, epoch=last_epoch(pieces[0]))
                       for ev in evaluations
                       if ev.epoch == last and cut.evaluate]
    cfg = train_config(pieces[-1])
    n_train = len(list((data / "img").iterdir()))
    figures = {"seed": seed, "fine_size": cfg.fine_size,
               "batch_size": cfg.batch_size,
               "epochs": cfg.niter + cfg.niter_decay, "data_s": data_s,
               "train_s": 0.0, "train_images": 0}
    tail = ["--checkpoints_dir", str(ckpt), "--name", name, "--seed",
            str(seed), "--device", device]

    launches = {k: {"scan_stream": 0, "kbar_build": 0}
                for k in ("train", "evaluate")}

    def count(kind, before):
        for k, v in _since(before).items():
            launches[kind][k] += v

    def evaluate(ev):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = _cli.evaluate(
                ["--dataroot", str(valid), "--maskroot", str(masks),
                 "--checkpoints_dir", str(ckpt), "--name", name,
                 "--which_epoch", str(ev.epoch), "--max_images",
                 str(proto.max_images), "--device", device, *ev.flags])
        (logs / f"{name}.eval_{ev.name}.log").write_text(buf.getvalue())
        psnrs = per_image(buf.getvalue())[0]
        figures[f"psnr_{ev.name}"] = res["psnr"]
        figures[f"ssim_{ev.name}"] = res["ssim"]
        figures[f"images_{ev.name}"] = res["images"]
        figures[f"psnr_per_image_{ev.name}"] = psnrs
        if ev.kind != "abs":
            figures[f"d_psnr_{ev.name}"] = (res["psnr"]
                                            - figures[f"psnr_{ev.base}"])
            figures[f"d_ssim_{ev.name}"] = (res["ssim"]
                                            - figures[f"ssim_{ev.base}"])
            base = figures[f"psnr_per_image_{ev.base}"]
            figures[f"max_abs_d_psnr_{ev.name}"] = max(
                abs(a - b) for a, b in zip(psnrs, base))
        print(f"[demo] {name} {ev.name} (epoch {ev.epoch}"
              + (f", {' '.join(ev.flags)}" if ev.flags else "")
              + f"): PSNR {res['psnr']:.4f} SSIM {res['ssim']:.4f} over "
              f"{res['images']} images", flush=True)

    # each piece trains, then the evaluations of the epochs it reached
    # run, and the checkpoints no later evaluation or resume reads go
    pending = list(evaluations)
    for i, argv in enumerate(pieces):
        pcfg = train_config(argv)
        first = (int(pcfg.which_epoch) if pcfg.continue_train
                 else pcfg.epoch_count - 1)
        reached = last_epoch(argv)
        before = _launches()
        t0 = time.perf_counter()
        with open(logs / f"{name}.train{i}.log", "w") as log, \
                contextlib.redirect_stdout(log):
            _cli.train(argv + tail)
        dt = time.perf_counter() - t0
        count("train", before)
        shutil.copy(run_dir / "metrics.csv", logs / f"{name}.metrics.csv")
        figures["train_s"] += dt
        images = n_train // pcfg.batch_size * pcfg.batch_size * (
            reached - first)
        figures["train_images"] += images
        print(f"[demo] {name}: trained epochs {first + 1}-{reached}, "
              f"{images} images in {dt:.1f} s ({images / dt:.1f} img/s)",
              flush=True)
        before = _launches()
        for ev in [ev for ev in pending if ev.epoch <= reached]:
            evaluate(ev)
            pending.remove(ev)
        count("evaluate", before)
        resume = train_config(pieces[i + 1]).which_epoch \
            if i + 1 < len(pieces) else ""
        _prune(run_dir, {ev.epoch for ev in pending}
               | ({int(resume)} if resume else set())
               | ({evaluations[-1].epoch} if proto.serve and evaluations
                  else set()))
    figures["train_wall_img_s"] = (figures["train_images"]
                                   / figures["train_s"])

    if proto.serve and evaluations:
        run_cfg = Config.load(str(run_dir / "config.json")).replace(
            checkpoints_dir=str(ckpt), name=name, is_train=False)
        epoch = evaluations[-1].epoch
        before = _launches()
        figures["fake_B_int8_gap"] = int8_fake_b_gap(
            run_cfg, epoch, valid, masks, proto.max_images, device)
        served = serve_once(run_cfg, epoch, valid, masks, out, device)
        count("evaluate", before)
        figures["served"] = served
        figures["served_ok"] = served["ok"]
        print(f"[demo] {name}: int8 fake_B against f32 "
              f"{figures['fake_B_int8_gap']}, served {served}", flush=True)
    figures["launches_train"] = launches["train"]
    figures["launches_evaluate"] = launches["evaluate"]
    print(f"[demo] {name}: launches {launches}", flush=True)
    for k in [k for k in figures if k.startswith("psnr_per_image_")]:
        del figures[k]
    _prune(run_dir, set())
    return figures


def run(names, out: Path, seed: int, device: str) -> dict:
    """Each protocol at `seed`, and again at seed + 1 if a figure missed:
    {name: [figures of each seed run]}."""
    import torch
    results = {}
    for name in names:
        proto = PROTOCOLS[name]
        runs = [run_protocol(proto, out, seed, device)]
        missed = judge(proto, runs[0])
        if missed:
            print(f"[demo] {name} seed {seed} outside its bands: {missed}; "
                  f"rerun at seed {seed + 1}", flush=True)
            runs.append(run_protocol(proto, out, seed + 1, device))
        results[name] = runs
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="working directory")
    ap.add_argument("--protocol", action="append", default=[],
                    choices=list(PROTOCOLS) + ["all"],
                    help="a protocol to run (repeatable; 'all' runs every "
                         "one, 256 px last); default f32")
    ap.add_argument("--seed", type=int, default=0,
                    help="Config.seed of the first run (initial weights, "
                         "masks); a miss reruns at seed + 1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = (ORDER if "all" in args.protocol
             else list(dict.fromkeys(args.protocol)) or ["f32"])
    return report(run(names, Path(args.out), args.seed, args.device))


if __name__ == "__main__":
    sys.exit(main())
