"""A spread of the port's 128 px `f32` protocol over seeds and repeats, on
the card, under one of four arithmetics:

  f32   the port as it ships (TF32 off, cuDNN's default algorithms);
  det   f32 under torch.use_deterministic_algorithms(True, warn_only=True),
        cudnn.deterministic and CUBLAS_WORKSPACE_CONFIG=:4096:8 (the ops
        that have no deterministic version are named in the result);
  tf32  f32 with TF32 on for cuDNN convolutions and cuBLAS matmuls;
  tpu   the TPU's default matmul precision emulated (studies/
        tpu_precision.py): every conv and the attention's products take
        operands rounded to bf16, with products and sums in f32.

    python studies/protocol_spread.py --out build/spread \
        --run f32:0-7x2 --run det:0-3x2 --procs 4 [--ngf 16]

Each run is `demo.run_protocol` of the `f32` protocol with its e5 and e20
evaluations (no int8 or known-replacement evaluation, no POST), in a
process of its own; at most --procs share the card.  Every run's result
(PSNR / SSIM, train time, the per-epoch mean train losses, the
determinism warnings) goes to <out>/results/<mode>_s<seed>_r<rep>.json,
its per-step metrics.csv and logs under <out>/logs, and the summary
(each run, the groups, bit-for-bit equality of a seed's repeats) to
--summary.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import common

MODES = ("f32", "det", "tf32", "tpu")
# a CPU rehearsal of this script: the runner at a tiny depth and width
REHEARSE = (("--n", "16", "--n_valid", "4", "--n_masks", "4", "--size", "64"),
            ("--niter", "1", "--niter_decay", "1", "--save_epoch_freq", "1",
             "--fine_size", "64", "--ngf", "8", "--ndf", "8",
             "--vgg_width_scale", "0.125", "--batch_size", "2",
             "--data_workers", "0"))


def parse_runs(specs) -> list:
    """'mode:a-bxk' (seeds a..b, k repeats each) or 'mode:s1,s2xk' ->
    [(mode, seed, rep)], repeats of a seed interleaved last."""
    runs = []
    for spec in specs:
        mode, rest = spec.split(":")
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} (one of {MODES})")
        seeds, _, k = rest.partition("x")
        runs += [(mode, s, r) for r in range(int(k or 1))
                 for s in common.seeds(seeds)]
    return runs


def set_mode(mode: str) -> list:
    """Put this process in `mode` before the port is imported; returns
    the list that collects determinism warnings."""
    import torch

    import deepinpainting_torch.device as D
    caught = []
    if mode == "det":
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

        def show(message, category, filename, lineno, file=None, line=None):
            text = str(message).split("\n")[0]
            if text not in caught:
                caught.append(text)
                print(f"[spread] determinism warning: {text}",
                      file=sys.stderr, flush=True)
        warnings.simplefilter("always")
        warnings.showwarning = show
    elif mode == "tf32":
        resolve = D.resolve_device

        def resolve_tf32(device=None):
            dev = resolve(device)
            if dev.type == "cuda":
                torch.backends.cudnn.allow_tf32 = True
                torch.backends.cuda.matmul.allow_tf32 = True
            return dev
        D.resolve_device = resolve_tf32     # before any module binds it
    elif mode == "tpu":
        import tpu_precision
        tpu_precision.install()
    return caught


def worker(args) -> int:
    caught = set_mode(args.mode)
    from deepinpainting_torch import demo
    if args.init_from:
        common.start_from(Path(args.init_from))

    base = demo.PROTOCOLS["f32"]
    width = ()
    if args.ngf:
        width = ("--ngf", str(args.ngf), "--ndf", str(args.ngf),
                 "--vgg_width_scale", str(args.ngf / 64))
    proto = dataclasses.replace(
        base, name=f"{args.mode}r{args.rep}", serve=False,
        overrides=base.overrides + width,
        evaluations=tuple(ev for ev in base.evaluations
                          if ev.name in ("e5", "e20")))
    out = Path(args.out)
    t0 = time.perf_counter()
    cut = demo.Cut(*REHEARSE) if args.rehearse else None
    fig = demo.run_protocol(proto, out, args.seed, args.device, cut)
    name = f"{proto.name}_seed{args.seed}"
    per = fig["train_images"] // fig["batch_size"] // fig["epochs"]
    fig.update(mode=args.mode, rep=args.rep, wall_s=time.perf_counter() - t0,
               epoch_means=common.epoch_means(
                   out / "logs" / f"{name}.metrics.csv", per,
                   common.LOSSES + ("loss",)),
               determinism_warnings=caught,
               epoch_train_valid=common.train_valid(
                   (out / "logs" / f"{name}.train0.log").read_text()))
    res = out / "results"
    res.mkdir(parents=True, exist_ok=True)
    (res / f"{args.mode}_s{args.seed}_r{args.rep}.json").write_text(
        json.dumps(fig))
    return 0


def same_bits(a: Path, b: Path) -> bool:
    """Two runs' per-step losses equal bit for bit (the time column
    aside)."""
    def rows(p):
        with open(p) as f:
            return [{k: v for k, v in r.items() if k != "time"}
                    for r in csv.DictReader(f)]
    return rows(a) == rows(b)


def summarise(out: Path, runs: list) -> dict:
    results, missing = [], []
    for mode, seed, rep in runs:
        p = out / "results" / f"{mode}_s{seed}_r{rep}.json"
        if p.exists():
            results.append(json.loads(p.read_text()))
        else:
            missing.append([mode, seed, rep])
    pairs = {}
    for r in results:
        pairs.setdefault((r["mode"], r["seed"]), []).append(r["rep"])
    equal = {}
    for (mode, seed), reps in pairs.items():
        if len(reps) > 1:
            logs = [out / "logs" / f"{mode}r{rep}_seed{seed}.metrics.csv"
                    for rep in sorted(reps)]
            equal[f"{mode}_s{seed}"] = all(same_bits(logs[0], p)
                                           for p in logs[1:])
    keep = ("mode", "seed", "rep", "psnr_e5", "ssim_e5", "psnr_e20",
            "ssim_e20", "train_s", "wall_s", "epoch_means",
            "epoch_train_valid", "determinism_warnings", "launches_train")
    return {"runs": [{k: r.get(k) for k in keep} for r in results],
            "missing": missing, "bit_equal_repeats": equal}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", action="append", default=[],
                    help="mode:seeds[xrepeats], e.g. f32:0-7x2 (repeatable)")
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--summary", default="")
    ap.add_argument("--ngf", type=int, default=0,
                    help="a narrower network: ngf = ndf = NGF and VGG at "
                         "NGF/64 of its width (0: the protocol's 64)")
    ap.add_argument("--init_from", default="",
                    help="start each run from DIR/s<seed>/<net>.npz, or "
                         "from a draw packed by studies/jax_draw.py")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny data and widths (a CPU rehearsal)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mode", choices=MODES, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rep", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)

    out = Path(args.out).resolve()
    (out / "procs").mkdir(parents=True, exist_ok=True)
    runs = parse_runs(args.run)
    if args.init_from.endswith(".npz"):
        # a packed JAX draw (studies/jax_draw.py): unpacked and checked
        import jax_draw
        report = jax_draw.unpack(Path(args.init_from), out / "init")
        (out / "init.json").write_text(json.dumps(report))
        print(f"[spread] starting weights {args.init_from}: {report}",
              flush=True)
        args.init_from = str(out / "init")
    queue, live, t0 = list(runs), [], time.perf_counter()
    while queue or live:
        while queue and len(live) < args.procs:
            mode, seed, rep = queue.pop(0)
            env = dict(os.environ, PYTHONPATH=str(common.REPO))
            if mode == "det":
                env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            log = open(out / "procs" / f"{mode}_s{seed}_r{rep}.log", "w")
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--worker", "--out", str(out), "--mode", mode, "--seed",
                   str(seed), "--rep", str(rep), "--device", args.device]
            cmd += ["--rehearse"] if args.rehearse else []
            cmd += ["--ngf", str(args.ngf)] if args.ngf else []
            cmd += (["--init_from", str(Path(args.init_from).resolve())]
                    if args.init_from else [])
            live.append(((mode, seed, rep), log, subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT)))
        time.sleep(2)
        for item in list(live):
            key, log, proc = item
            if proc.poll() is not None:
                log.close()
                live.remove(item)
                print(f"[spread] {key} exited {proc.returncode} at "
                      f"{time.perf_counter() - t0:.0f} s", flush=True)
        if args.summary:
            Path(args.summary).parent.mkdir(parents=True, exist_ok=True)
            Path(args.summary).write_text(json.dumps(summarise(out, runs)))
    summary = summarise(out, runs)
    for r in summary["runs"]:
        print(f"[spread] {r['mode']} seed {r['seed']} rep {r['rep']}: e20 "
              f"{r['psnr_e20']} / {r['ssim_e20']}, e5 {r['psnr_e5']}, "
              f"epoch train / valid loss {r['epoch_train_valid'][:3]}, "
              f"{r['train_s']:.0f} s")
    print(f"[spread] bit-equal repeats: {summary['bit_equal_repeats']}; "
          f"missing {summary['missing']}; "
          f"{time.perf_counter() - t0:.0f} s")
    return 1 if summary["missing"] else 0


if __name__ == "__main__":
    sys.exit(main())
