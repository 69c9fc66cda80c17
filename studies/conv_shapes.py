"""The hand-written f32 convolution (csrc/conv2d.cu) against cuDNN at every
shape ops/convs.py routes to it, on the card.

    python studies/conv_shapes.py [--out build/conv_shapes.json]
        [--sweep] [--reps 20]

For each routed call of the 256 px f32 train step, the 512 px bf16 step
(netD's and netF's f32 forwards) and 256 px serving at batches 1 and 8 (the
U-Nets' kernel-4 down convs), at full width (tests/torch_conv_shapes.py
enumerates them from the networks): the GEMM's shape (M, N, K),
its FLOP bound at 67 TFLOP/s, the kernel's time under conv_cuda.plan and
cuDNN's time for the call it replaces (F.conv2d for a forward, aten's
transposed-conv input gradient for a data gradient), both as the mean of
`--reps` launches back to back between CUDA events, TF32 off; the largest
error of each against a float64 convolution on the card; and whether two
launches of the kernel agree bit for bit.  `--sweep` also times every tile
and split of the depth.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from deepinpainting_torch.ops import conv_cuda  # noqa: E402
from torch_conv_shapes import STEP_CALLS, gemm, routed_calls  # noqa: E402

F32_PEAK = 67e12


def cases():
    """{(cell, kind, geometry): [layers]} of every routed call."""
    out = {}
    sets = [("train-256-f32", routed_calls(256, 8)),
            ("train-512-bf16", routed_calls(512, 8, ("D", "F"))),
            ("serve-256-b8", routed_calls(256, 8, ("G", "P"))),
            ("serve-256-b1", routed_calls(256, 1, ("G", "P")))]
    for cell, rows in sets:
        for name, kind, geo in rows:
            if cell.startswith("serve") and kind != "fwd":
                continue
            out.setdefault((cell, kind, geo), []).append(name)
    return out


def timed(fn, reps):
    """Mean ms of `reps` calls back to back, after two warm-up calls."""
    fn(), fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(kind, geo, reps, sweep, gen):
    b, c, h, w, n, k, s, p, d = geo
    dev = torch.device("cuda")
    m_, n_, k_ = gemm(geo)
    x = torch.randn(b, c, h, w, generator=gen, device=dev)
    wt = torch.randn(n, c, k, k, generator=gen, device=dev) / math.sqrt(k_)
    bias = (torch.randn(n, generator=gen, device=dev) if kind == "fwd"
            else None)
    hand = lambda pl=None: conv_cuda._launch(x, wt, bias, s, p, d, pl)
    if kind == "fwd":
        lib = lambda: F.conv2d(x, wt, bias, s, p, d)
    else:
        # cuDNN's input gradient of the transposed conv whose weight is wt
        # ([Cin_t, Cout_t, k, k] = [n, c, k, k]) and whose output is x
        xt = torch.empty(b, n, *gemm_out(geo), device=dev)
        lib = lambda: torch.ops.aten.convolution_backward(
            x, xt, wt, None, [s, s], [p, p], [1, 1], True, [0, 0], 1,
            [True, False, False])[0]
    want = F.conv2d(x.double(), wt.double(),
                    None if bias is None else bias.double(), s, p, d)
    got, again, ref = hand(), hand(), lib()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    row = {
        "kind": kind, "geometry": list(geo), "M": m_, "N": n_, "K": k_,
        "gflop": 2 * m_ * n_ * k_ / 1e9,
        "bound_ms": 2 * m_ * n_ * k_ / F32_PEAK * 1e3,
        "plan": list(conv_cuda.plan(m_, n_, k_)),
        "takes": conv_cuda.takes(m_, n_, k_, s, d),
        "hand_err": (got.double() - want).abs().max().item() / scale,
        "cudnn_err": (ref.double() - want).abs().max().item() / scale,
        "bitwise_repeat": bool(torch.equal(got, again)),
        "hand_ms": timed(hand, reps), "cudnn_ms": timed(lib, reps),
    }
    row["hand_pct_peak"] = 100 * row["bound_ms"] / row["hand_ms"]
    row["cudnn_pct_peak"] = 100 * row["bound_ms"] / row["cudnn_ms"]
    if sweep:
        opts = {}
        for bm, bn in conv_cuda.TILES:
            for splits in (1, 2, 4, 8, 16, 32):
                if splits > 1 and k_ // splits < 64:
                    continue
                pl = split_plan(k_, bm, bn, splits)
                opts[f"{bm}x{bn}/{pl.splits}"] = timed(lambda: hand(pl),
                                                       reps)
        row["sweep_ms"] = opts
    return row


def split_plan(k, bm, bn, splits):
    """The launch of a bm x bn tile with the depth k in `splits` slices
    of whole steps (conv_cuda.plan's own split, for a chosen tile)."""
    k_split = math.ceil(math.ceil(k / splits) / conv_cuda.BK) * conv_cuda.BK
    return conv_cuda.Plan(bm, bn, math.ceil(k / k_split), k_split)


def gemm_out(geo):
    b, c, h, w, n, k, s, p, d = geo
    return (conv_cuda.out_size(h, k, s, p, d),
            conv_cuda.out_size(w, k, s, p, d))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/conv_shapes.json")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    from deepinpainting_torch import _build
    _build.build(["conv2d"])
    build_s = time.perf_counter() - t0
    print(f"build {build_s:.1f} s\n{_build.build_log.get('conv2d', '')}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (cell, kind, geo), layers in cases().items():
        row = measure(kind, geo, args.reps, args.sweep, gen)
        calls = sum(STEP_CALLS[name[0]] if cell.startswith("train") else 1
                    for name in layers)
        row.update(cell=cell, layers=layers, calls=calls)
        rows.append(row)
        print(f"{cell:15s} {kind:5s} M={row['M']:7d} N={row['N']:5d} "
              f"K={row['K']:5d} x{calls}  hand {row['hand_ms']:.4f} "
              f"({row['hand_pct_peak']:.1f}%)  cudnn {row['cudnn_ms']:.4f} "
              f"({row['cudnn_pct_peak']:.1f}%)  err {row['hand_err']:.2e} / "
              f"{row['cudnn_err']:.2e}  rep {row['bitwise_repeat']}  "
              f"plan {row['plan']}", flush=True)
        if args.sweep:
            best = min(row["sweep_ms"].items(), key=lambda kv: kv[1])
            print(f"    best {best[0]} {best[1]:.4f}", flush=True)
    card = torch.cuda.get_device_name(0)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "build_s": build_s,
         "rows": rows}, indent=1))
    for cell in sorted({r["cell"] for r in rows}):
        sel = [r for r in rows if r["cell"] == cell and r["takes"]]
        hand = sum(r["hand_ms"] * r["calls"] for r in sel)
        lib = sum(r["cudnn_ms"] * r["calls"] for r in sel)
        print(f"{cell}: routed calls {sum(r['calls'] for r in sel)}, hand "
              f"{hand:.3f} ms, cuDNN {lib:.3f} ms a step or batch")


if __name__ == "__main__":
    main()
