#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure ends the run with a non-zero exit and no result line):
  1. build every kernel of the main path from csrc/ (nvcc, in parallel);
  2. each kernel against its plain PyTorch version on the card, same inputs:
     short chains elementwise, production holes within 8x the measured
     chaos envelope, and the structural invariants of unmasked rows;
  3. the main path: full-width 256 px serving (Config() defaults, weights
     from a seed) through InferenceSession, single and coalesced requests,
     with the kernels' launch counts read around it;
  4. the whole forward with the kernel against the plain scan, and the card
     against the CPU at a small config;
  5. numbers: kernel and plain times, bounds, serving latency/throughput.
The line before the last is a JSON object with a `kernels` list; the last
line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# H100 SXM peaks the bounds are computed against (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

DIRECT_TOL = 2e-3      # short chains, elementwise
ENVELOPE_K = 8.0       # production holes: within 8x the chaos envelope
PERTURB = 1e-6         # the envelope's input perturbation
E2E_TOL = 1e-3         # whole forward, kernel vs plain, small hole
SCAN_C = 512           # attention channels at the default width (8*ngf)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of `reps` single-call times, CUDA events, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def scan_bound(flag, c: int) -> dict:
    """Least time for the scan on these inputs.  Bytes: every row's flag,
    `known` and output row and (a, b); `pn` and `vmax` of masked rows only
    (an unmasked row's output is its `known` row).  Operations: a masked
    row's dot product and blend, ~5C+4 f32 ops."""
    bsz, n = flag.shape
    m = int((flag > 0).sum().item())
    nbytes = bsz * n * (4 + 4 * c + 4 * c + 8) + m * (4 * c + 4)
    ops = m * (5 * c + 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "masked": m,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def profile_requests(session, requests, card: str) -> None:
    """Device time by kernel class over a few b1 requests (torch.profiler),
    and the device's busy share of the host wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    classes = (("scan kernel", ("scan_stream",)),
               ("convolution", ("conv", "cudnn", "xmma", "implicit",
                                "winograd", "fft", "wgrad", "dgrad")),
               ("matmul", ("gemm", "gemv")),
               ("copy/fill", ("memcpy", "memset")))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in requests:
            session.run(*r)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_class, top = {}, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0:
            continue
        name = ev.key.lower()
        cls = next((c for c, keys in classes
                    if any(k in name for k in keys)), "elementwise/other")
        by_class[cls] = by_class.get(cls, 0.0) + us
        top.append((us, ev.count, ev.key[:90]))
    total = sum(by_class.values())
    n = len(requests)
    if total <= 0:
        log("phase 5 profile: the profiler recorded no device time")
        return
    log(f"phase 5 profile, {n} b1 requests at 256 px: device busy "
        f"{total / wall_us:.1%} of wall, {total / n / 1e3:.3f} ms device "
        f"time a request  [{card}]")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"  {cls:18s} {us / n / 1e3:8.3f} ms/request  {us / total:6.1%}")
    for us, count, name in sorted(top, reverse=True)[:8]:
        log(f"  top {us / n / 1e3:8.3f} ms/request x{count / n:g}: {name}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F
    from deepinpainting_torch import _build
    from deepinpainting_torch.config import Config
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.ops import attention as TA
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.serve.app import InferenceSession

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f"; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    log(f"phase 1 build: {_build.KERNELS} in {time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_log.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"  {name}: {regs[-1] if regs else 'built'} (smallest variant)")

    # ---- phase 2: kernel vs plain on the card ------------------------------
    def smooth(rng, b, h, w, c, base=4):
        lo = torch.from_numpy(rng.standard_normal((b, c, base, base)
                                                  ).astype(np.float32))
        x = F.interpolate(lo.to(dev), size=(h, w), mode="bilinear",
                          align_corners=False)
        noise = torch.from_numpy(0.05 * rng.standard_normal((b, c, h, w)
                                                            ).astype(np.float32))
        return x + noise.to(dev)

    def make_case(seed, b, h, w, holes):
        """Smooth features, non-negative refs (relu4_3 is post-ReLU), and
        rectangular holes shifted by the sample index."""
        rng = np.random.default_rng(seed)
        rows = lambda t: t.flatten(2).transpose(1, 2).contiguous()
        feat = rows(smooth(rng, b, h, w, SCAN_C))
        ref = rows(smooth(rng, b, h, w, SCAN_C).abs())
        fm = np.zeros((b, h, w), np.float32)
        for i in range(b):
            for (y0, x0, hh, ww) in holes:
                y, x = min(y0 + i, h - hh), min(x0 + i, w - ww)
                fm[i, y:y + hh, x:x + ww] = 1.0
        return feat, ref, torch.from_numpy(fm.reshape(b, h * w)).to(dev)

    def scan_args(feat, ref, flag, kr):
        _, pn, _, vmax, known = TA.prep(feat, ref, flag, kr)
        return flag.contiguous(), vmax.contiguous(), pn, known

    def compare(feat, ref, flag, kr):
        args = scan_args(feat, ref, flag, kr)
        k_out, k_a, k_b = TAC.scan_stream_cuda(*args)
        p_out, p_a, p_b = TA.scan_stream_reference(*args)
        pert_out, _, _ = TA.scan_stream_reference(
            *scan_args(feat * (1.0 + PERTURB), ref, flag, kr))
        torch.cuda.synchronize()
        um = flag == 0
        return {
            "d_out": (k_out - p_out).abs().max().item(),
            "d_out_mean": (k_out - p_out).abs().mean().item(),
            "d_ab": max((k_a - p_a).abs().max().item(),
                        (k_b - p_b).abs().max().item()),
            "chaos": (p_out - pert_out).abs().max().item(),
            "chaos_mean": (p_out - pert_out).abs().mean().item(),
            "struct": bool(torch.equal(k_out[um], args[3][um])
                           and bool((k_a[um] == 1).all())
                           and bool((k_b[um] == 0).all())),
            "masked": flag.mean().item(),
        }

    short_holes = [(3, 4, 1, 3), (15, 20, 1, 3), (28, 10, 1, 3)]  # 9 rows
    cases = [
        ("short chain, faithful", 0, 8, 32, 32, short_holes, True, "direct"),
        ("short chain, corrected", 1, 8, 32, 32, short_holes, False,
         "direct"),
        ("25% hole, N=1024", 2, 8, 32, 32, [(6, 8, 16, 16)], True,
         "envelope"),
        ("3.7% hole, N=4096", 3, 8, 64, 64, [(20, 24, 13, 12)], True,
         "envelope"),
    ]
    max_abs_err = 0.0
    for name, seed, b, h, w, holes, kr, crit in cases:
        r = compare(*make_case(seed, b, h, w, holes), kr)
        log(f"phase 2 {name} (B={b}, N={h * w}, C={SCAN_C}, masked "
            f"{r['masked']:.2%}): d_out={r['d_out']:.3e} "
            f"d_out_mean={r['d_out_mean']:.3e} d_ab={r['d_ab']:.3e} "
            f"chaos={r['chaos']:.3e} chaos_mean={r['chaos_mean']:.3e} "
            f"structure={'exact' if r['struct'] else 'BROKEN'}")
        check(r["struct"], f"{name}: unmasked rows must be known and (1, 0)")
        if crit == "direct":
            check(r["d_out"] <= DIRECT_TOL and r["d_ab"] <= DIRECT_TOL,
                  f"{name}: kernel vs plain beyond {DIRECT_TOL}")
            max_abs_err = max(max_abs_err, r["d_out"], r["d_ab"])
        else:
            check(r["d_out"] <= ENVELOPE_K * max(r["chaos"], 1e-6),
                  f"{name}: max divergence outside {ENVELOPE_K}x envelope")
            check(r["d_out_mean"] <= ENVELOPE_K * max(r["chaos_mean"], 1e-2),
                  f"{name}: mean divergence outside {ENVELOPE_K}x envelope")

    # ---- phase 3: the main path, full-width 256 px serving ----------------
    cfg = Config()
    s = cfg.fine_size
    t0 = time.perf_counter()
    models = TI.init_params(cfg, torch.Generator().manual_seed(cfg.seed), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for net in models for p in net.parameters())
    log(f"phase 3 init: fine_size={s} ngf={cfg.ngf} vgg_width_scale="
        f"{cfg.vgg_width_scale}, {n_params} parameters, "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)

    def center(b=1):
        m = np.zeros((b, s, s), np.uint8)
        lo, hi = s // 4 + cfg.overlap, s // 2 + s // 4 - cfg.overlap
        m[:, lo:hi, lo:hi] = 1
        return m

    def strokes(b=1, n=6, thick=12):
        yy, xx = np.mgrid[0:s, 0:s]
        m = np.zeros((b, s, s), bool)
        for i in range(b):
            for _ in range(n):
                p0 = rng.uniform(0.2 * s, 0.8 * s, 2)
                d = rng.standard_normal(2)
                p1 = np.clip(p0 + d / np.linalg.norm(d) * rng.uniform(20, 70),
                             0, s - 1)
                v = p1 - p0
                t = np.clip(((yy - p0[0]) * v[0] + (xx - p0[1]) * v[1])
                            / (v @ v + 1e-9), 0, 1)
                dist = np.hypot(yy - p0[0] - t * v[0], xx - p0[1] - t * v[1])
                m[i] |= dist <= thick / 2
        return m.astype(np.uint8)

    def image(b=1):
        return rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)

    single = InferenceSession(cfg, state=models, device=dev)
    batched = InferenceSession(cfg, state=models, device=dev, max_batch=8,
                               batch_wait_ms=50.0)
    requests = [(image(), center(), image()), (image(), strokes(), image()),
                (image(), center(), image()), (image(), strokes(), image())]
    concurrent = [(image(), center() if i % 2 else strokes(), image())
                  for i in range(8)]

    TAC.launches = 0                      # counts: the main path only
    t0 = time.perf_counter()
    outs = [single.run(*r) for r in requests]
    results = [None] * len(concurrent)

    def client(i):
        results[i] = batched.run(*concurrent[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(concurrent))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    torch.cuda.synchronize()
    launches = {"scan_stream": TAC.launches}
    g_forwards = single.calls + batched.calls
    log(f"phase 3 served {len(requests)} single + {len(concurrent)} "
        f"concurrent requests in {time.perf_counter() - t0:.2f} s: "
        f"{g_forwards} netG forwards ({batched.calls} coalesced calls), "
        f"launches {launches}")
    check(not any(t.is_alive() for t in threads), "a request hung")
    for out in outs + results:
        check(out is not None and out.dtype == np.uint8
              and out.shape == (1, s, s, 3), "result must be uint8 [1,256,256,3]")
        check(out.std() > 0, "result must not be constant")
    check(launches["scan_stream"] == g_forwards > 0,
          "scan kernel launches must equal netG forwards")

    # ---- phase 4: whole forward, kernel vs plain; card vs CPU -------------
    infer_k = TI.make_inference_fn(cfg.replace(attention_impl="cuda"), dev)
    infer_p = TI.make_inference_fn(cfg.replace(attention_impl="torch"), dev)
    gt = torch.from_numpy(image()).to(dev)
    ref = torch.from_numpy(image()).to(dev)
    small = np.zeros((1, s, s), np.uint8)
    small[:, 96:120, 56:80] = 1          # 9 masked feature positions
    _, flag = TI.prepare_masks(cfg, torch.from_numpy(small).float())
    n_small = int(flag.sum().item())
    check(1 <= n_small <= 9, f"small hole has {n_small} masked positions")
    kb, _ = infer_k(*models, gt, small, ref)
    pb, _ = infer_p(*models, gt, small, ref)
    d_small = (kb - pb).abs().max().item()
    log(f"phase 4 small hole ({n_small} masked positions): fake_B kernel vs "
        f"plain max|d|={d_small:.3e} (limit {E2E_TOL})")
    check(d_small <= E2E_TOL, "small-hole fake_B kernel vs plain")
    check(bool(torch.isfinite(kb).all()), "fake_B must be finite")

    gtf = gt.float() / 127.5 - 1.0
    cm = center()
    _, flag = TI.prepare_masks(cfg, torch.from_numpy(cm).float())
    kb, _ = infer_k(*models, gtf, cm, ref)
    pb, _ = infer_p(*models, gtf, cm, ref)
    qb, _ = infer_p(*models, gtf * (1.0 + PERTURB), cm, ref)
    d, env = (kb - pb).abs(), (pb - qb).abs()
    log(f"phase 4 center hole ({int(flag.sum().item())} masked positions): "
        f"kernel vs plain max {d.max().item():.3e} mean {d.mean().item():.3e};"
        f" envelope max {env.max().item():.3e} mean {env.mean().item():.3e}")
    check(bool(torch.isfinite(kb).all()), "fake_B must be finite")
    check(d.max().item() <= ENVELOPE_K * max(env.max().item(), 1e-6),
          "center-hole max divergence outside the envelope")
    check(d.mean().item() <= ENVELOPE_K * max(env.mean().item(), 1e-2),
          "center-hole mean divergence outside the envelope")

    small_cfg = Config(fine_size=64, ngf=8, vgg_width_scale=1 / 8)
    on_card = TI.init_params(small_cfg, torch.Generator().manual_seed(1), dev)
    on_cpu = TI.init_params(small_cfg, torch.Generator().manual_seed(1), "cpu")
    srng = np.random.default_rng(1)
    sgt = srng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    sref = srng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    smask = np.zeros((2, 64, 64), np.uint8)
    smask[:, 20:40, 24:40] = 1
    got, _ = TI.make_inference_fn(small_cfg, dev)(*on_card, sgt, smask, sref)
    want, _ = TI.make_inference_fn(small_cfg, "cpu")(*on_cpu, sgt, smask,
                                                     sref)
    d_cpu = np.abs(got.cpu().numpy() - want.numpy()).max()
    log(f"phase 4 64 px config, card vs CPU plain path: max|d|={d_cpu:.3e}")
    check(d_cpu <= E2E_TOL, "card vs CPU at the small config")

    # ---- phase 5: numbers -------------------------------------------------
    log(f"card: {card}")
    cflag = TI.prepare_masks(cfg, torch.from_numpy(center()).float())[1]
    timings = {}
    for b in (1, 8):
        feat, refr, _ = make_case(10 + b, b, 32, 32, [])
        flag = cflag.to(dev).expand(b, -1).contiguous()
        args = scan_args(feat, refr, flag, True)
        bound = scan_bound(flag, SCAN_C)
        k_ms = cuda_ms(lambda: TAC.scan_stream_cuda(*args), reps=50)
        p_ms = cuda_ms(lambda: TA.scan_stream_reference(*args), reps=20,
                       warmup=1)
        timings[b] = dict(ms=k_ms, plain_ms=p_ms, **bound)
        log(f"phase 5 scan_stream B={b} N=1024 C={SCAN_C} masked "
            f"{bound['masked']} rows: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.2f} ms, bound {bound['bound_ms']:.5f} ms "
            f"({bound['bound_by']}: {bound['bytes']} B, {bound['ops']} ops), "
            f"share {bound['bound_ms'] / k_ms:.2%}, library call: none  "
            f"[{card}]")

    # chain probe: the same shapes with no row and with every row masked
    for label, value in (("no row masked", 0.0), ("every row masked", 1.0)):
        flag = torch.full((8, 1024), value, device=dev)
        args = (flag,) + scan_args(feat, refr, flag, True)[1:]
        log(f"phase 5 scan_stream B=8 N=1024 {label}: kernel "
            f"{cuda_ms(lambda: TAC.scan_stream_cuda(*args), reps=50):.4f} ms"
            f", bound {scan_bound(flag, SCAN_C)['bound_ms']:.5f} ms  [{card}]")

    lat = []
    for i in range(21):
        r = (image(), center() if i % 2 else strokes(), image())
        t0 = time.perf_counter()
        single.run(*r)
        lat.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(lat[1:])
    profile_requests(single, [(image(), center(), image()) for _ in range(5)],
                     card)
    n_req = 32
    reqs = [(image(), center() if i % 2 else strokes(), image())
            for i in range(n_req)]
    calls0 = batched.calls

    def worker(k):
        for i in range(k, n_req, 8):
            batched.run(*reqs[i])

    t0 = time.perf_counter()
    ws = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in ws:
        t.start()
    for t in ws:
        t.join(600)
    wall = time.perf_counter() - t0
    log(f"phase 5 serving 256 px: b1 request p50 {p50:.2f} ms "
        f"(20 requests), b8 throughput {n_req / wall:.2f} img/s "
        f"({n_req} requests over 8 clients, {batched.calls - calls0} "
        f"batched calls)  [{card}]")
    single.close()
    batched.close()

    t8 = timings[8]
    print(json.dumps({"kernels": [{
        "name": "scan_stream", "route": "cuda",
        "source": "deepinpainting_torch/csrc/scan_stream.cu",
        "replaces": "deepinpainting_tpu/ops/attention_pallas.py:107",
        "launches": launches["scan_stream"], "max_abs_err": max_abs_err,
        "ms": t8["ms"], "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
