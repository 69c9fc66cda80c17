#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure ends the run with a non-zero exit and no result line):
  1. build every kernel of the main paths from csrc/ (nvcc, in parallel);
  2. each kernel against its plain PyTorch version on the card, same inputs:
     the scan on short chains elementwise and on production holes within 8x
     the measured chaos envelope, with the structural invariants of
     unmasked rows; the kbar kernel bit for bit on the same cases; then
     the attention's autograd Function with the kernels against the same
     Function with the plain versions, output and gradient; then both
     kernels on the cases their designs make special (no row masked, every
     row, the first row, a hole per sample, ragged N, narrow and wide C,
     more samples than SMs);
  3. the serving path: full-width 256 px serving (Config() defaults,
     weights from a seed) through InferenceSession, single and coalesced
     requests, with the kernels' launch counts read around it;
  4. the whole forward with the kernel against the plain scan, and the card
     against the CPU at a small config;
  5. the training path: three full-width train steps at batch 8 through
     create_state / make_train_step, launch counts read around them; the
     trained generators then serve a request; a few more steps for the
     timing and a profile; one step with the kernels against the same step
     with the plain versions;
  6. numbers: kernel times (the median of single launches, and the time a
     launch of 20 back to back), plain times, bounds, the scan's time a
     masked step, serving latency/throughput, train-step time and peak
     memory;
  7. the training program at full width: a synthetic 256 px dataset on
     disk, Trainer.fit for 2 epochs at batch 8 with 4 loader processes
     (validation, a visual dump, async checkpoints; launch counts read
     around it), a restore checked bit for bit, a resume that runs exactly
     epoch 3, evaluate() on the validation images, and evaluate() with the
     kernels against the plain versions at phase 4's small hole; then
     trainer img/s beside the bare step's, checkpoint and restore times,
     the loader alone, evaluate img/s and a profile of one epoch;
  8. the precision and memory options at 512 px, full width, batch 8, both
     kernels at N=4096: (a) bf16 with remat at depth 1 (the JAX package's
     512 px training configuration), (b) f32 without remat, (c) f32 with
     grad_accum=2, each three (two) steps with ms a step, peak memory and
     launches; (d) (a)'s first step with the kernels against the plain
     versions at a small hole, and the recompute's kbar against the
     forward's bit for bit; (e) bf16 serving at 256 and 512 px; (f) both
     kernels timed at N=4096, B=1 and B=8, center hole;
  9. the serving program at 256 px, full width: (a) phase 5's trained
     state saved with CheckpointManager (under build/, removed at exit) and
     restored by InferenceSession(cfg, which_epoch), its answers against
     phase 3's session bit for bit; (b) InpaintApp in process: three
     uploads, run_bytes against run, HTTP p50 (and its host work alone)
     and coalesced b8, one POST over ThreadingWSGIServer on 127.0.0.1;
     (c) the serving artifact:
     export and load times, bytes, the loaded call against the live
     serving function at B = 1, 3, 8, 9 bit for bit, the scan's launches
     inside it, a graph with the scan op and no kbar op, and
     InferenceSession.from_export's p50 and b8;
 10. the conv knobs at 256 px, full width: (a) every distinct int8-eligible
     conv of the serving path at B=1 and B=8, its int32 sums against the
     plain version on the card bit for bit, the int8 path's ms beside f32
     and bf16 cuDNN; (b) int8 serving of phase 5's trained weights (b1 p50,
     b8, fake_B against f32, launches) and int8 with the kernel against
     int8 with the plain scan at phase 4's small hole; (c) the int8
     artifact bit for bit with live int8 serving at B=1 and B=8; (d) both
     pack modes: serving, fake_B against unpacked, one train step against
     phase 5's unpacked step, ms a step and peak memory, and a remat step
     whose recompute builds the forward's kbar bit for bit;
 11. data parallelism (parallel/mesh.py) at 256 px, full width, TF32 off,
     each part in child processes: (a) two gloo ranks sharing the card
     take one step at global batch 8 (4 rows a rank) at phase 4's small
     hole, f32 instance norm, norm='batch' and grad_accum=2, against the
     one-process step on the same batch (losses, G's parameters, running
     statistics, each rank's launches); (b) one rank over NCCL through
     torch.distributed.run and `_cli train --multihost`, one epoch of
     phase 7's data, the step's time against phase 5's and its NCCL time;
     (c) a two-rank gloo Trainer.fit of 2 epochs of 3 steps: one
     checkpoint write, restored bit for bit on both ranks, the same
     validation losses on both, a resume.  The two-rank times share one
     card: they are no scaling figure;
 12. spatial partitioning (parallel/spatial.py) at 256 px, full width, f32,
     TF32 off: (a) two gloo ranks sharing the card serve one b1 request's
     rows on phase 5's weights, against the one-process forward at phase
     4's small hole (fake_B 1e-3, fake_P 2e-4) and the center hole (8x
     the forward's own 1e-7 envelope), each rank's scan launches, the
     collectives and bytes of a request, the b1 p50; (b) the 1 x 2 grid's
     train step at global batch 8, f32 instance norm and norm='batch',
     against the one-process step (losses, G's parameters, running
     statistics, launches); (c) `_cli serve --sp` under
     torch.distributed.run on two gloo ranks: a POST over a socket, the
     answer against the plain session's, the follower leaving with the
     session; (d) a group of one over NCCL: the SP builders bit for bit
     with the plain path, their request and step time as a ratio.  The
     two-rank times are no scaling figure either.
Three lines end the output, each on its own: a JSON object with a `kernels`
list, the card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import atexit
import contextlib
import csv
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
GRAD_TOL = 1e-5        # attention Function, kernels vs plain, short chains
STEP_TOL = 1e-3        # train-step losses, kernels vs plain, small hole
TRAIN_STEPS = 3        # counted and checked
TIMED_STEPS = 5        # more steps after those, for a steadier median
TRAIN_BATCH = 8
SCAN_C = 512           # attention channels at the default width (8*ngf)
P8_SIZE = 512          # phase 8: N = (512/8)^2 = 4096 attention positions
INT8_GAP = 0.05        # int8 against f32: mean |d| (JAX's own limit)
PACK_TOL = 1e-4        # packed fake_B against unpacked, small hole
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


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


def cuda_ms_back_to_back(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time a call when `launches` calls run back to back: one pair
    of CUDA events around them, median of `reps`, in ms.  The device first
    spins ~2 ms so that the host has queued every call before the first
    one starts, and the events see the device's time, not the host's."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(3_500_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
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


def kbar_bound(bsz: int, n: int, ind_bytes: int) -> dict:
    """Least time for the kbar kernel: B*N*N f32 written, and flag, a, b
    (f32) and ind read once.  Operations: two products and a sum an
    element."""
    nbytes = bsz * n * n * 4 + bsz * n * (12 + ind_bytes)
    ops = 3 * bsz * n * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def profile_calls(label: str, calls, card: str) -> dict:
    """Device time by kernel class over `calls` (a list of thunks), with
    torch.profiler, and the device's busy share of the host wall time.
    Returns the ms a call of each class."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    classes = (("scan kernel", ("scan_stream",)),
               ("kbar kernel", ("kbar_build",)),
               ("convolution", ("conv", "cudnn", "xmma", "implicit",
                                "winograd", "fft", "wgrad", "dgrad")),
               ("matmul", ("gemm", "gemv")),
               ("optimiser", ("multi_tensor", "adam")),
               ("collective (NCCL)", ("nccl",)),
               ("copy/fill", ("memcpy", "memset")))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
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
    n = len(calls)
    if total <= 0:
        log(f"profile of {label}: the profiler recorded no device time")
        return {}
    log(f"profile of {n} {label}: device busy {total / wall_us:.1%} of "
        f"wall, {total / n / 1e3:.3f} ms device time each  [{card}]")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"  {cls:18s} {us / n / 1e3:8.3f} ms each  {us / total:6.1%}")
    for us, count, name in sorted(top, reverse=True)[:8]:
        log(f"  top {us / n / 1e3:8.3f} ms each x{count / n:g}: {name}")
    return {cls: us / n / 1e3 for cls, us in by_class.items()}


def write_synthetic_data(root: str, s: int, center, strokes, small) -> dict:
    """Phase 7's data at s px: 48 training images, 48 refs, 16 validation
    images (smooth two-colour gradients with a few flat shapes and a little
    noise, as JPEG), 8 masks (center squares and strokes, as PNG, 255 =
    hole) and the one-mask set of phase 4's small hole."""
    from PIL import Image
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:s, 0:s] / s

    def picture():
        c0, c1 = rng.uniform(0.1, 0.9, (2, 3))
        t = (np.cos(rng.uniform(0, 6.3)) * xx
             + np.sin(rng.uniform(0, 6.3)) * yy + 1.0)[..., None] / 2.0
        img = c0 * (1 - t) + c1 * t
        for _ in range(3):
            cx, cy, r = rng.uniform(0.2, 0.8, 3) * (s, s, 0.3)
            img[(xx * s - cx) ** 2 + (yy * s - cy) ** 2 <= (r * s) ** 2] = \
                rng.uniform(0, 1, 3)
        img += rng.normal(0, 0.02, img.shape)
        return Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))

    def mask_png(m):
        return Image.fromarray(np.repeat(m[..., None] * 255, 3, -1))

    dirs = {}
    for name, n in (("img", 48), ("ref", 48), ("val", 16), ("mask", 8),
                    ("small", 1)):
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name])
        for i in range(n):
            if name == "mask":
                m = center(1)[0] if i % 2 else strokes(1)[0]
                mask_png(m).save(os.path.join(dirs[name], f"m{i}.png"))
            elif name == "small":
                mask_png(small[0]).save(os.path.join(dirs[name], "m.png"))
            else:
                picture().save(os.path.join(dirs[name], f"x{i:03d}.jpg"))
    return dirs


def training_program(dev, card: str, bare_img_s: float, center, strokes,
                     small, n_small: int) -> dict:
    """Phase 7: the training program at full width through its entry
    points: data on disk -> Trainer.fit (2 epochs at B=8, validation,
    visual dump, async checkpoints) -> restore -> resume -> evaluate, and
    evaluation with the kernels against the plain versions.  Returns the
    kernels' launches on the trainer and evaluate paths."""
    import torch
    from deepinpainting_torch.config import Config
    from deepinpainting_torch.data import (BatchIterator, InpaintDataset,
                                           SelfRefDataset)
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.engine.evaluator import evaluate
    from deepinpainting_torch.engine.schedules import lr_for_epoch
    from deepinpainting_torch.engine.state import (NETWORKS, TRAINED,
                                                   current_learning_rate)
    from deepinpainting_torch.engine.trainer import Trainer
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.utils.metrics import psnr, ssim

    os.makedirs(BUILD, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_phase7_", dir=BUILD)
    try:
        s = 256
        t0 = time.perf_counter()
        dirs = write_synthetic_data(root, s, center, strokes, small)
        log(f"phase 7 data: 48 training images, 48 refs, 16 validation "
            f"images, 8 masks at {s} px in {time.perf_counter() - t0:.2f} s")
        cfg = Config(batch_size=TRAIN_BATCH, niter=2, niter_decay=0,
                     save_epoch_freq=1, display_freq=96, metrics_every=3,
                     data_workers=4, checkpoints_dir=root)
        train_ds = InpaintDataset(dirs["img"], dirs["mask"], dirs["ref"], s,
                                  seed=cfg.seed)
        valid_ds = InpaintDataset(dirs["val"], dirs["mask"], dirs["ref"], s,
                                  seed=cfg.seed + 1)

        # epoch -> its wall time (data included), the rate it trained with,
        # how long its first batch kept the first step waiting, and the
        # host's time between step calls
        epochs = {}

        def timed(tr):
            inner_epoch, inner_step = tr.train_epoch, tr.train_step
            calls = []

            def train_step(state, batch, generator):
                calls.append(time.perf_counter())
                return inner_step(state, batch, generator)

            def train_epoch(state, epoch, total_steps):
                lr = current_learning_rate(state)
                torch.cuda.synchronize()
                calls.clear()
                t = time.perf_counter()
                out = inner_epoch(state, epoch, total_steps)
                torch.cuda.synchronize()
                epochs[epoch] = {
                    "s": time.perf_counter() - t, "lr": lr,
                    "first_ms": (calls[0] - t) * 1e3,
                    "gaps_ms": [(b - a) * 1e3
                                for a, b in zip(calls, calls[1:])]}
                return out
            tr.train_step, tr.train_epoch = train_step, train_epoch
            return tr

        # -- train: 2 epochs of 6 steps, 2 validation batches an epoch,
        #    one visual dump (display_freq 96 = the 12th step's images) --
        tr = timed(Trainer(cfg, train_ds, valid_ds, device=dev))
        tr.ckpt.max_to_keep = 2
        TAC.launches = TAC.kbar_launches = 0   # counts: the trainer only
        t0 = time.perf_counter()
        state = tr.fit()
        fit_s = time.perf_counter() - t0
        trainer_launches = {"scan_stream": TAC.launches,
                            "kbar_build": TAC.kbar_launches}
        with open(tr.logger.path) as f:
            rows = list(csv.DictReader(f))
        values = [float(r[k]) for r in rows for k in r if k not in
                  ("step", "time")]
        log(f"phase 7 fit: 2 epochs in {fit_s:.2f} s, state.step="
            f"{state.step}, {len(rows)} metric rows, launches "
            f"{trainer_launches}, checkpoints {tr.ckpt.all_epochs()}, "
            f"last row {rows[-1]}")
        check(len(rows) == 12 and state.step == 12,
              "metrics.csv must hold one row a step, 12 steps")
        check(all(np.isfinite(values)), "every logged metric must be finite")
        check(all(np.isfinite(tr.logger.epoch_valid)),
              "validation losses must be finite")
        check(tr.ckpt.all_epochs() == [1, 2], "checkpoints of epochs 1, 2")
        check(os.path.exists(os.path.join(tr.out_dir, "loss_plot.png")),
              "loss_plot.png")
        check(os.listdir(os.path.join(tr.out_dir, "saveimg"))
              == ["Epoch_(2)_(96).jpg"], "one visual dump")
        check(trainer_launches == {"scan_stream": 12 + 4 + 1,
                                   "kbar_build": 12},
              "scan: 12 train steps + 4 validation batches + 1 visual "
              "dump; kbar: 12 train steps")
        check(epochs[1]["lr"] == cfg.lr
              and epochs[2]["lr"] == lr_for_epoch(cfg, 1)
              and current_learning_rate(state) == lr_for_epoch(cfg, 2),
              "the learning rate after each epoch is lr_for_epoch's")
        save = dict(tr.ckpt.last_save)

        # -- restore epoch 2 into a fresh state: bit for bit --
        fresh = TI.create_state(cfg, torch.Generator().manual_seed(99), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.ckpt.restore(2, fresh, dev)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        same = fresh.step == state.step
        for n in NETWORKS:
            a, b = getattr(state, n).state_dict(), getattr(fresh, n
                                                          ).state_dict()
            same &= set(a) == set(b) and all(torch.equal(a[k], b[k])
                                             for k in a)
        n_opt = 0
        for n in TRAINED:
            pa = list(getattr(state, n).parameters())
            pb = list(getattr(fresh, n).parameters())
            oa, ob = getattr(state, f"opt_{n}"), getattr(fresh, f"opt_{n}")
            for p, q in zip(pa, pb):
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    same &= torch.equal(oa.state[p][k], ob.state[q][k])
                    n_opt += 1
        log(f"phase 7 restore of epoch 2: {restore_ms:.1f} ms, every tensor "
            f"of G, P, D, F and VGG and {n_opt} optimiser tensors bit for "
            f"bit: {same}  [{card}]")
        check(same, "the restored state must equal the trained one")
        del fresh, state

        # -- resume from the latest checkpoint: exactly epoch 3 --
        ran = set(epochs)
        cfg3 = cfg.replace(continue_train=True, which_epoch="latest", niter=3)
        tr3 = timed(Trainer(cfg3, train_ds, valid_ds, device=dev))
        tr3.ckpt.max_to_keep = 2
        state = tr3.fit()
        log(f"phase 7 resume: epochs run {sorted(set(epochs) - ran)}, "
            f"state.step={state.step}, checkpoints {tr3.ckpt.all_epochs()}")
        check(sorted(set(epochs) - ran) == [3] and state.step == 18,
              "the resume must run exactly epoch 3")
        check(epochs[3]["lr"] == lr_for_epoch(cfg, 1)
              and current_learning_rate(state) == lr_for_epoch(cfg3, 3),
              "the resumed rate is the checkpoint's, then lr_for_epoch's")
        check(tr3.ckpt.all_epochs() == [2, 3], "two checkpoints kept")

        # -- evaluate the trained model on the validation images --
        eval_cfg = cfg.replace(is_train=False)
        eval_ds = SelfRefDataset(dirs["val"], dirs["mask"], s)
        TAC.launches = TAC.kbar_launches = 0    # counts: evaluate only
        res = evaluate(eval_cfg, state, eval_ds, device=dev, verbose=False,
                       return_per_image=True)
        eval_launches = {"scan_stream": TAC.launches,
                         "kbar_build": TAC.kbar_launches}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(eval_cfg, state, eval_ds, device=dev, verbose=False)
        eval_img_s = 16 / (time.perf_counter() - t0)
        log(f"phase 7 evaluate: {res['images']} images, PSNR mean "
            f"{res['psnr']:.4f} dB (per image {min(res['psnr_per_image']):.4f}"
            f" to {max(res['psnr_per_image']):.4f}), SSIM mean "
            f"{res['ssim']:.5f} ({min(res['ssim_per_image']):.5f} to "
            f"{max(res['ssim_per_image']):.5f}), launches {eval_launches}"
            f"  [{card}]")
        check(res["images"] == 16 and all(np.isfinite(
            res["psnr_per_image"] + res["ssim_per_image"])),
            "evaluate: 16 finite images")
        check(eval_launches == {"scan_stream": 2, "kbar_build": 0},
              "evaluate: one scan launch a batch, no kbar")

        # -- evaluation, kernels against plain versions, phase 4's hole --
        small_ds = SelfRefDataset(dirs["val"], dirs["small"], s)
        series = {impl: evaluate(eval_cfg.replace(attention_impl=impl), state,
                                 small_ds, device=dev, verbose=False,
                                 return_per_image=True)
                  for impl in ("cuda", "torch")}
        # The limits: fake_B of the two paths may differ by up to
        # E2E_TOL everywhere (phase 4's limit), and a metric m can then move
        # by at most E2E_TOL * ||dm/dfake_B||_1 to first order (Hoelder),
        # doubled for the higher orders; the gradient is taken on the plain
        # path's fake_B of each image.
        eval_step = TI.make_eval_step(eval_cfg.replace(attention_impl="torch"),
                                      dev)
        limits = {"psnr": [], "ssim": []}
        for batch in BatchIterator(small_ds, TRAIN_BATCH, shuffle=False,
                                   drop_last=False, workers=0):
            out = eval_step(state, batch)
            gt = out["visuals"]["real_B"].permute(0, 3, 1, 2).clone()
            for name, fn in (("psnr", psnr), ("ssim", ssim)):
                fb = out["fake_B"].permute(0, 3, 1, 2).clone(
                    ).requires_grad_(True)
                fn(gt, fb).sum().backward()
                limits[name] += (2 * E2E_TOL * fb.grad.abs().sum(
                    dim=(1, 2, 3))).tolist()
        d = {k: [abs(a - b) for a, b in zip(series["cuda"][f"{k}_per_image"],
                                            series["torch"][f"{k}_per_image"])]
             for k in ("psnr", "ssim")}
        log(f"phase 7 evaluate at a {n_small}-position hole, "
            f"kernels vs plain versions: PSNR max|d| {max(d['psnr']):.3e} dB "
            f"(limits {min(limits['psnr']):.3e} to {max(limits['psnr']):.3e}),"
            f" SSIM max|d| {max(d['ssim']):.3e} (limits "
            f"{min(limits['ssim']):.3e} to {max(limits['ssim']):.3e})")
        for k in ("psnr", "ssim"):
            check(all(x <= lim for x, lim in zip(d[k], limits[k])),
                  f"evaluate {k}: kernels vs plain versions beyond the limit")

        # -- numbers --
        e2 = epochs[2]
        log(f"phase 7 trainer epoch 2 (6 steps at B={TRAIN_BATCH}, data "
            f"included, host clock): {e2['s'] * 1e3:.1f} ms, "
            f"{48 / e2['s']:.2f} img/s, against the bare step's "
            f"{bare_img_s:.2f} img/s (phase 5): "
            f"{48 / e2['s'] / bare_img_s:.1%}; epoch 1 "
            f"{epochs[1]['s'] * 1e3:.1f} ms, epoch 3 (resumed) "
            f"{epochs[3]['s'] * 1e3:.1f} ms  [{card}]")
        for ep in (1, 2, 3):
            log(f"phase 7 epoch {ep}: first step called after "
                f"{epochs[ep]['first_ms']:.1f} ms (its batch decoded by one "
                f"loader process), then every " + " / ".join(
                    f"{g:.1f}" for g in epochs[ep]["gaps_ms"]) + " ms")
        log(f"phase 7 checkpoint save (epoch 2, async): blocking "
            f"{save['blocking_ms']:.1f} ms, until in place "
            f"{save['total_ms']:.1f} ms, {save['bytes']} bytes; epoch 3: "
            f"blocking {tr3.ckpt.last_save['blocking_ms']:.1f} ms, until in "
            f"place {tr3.ckpt.last_save['total_ms']:.1f} ms; restore "
            f"{restore_ms:.1f} ms  [{card}]")
        t0 = time.perf_counter()
        n_img = sum(b["image"].shape[0] for ep in (20, 21) for b in
                    BatchIterator(train_ds, TRAIN_BATCH, seed=ep, workers=4))
        log(f"phase 7 loader alone (4 worker processes, warm pool, no "
            f"training): {n_img / (time.perf_counter() - t0):.1f} img/s over "
            f"{n_img} images  [{card}]")
        log(f"phase 7 evaluate: {eval_img_s:.2f} img/s (16 images at B="
            f"{TRAIN_BATCH}, data included, second call)  [{card}]")
        profile_calls("trainer epoch (6 steps at B=8, data included)",
                      [lambda: tr3.train_epoch(state, 4, 0)], card)
        train_ds.close()
        valid_ds.close()
        eval_ds.close()
        small_ds.close()
        return {"trainer": trainer_launches, "evaluate": eval_launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def step_launches(cfg) -> dict:
    """Kernel launches one train step of `cfg` makes: a scan and a kbar for
    each differentiated forward, and once more for each recompute of a
    checkpointed netG level that encloses the attention level (levels
    0-3); with grad_accum k, k such forwards (the G phase) and k more scans
    (the D phase's forwards without a graph)."""
    k = max(1, cfg.grad_accum)
    enclosing = (0 if not cfg.remat else 4 if cfg.remat_depth == 0
                 else min(cfg.remat_depth, 4))
    builds = k * (1 + enclosing)
    return {"scan_stream": builds + (k if k > 1 else 0), "kbar_build": builds}


def precision_and_memory(dev, card: str, base, models256, phase6: dict,
                         small_px: int = 24, serve_requests: int = 32,
                         kernel_batches=(1, 8)) -> dict:
    """Phase 8: the precision and memory options at `base`'s size (512 px,
    full width, batch 8 on the card) through create_state /
    make_train_step: (a) bf16 with remat at depth 1, (b) the f32 baseline
    without remat, (c) f32 with grad_accum=2; (d) the first step of (a)
    with the kernels against the plain versions at a hole of at most 9
    positions, and the recompute's kbar against the forward's; (e) bf16
    serving through InferenceSession at 256 px (with phase 3's weights)
    and at base's size; (f) both kernels at N = (size/8)^2 at the center
    hole.  Returns the launches of each path and the kernels' times."""
    import torch
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.ops import attention as TA
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.serve.app import InferenceSession

    s, b = base.fine_size, base.batch_size
    rng = np.random.default_rng(8)

    def center(n, size=s):
        m = np.zeros((n, size, size), np.uint8)
        lo, hi = size // 4 + base.overlap, 3 * size // 4 - base.overlap
        m[:, lo:hi, lo:hi] = 1
        return m

    def image(n, size=s):
        return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)

    def batch(mask):
        return {"image": image(b), "ref": image(b), "mask": mask}

    batches = [batch(center(b)) for _ in range(3)]

    def counts():
        return {"scan_stream": TAC.launches,
                "kbar_build": TAC.kbar_launches}

    def train(label, cfg, n_steps):
        """n_steps steps from fresh weights (seed 0): ms a step (host clock
        ending in synchronize(), median after the first), peak allocated
        memory, launches (checked against step_launches)."""
        state = TI.create_state(cfg, torch.Generator().manual_seed(cfg.seed),
                                dev)
        step = TI.make_train_step(cfg, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        TAC.launches = TAC.kbar_launches = 0   # counts: this path only
        ms = []
        for i in range(n_steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            values = {k: v.item() for k, v in metrics.items()}
            check(all(np.isfinite(v) for v in values.values())
                  and all(v.dtype == torch.float32 for v in metrics.values()),
                  f"{label} step {i + 1}: metrics must be finite f32")
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        want = {k: v * n_steps for k, v in step_launches(cfg).items()}
        steady = statistics.median(ms[1:]) if n_steps > 1 else ms[0]
        log(f"phase 8 {label}: {s} px B={b}, {n_steps} steps, "
            f"{steady:.1f} ms a step (median after the first; steps "
            + " / ".join(f"{x:.1f}" for x in ms) + f" ms), "
            f"{b / steady * 1e3:.2f} img/s, peak allocated "
            f"{peak / 2 ** 30:.2f} GiB ({peak} B), launches {launches} "
            f"(expected {want}), last metrics {values}  [{card}]")
        check(launches == want, f"{label}: launches {launches} != {want}")
        return state, step, {"ms": steady, "peak": peak,
                             "launches": launches}

    paths, results = {}, {}
    # ---- (a) the 512 px training configuration: bf16, remat depth 1 ----
    cfg_a = base.replace(dtype="bfloat16", remat=True, remat_depth=1)
    state, step, results["a"] = train("(a) bf16 remat depth 1", cfg_a, 3)
    paths["train512_bf16_remat"] = results["a"]["launches"]
    # the recompute's kbar against the forward's, outside the counts
    kbars, core = [], TA.attention_core_batched

    def spy(*a, **kw):
        out, kbar = core(*a, **kw)
        kbars.append(kbar)
        return out, kbar

    TA.attention_core_batched = spy
    try:
        step(state, batches[0])
    finally:
        TA.attention_core_batched = core
    torch.cuda.synchronize()
    same = len(kbars) == 2 and torch.equal(kbars[0], kbars[1])
    log(f"phase 8 (a) recompute: {len(kbars)} kbar builds in a step, the "
        f"recompute's equal to the forward's bit for bit: {same}")
    check(same, "the recompute must build the forward's kbar bit for bit")
    del kbars
    profile_calls(f"train steps at {s} px, B={b}, bf16, remat depth 1",
                  [lambda: step(state, batches[1])], card)
    del state, step
    torch.cuda.empty_cache()

    # ---- (b) the f32 baseline, no remat ----
    cfg_b = base.replace(dtype="float32", remat=False)
    state, step, results["b"] = train("(b) f32, no remat", cfg_b, 3)
    paths["train512_f32"] = results["b"]["launches"]
    profile_calls(f"train steps at {s} px, B={b}, f32",
                  [lambda: step(state, batches[1])], card)
    del state, step
    torch.cuda.empty_cache()

    # ---- (c) f32 with grad_accum=2 ----
    cfg_c = base.replace(dtype="float32", grad_accum=2)
    state, step, results["c"] = train("(c) f32, grad_accum 2", cfg_c, 2)
    paths["train512_accum2"] = results["c"]["launches"]
    del state, step
    torch.cuda.empty_cache()
    ra, rb = results["a"], results["b"]
    log(f"phase 8 (a) against (b): {ra['ms'] / rb['ms']:.3f} of the time, "
        f"{ra['peak'] / rb['peak']:.3f} of the peak memory  [{card}]")

    # ---- (d) (a)'s first step, kernels against plain versions ----
    small = np.zeros((b, s, s), np.uint8)
    y0, x0 = 3 * s // 8, 7 * s // 32
    small[:, y0:y0 + small_px, x0:x0 + small_px] = 1
    n_small = int(TI.prepare_masks(base, torch.from_numpy(small[:1]).float()
                                   )[1].sum().item())
    check(1 <= n_small <= 9, f"small hole has {n_small} masked positions")
    small_batch = batch(small)
    losses = {}
    for impl in ("cuda", "torch"):
        icfg = cfg_a.replace(attention_impl=impl)
        fresh = TI.create_state(icfg, torch.Generator().manual_seed(0), dev)
        _, m = TI.make_train_step(icfg, dev)(fresh, small_batch)
        losses[impl] = {k: v.item() for k, v in m.items()}
        del fresh
    torch.cuda.empty_cache()
    d_step = max(abs(losses["cuda"][k] - losses["torch"][k])
                 / max(abs(losses["torch"][k]), 1e-12) for k in losses["cuda"])
    log(f"phase 8 (d) first bf16 remat step at a {n_small}-position hole, "
        f"kernels vs plain versions: max relative loss difference "
        f"{d_step:.3e} (limit {STEP_TOL}); kernels {losses['cuda']}")
    check(d_step <= STEP_TOL, "bf16 remat step, kernels vs plain versions")

    # ---- (e) bf16 serving ----
    serving = {}
    for size, models in ((256, models256), (s, None)):
        scfg = base.replace(fine_size=size, dtype="bfloat16", batch_size=1)
        if models is None:
            models = TI.init_params(scfg, torch.Generator().manual_seed(0),
                                    dev)
        single = InferenceSession(scfg, state=models, device=dev)
        batched = InferenceSession(scfg, state=models, device=dev,
                                   max_batch=8, batch_wait_ms=50.0)
        f32 = InferenceSession(scfg.replace(dtype="float32"), state=models,
                               device=dev)
        req = (image(1, size), center(1, size), image(1, size))
        single.run(*req)
        TAC.launches = TAC.kbar_launches = 0  # counts: bf16 serving only
        lat = []
        for i in range(11 if size == s else 21):
            t0 = time.perf_counter()
            out = single.run(image(1, size), center(1, size), image(1, size))
            lat.append((time.perf_counter() - t0) * 1e3)
            check(out.dtype == np.uint8 and out.shape == (1, size, size, 3)
                  and out.std() > 0, "bf16 serving: uint8, not constant")
        n_req = serve_requests if size == 256 else serve_requests // 2
        reqs = [(image(1, size), center(1, size), image(1, size))
                for _ in range(n_req)]
        results_ = [None] * n_req
        calls0 = batched.calls

        def client(k):
            for i in range(k, n_req, 8):
                results_[i] = batched.run(*reqs[i])

        t0 = time.perf_counter()
        ws = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in ws:
            t.start()
        for t in ws:
            t.join(600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = counts()
        forwards = len(lat) + batched.calls - calls0
        check(not any(t.is_alive() for t in ws)
              and all(r is not None and r.shape == (1, size, size, 3)
                      for r in results_), "bf16 batched requests")
        check(launches == {"scan_stream": forwards, "kbar_build": 0},
              "bf16 serving: one scan launch a netG forward, no kbar")
        d = np.abs(single.run(*req).astype(np.int16)
                   - f32.run(*req).astype(np.int16))
        p50 = statistics.median(lat[1:])
        serving[size] = {"p50": p50, "img_s": n_req / wall,
                         "launches": launches}
        ref6 = (f"; phase 6 f32: b1 p50 {phase6['p50']:.2f} ms, b8 "
                f"{phase6['img_s']:.2f} img/s" if size == 256 else "")
        log(f"phase 8 (e) bf16 serving {size} px: b1 request p50 "
            f"{p50:.2f} ms ({len(lat) - 1} requests), b8 throughput "
            f"{n_req / wall:.2f} img/s ({n_req} requests over 8 clients, "
            f"{batched.calls - calls0} batched calls), launches {launches}; "
            f"uint8 result against f32 serving: mean |d| {d.mean():.3f}, "
            f"max {d.max()} levels{ref6}  [{card}]")
        if size == 256:
            profile_calls(f"bf16 b1 requests at {size} px",
                          [lambda: single.run(*req) for _ in range(5)], card)
        for sess in (single, batched, f32):
            sess.close()
        paths[f"serving_bf16_{size}"] = launches
        del models
    torch.cuda.empty_cache()

    # ---- (f) both kernels at N = (s/8)^2, center hole ----
    side = s // 8
    cflag = TI.prepare_masks(base, torch.from_numpy(center(1)).float())[1]
    timings = {}
    for kb in kernel_batches:
        crng = np.random.default_rng(40 + kb)
        feat = torch.from_numpy(crng.standard_normal(
            (kb, side * side, SCAN_C)).astype(np.float32)).to(dev)
        refr = torch.from_numpy(np.abs(crng.standard_normal(
            (kb, side * side, SCAN_C))).astype(np.float32)).to(dev)
        flag = cflag.to(dev).expand(kb, -1).contiguous()
        _, pn, ind, vmax, known = TA.prep(feat, refr, flag, True)
        args = (flag, vmax.contiguous(), pn.contiguous(), known.contiguous())
        bound = scan_bound(flag, SCAN_C)
        scan = lambda: TAC.scan_stream_cuda(*args)
        row = {"scan_stream": dict(
            ms=cuda_ms_back_to_back(scan), single_ms=cuda_ms(scan, reps=30),
            plain_ms=cuda_ms(lambda: TA.scan_stream_reference(*args),
                             reps=3, warmup=1), **bound)}
        _, ka, kb_ = scan()
        kargs = (flag, ind.contiguous(), ka, kb_)
        build = lambda: TAC.kbar_build_cuda(*kargs)
        row["kbar_build"] = dict(
            ms=cuda_ms_back_to_back(build), single_ms=cuda_ms(build, reps=30),
            plain_ms=cuda_ms(lambda: TA.kbar_build_reference(*kargs),
                             reps=3, warmup=1),
            **kbar_bound(kb, side * side, ind.element_size()))
        timings[kb] = row
        m = bound["masked"] // kb
        for name, t in row.items():
            log(f"phase 8 (f) {name} B={kb} N={side * side} C={SCAN_C} "
                f"center hole ({m} masked rows a sample): kernel "
                f"{t['single_ms']:.4f} ms single launch, {t['ms']:.4f} ms a "
                f"launch back to back, plain {t['plain_ms']:.2f} ms, bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_by']}: {t['bytes']} B, "
                f"{t['ops']} ops), share {t['bound_ms'] / t['ms']:.2%} (back "
                f"to back)" + (f", {t['ms'] / m * 1e6:.1f} ns a masked step"
                               if name == "scan_stream" else "")
                + f", library call: none  [{card}]")
        del feat, refr, flag, pn, ind, vmax, known, args, kargs, ka, kb_
    torch.cuda.empty_cache()
    return {"paths": paths, "timings": timings, "train": results,
            "serving": serving}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's default algorithm for a transposed convolution (its
    data-gradient kernel) sums with atomics, so two calls on the same
    inputs may differ in the last bit of fake_B and by 1 in a uint8 pixel.
    The comparisons that phase 9 holds bit for bit run with cuDNN's
    deterministic algorithms only; its timings run with the defaults."""
    import torch
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def serving_requests(s: int, overlap: int, n: int = 4, seed: int = 9):
    """n uint8 requests at s px: center holes and, in turn, two bars."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mask = np.zeros((1, s, s), np.uint8)
        if i % 2:
            mask[:, s // 3:s // 3 + 12, s // 8:7 * s // 8] = 1
            mask[:, s // 8:7 * s // 8, 2 * s // 3:2 * s // 3 + 12] = 1
        else:
            mask[:, s // 4 + overlap:3 * s // 4 - overlap,
                 s // 4 + overlap:3 * s // 4 - overlap] = 1
        img, ref = rng.integers(0, 256, (2, 1, s, s, 3), dtype=np.uint8)
        out.append((img, mask, ref))
    return out


def encode(arr: np.ndarray, fmt: str) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt)
    return buf.getvalue()


def wsgi_call(app, method: str, path: str, body: bytes = b"",
              content_type: str = ""):
    """One request through the WSGI interface: (status, headers, body)."""
    got = {}

    def start_response(status, headers):
        got["status"], got["headers"] = status, dict(headers)

    out = b"".join(app({"REQUEST_METHOD": method, "PATH_INFO": path,
                        "CONTENT_LENGTH": str(len(body)),
                        "CONTENT_TYPE": content_type,
                        "wsgi.input": io.BytesIO(body)}, start_response))
    return got["status"], got["headers"], out


def concurrent_img_s(run, jobs, clients: int = 8) -> float:
    """Images a second when `clients` threads share `jobs` (thunks)."""
    errors = []

    def client(k):
        try:
            for job in jobs[k::clients]:
                job()
        except Exception as e:          # raised below, in the caller
            errors.append(e)

    t0 = time.perf_counter()
    ws = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for t in ws:
        t.start()
    for t in ws:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in ws),
          f"concurrent {run}: {errors[:1]}")
    return len(jobs) / wall


def serving_program(dev, card: str, p9_cfg, epoch: int, requests, live,
                    n_http: int = 20, n_b8: int = 32) -> dict:
    """Phase 9: the serving program at full width, 256 px.  (a) the
    session restored from phase 5's checkpoint against phase 3's session
    on the same requests; (b) InpaintApp in process (uploads, run_bytes,
    HTTP p50 and b8, one POST over a real socket); (c) the artifact:
    export, load, the loaded call against the live one at batches 1, 3, 8
    and 9, and InferenceSession.from_export.  Returns each path's
    launches."""
    import torch
    from PIL import Image
    from deepinpainting_torch.engine import export_model as EM
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.serve.app import (InferenceSession,
                                                encode_multipart,
                                                make_app,
                                                parse_multipart,
                                                post_over_socket)

    s = p9_cfg.fine_size
    counts = lambda: {"scan_stream": TAC.launches,
                      "kbar_build": TAC.kbar_launches}
    paths = {}

    # ---- (a) the session restored from the checkpoint ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = InferenceSession(p9_cfg, epoch, device=dev)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    TAC.launches = TAC.kbar_launches = 0   # counts: the restored session
    with deterministic_cudnn():
        answers = [sess.run(*r) for r in requests]
    paths["serving_restored"] = counts()
    same = all(np.array_equal(a, b) for a, b in zip(answers, live))
    log(f"phase 9 (a) InferenceSession(cfg, which_epoch={epoch}): restored "
        f"G, P and VGG in {restore_ms:.1f} ms; {len(requests)} answers equal"
        f" phase 3's session over the trained networks bit for bit: {same}; "
        f"launches {paths['serving_restored']}  [{card}]")
    check(same, "the restored session must answer as the live one")
    check(paths["serving_restored"] == {"scan_stream": len(requests),
                                        "kbar_build": 0},
          "restored session: one scan launch a request, no kbar")

    # ---- (b) InpaintApp in process, then over a socket ----
    static = os.path.join(p9_cfg.checkpoints_dir, "static")
    app = make_app(p9_cfg, epoch, static, device=dev)
    rng = np.random.default_rng(19)
    uploads = []
    for i, (fmt, h, w) in enumerate((("JPEG", s, s), ("PNG", 300, 200),
                                     ("JPEG", 180, 240))):
        img, ref = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
        hole = np.zeros((h, w, 3), np.uint8)
        hole[h // 4:h // 2 + 8 * i, w // 3:2 * w // 3] = 255
        uploads.append({"srcImage": encode(img, fmt),
                        "binaryMask": encode(hole, "PNG"),
                        "refImage": encode(ref, fmt)})
    dec = lambda b: np.array(Image.open(io.BytesIO(b)).convert("RGB").resize(
        (s, s), Image.BILINEAR), np.uint8)
    for fields in uploads:
        status, headers, _ = wsgi_call(app, "POST", "/getImage",
                                       *encode_multipart(fields))
        check(status == "302 Found" and headers["Location"] == "/result",
              f"POST /getImage: {status} {headers}")
        status, _, page = wsgi_call(app, "GET", "/result")
        check(status == "200 OK" and b"/static/img/test.jpg" in page,
              f"GET /result: {status}")
        status, headers, jpg = wsgi_call(app, "GET", "/static/img/test.jpg")
        check(status == "200 OK" and headers["Content-Type"] == "image/jpeg"
              and Image.open(io.BytesIO(jpg)).size == (s, s),
              "the result must decode to the served size")
        hole = (dec(fields["binaryMask"])[..., 0] > 0).astype(np.uint8)
        with deterministic_cudnn():
            want = app.session.run(dec(fields["srcImage"])[None],
                                   hole[None], dec(fields["refImage"])[None])[0]
            got = app.session.run_bytes(fields["srcImage"],
                                        fields["binaryMask"],
                                        fields["refImage"])
        check(np.array_equal(got, want),
              "run_bytes must equal run on the decoded arrays")
    body = encode_multipart(uploads[0])
    TAC.launches = TAC.kbar_launches = 0   # counts: the HTTP requests
    lat = []
    for _ in range(n_http):
        t0 = time.perf_counter()
        status, _, _ = wsgi_call(app, "POST", "/getImage", *body)
        lat.append((time.perf_counter() - t0) * 1e3)
        check(status == "302 Found", f"POST /getImage: {status}")
    paths["http"] = counts()
    http_p50 = statistics.median(lat)
    # the same request's host work alone, no device call: multipart parse,
    # decode and resize of the three uploads, the mask, one JPEG encode
    host = []
    for _ in range(n_http):
        t0 = time.perf_counter()
        fields = parse_multipart(body[1], body[0])
        _ = (dec(fields["binaryMask"])[..., 0] > 0, dec(fields["refImage"]))
        Image.fromarray(dec(fields["srcImage"])).save(io.BytesIO(), "JPEG")
        host.append((time.perf_counter() - t0) * 1e3)
    host_p50 = statistics.median(host)
    check(paths["http"] == {"scan_stream": n_http, "kbar_build": 0},
          "HTTP: one scan launch a request, no kbar")
    app8 = make_app(p9_cfg, None, static, state=app.session.state,
                    max_batch=8, batch_wait_ms=50.0, device=dev)
    posts = [encode_multipart(uploads[i % 3]) for i in range(n_b8)]
    calls0 = app8.session.calls
    TAC.launches = TAC.kbar_launches = 0   # counts: HTTP with coalescing
    http_b8 = concurrent_img_s("HTTP POSTs", [
        lambda b=b: check(wsgi_call(app8, "POST", "/getImage", *b)[0]
                          == "302 Found", "coalesced POST") for b in posts])
    paths["http_b8"] = counts()
    check(paths["http_b8"]["scan_stream"] == app8.session.calls - calls0
          and paths["http_b8"]["kbar_build"] == 0,
          "coalesced HTTP: one scan launch a batched call")
    log(f"phase 9 (b) InpaintApp: 3 uploads (JPEG {s}x{s}, PNG 200x300, "
        f"JPEG 240x180) -> 302, /result 200, test.jpg {s}x{s}; run_bytes "
        f"equals run on the decoded arrays bit for bit; HTTP POST p50 "
        f"{http_p50:.2f} ms over {n_http} (decode, infer, JPEG encode; "
        f"the host work alone p50 {host_p50:.2f} ms; "
        f"{paths['http']['scan_stream'] / n_http:g} scan launches a "
        f"request), b8 {http_b8:.2f} img/s ({n_b8} POSTs over 8 clients, "
        f"{app8.session.calls - calls0} batched calls)  [{card}]")
    app8.session.close()
    status, location, ms, jpg = post_over_socket(app, uploads[0])
    log(f"phase 9 (b) ThreadingWSGIServer on 127.0.0.1: POST /getImage -> "
        f"{status} {location} in {ms:.1f} ms, result {len(jpg)} bytes")
    check(status == 302 and location == "/result"
          and Image.open(io.BytesIO(jpg)).size == (s, s),
          "a POST over a real socket")

    # ---- (c) the serving artifact ----
    art = os.path.join(p9_cfg.checkpoints_dir, "artifact")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    EM.export_serving(p9_cfg, sess.state, art, device=dev)
    export_s = time.perf_counter() - t0
    files = {f: os.path.getsize(os.path.join(art, f))
             for f in sorted(os.listdir(art))}
    t0 = time.perf_counter()
    loaded = EM.load_serving(art, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ops = EM.graph_ops(next(iter(loaded.exported.values())))
    log(f"phase 9 (c) export_serving: {export_s:.2f} s, batch "
        f"{loaded.batch}, {sum(files.values())} bytes ({files}); "
        f"load_serving: {load_s:.2f} s; the graph calls "
        f"{sorted(op for op in ops if 'deepinpainting' in op)}  [{card}]")
    check(f"{EM.SCAN_OP}.default" in ops and not any(
        EM.KBAR_OP in op for op in ops),
        "the graph must call the scan op and not the kbar op")
    live_fn = TI.make_serving_fn(sess.cfg, dev)
    if loaded.batch != "symbolic":   # the live call on the same pieces
        live_fn = EM._make_fixed_dispatch({n: live_fn for n in loaded.batch})
    sizes = (1, 3, 8, 9)
    batches = {b: [np.concatenate(x) for x in zip(*(
        requests[i % len(requests)] for i in range(b)))] for b in sizes}
    want = {}
    for b, batch in batches.items():
        with deterministic_cudnn():
            want[b] = live_fn(*sess.state, *batch)
        # with cuDNN's default algorithms, for the record
        d = (loaded.call(loaded.G, loaded.P, loaded.vgg, *batch).int()
             - live_fn(*sess.state, *batch).int()).abs()
        log(f"phase 9 (c) loaded call at B={b} against live make_serving_fn"
            f", default cuDNN: max |d| {d.max().item()}, "
            f"{int((d > 0).sum().item())} of {d.numel()} values differ")
    # one graph call a batch if symbolic, else one a pad-and-chunk piece
    chunks = lambda n: 1 if loaded.batch == "symbolic" else (
        n + max(loaded.batch) - 1) // max(loaded.batch)
    torch.cuda.synchronize()
    TAC.launches = TAC.kbar_launches = 0   # counts: the loaded calls only
    with deterministic_cudnn():
        got = {b: loaded.call(loaded.G, loaded.P, loaded.vgg, *batch)
               for b, batch in batches.items()}
        torch.cuda.synchronize()
    paths["exported"] = counts()
    unequal = [b for b in sizes if not torch.equal(got[b], want[b])]
    log(f"phase 9 (c) loaded call at B = {sizes} against live "
        f"make_serving_fn, deterministic cuDNN: bit for bit at every B: "
        f"{not unequal}; launches {paths['exported']}")
    check(not unequal, f"loaded call vs live at B={unequal}")
    check(paths["exported"] == {"scan_stream": sum(map(chunks, sizes)),
                                "kbar_build": 0},
          "the loaded call: one scan launch a graph call, no kbar")
    del loaded
    single = InferenceSession.from_export(art, device=dev)
    batched = InferenceSession.from_export(art, max_batch=8,
                                           batch_wait_ms=50.0, device=dev)
    single.warmup()
    TAC.launches = TAC.kbar_launches = 0   # counts: from_export serving
    lat = []
    for i in range(n_http + 1):
        t0 = time.perf_counter()
        single.run(*requests[i % len(requests)])
        lat.append((time.perf_counter() - t0) * 1e3)
    calls0 = batched.calls
    b8 = concurrent_img_s("from_export requests", [
        lambda r=requests[i % len(requests)]: batched.run(*r)
        for i in range(n_b8)])
    torch.cuda.synchronize()
    paths["from_export"] = counts()
    forwards = single.calls - 1 + batched.calls - calls0
    check(paths["from_export"] == {"scan_stream": forwards, "kbar_build": 0},
          "from_export: one scan launch a graph call, no kbar")
    p50 = statistics.median(lat[1:])
    log(f"phase 9 (c) InferenceSession.from_export: b1 p50 {p50:.2f} ms "
        f"({n_http} requests), b8 {b8:.2f} img/s ({n_b8} requests over 8 "
        f"clients, {batched.calls - calls0} batched calls), launches "
        f"{paths['from_export']}  [{card}]")
    for x in (single, batched, sess, app.session):
        x.close()
    return paths


@contextlib.contextmanager
def int8_in(net):
    """Within the block, `net`'s forward runs under the int8 conv mode
    alone (whatever mode its caller entered)."""
    from deepinpainting_torch.ops import convs as TC
    forward = net.forward

    def int8_forward(*args, **kwargs):
        with TC.use_modes(TC.ConvModes(int8=True)):
            return forward(*args, **kwargs)

    net.forward = int8_forward
    try:
        yield
    finally:
        del net.forward


def int8_conv_shapes(models, cfg, dev, request) -> list:
    """Every distinct int8-eligible conv of one int8 serving forward of
    `models` at cfg's size: [(label, module, kind, (C, H, W) of its
    input)], in the order the forward meets them."""
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.ops import convs as TC
    from deepinpainting_torch.ops import quant as TQ
    seen, hooks = {}, []

    def hook_for(net_name):
        def hook(mod, args):
            kind = ("deconv" if isinstance(mod, TC.ConvTranspose2d)
                    else "conv")
            w = mod.weight
            cin, cout = w.shape[:2] if kind == "deconv" else w.shape[1::-1]
            if not TQ.eligible(cin, cout):
                return
            k, st, p, d = (w.shape[2], mod.stride[0], mod.padding[0],
                           mod.dilation[0])
            shape = tuple(args[0].shape[1:])
            key = (kind, cin, cout, k, st, p, d, shape)
            label = (f"{net_name} {kind} k{k}s{st}p{p}" + (f"d{d}" if d > 1
                                                           else "")
                     + f" {cin}->{cout} @{shape[1]}x{shape[2]}")
            seen.setdefault(key, (label, mod, kind, shape))
        return hook

    for name, net in zip(("VGG", "netP", "netG"), (models.vgg, models.P,
                                                   models.G)):
        for m in net.modules():
            if isinstance(m, (TC.Conv2d, TC.ConvTranspose2d)):
                hooks.append(m.register_forward_pre_hook(hook_for(name)))
    try:
        TI.make_serving_fn(cfg.replace(quant="int8"), dev)(models.G,
                                                           models.P,
                                                           models.vgg,
                                                           *request)
    finally:
        for h in hooks:
            h.remove()
    order = {"VGG": 0, "netP": 1, "netG": 2}
    return sorted(seen.values(), key=lambda v: order[v[0].split()[0]])


def conv_knobs(dev, card: str, p9_cfg, epoch: int, tcfg, small,
               small_batch, unpacked_losses: dict, train_batches,
               phase6: dict, n_b1: int = 20, n_b8: int = 32,
               reps: int = 10) -> dict:
    """Phase 10: the conv knobs (int8, pack_small_cin, pack_out) at
    p9_cfg's size, full width, on phase 5's trained weights (epoch
    `epoch` of p9_cfg's checkpoint).  (a) int8 per conv shape; (b) int8
    serving; (c) the int8 artifact; (d) the pack modes, serving and
    training.  Returns each path's launches and the figures."""
    import torch
    import torch.nn.functional as F
    from deepinpainting_torch.config import Config
    from deepinpainting_torch.engine import export_model as EM
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.ops import attention as TA
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.ops import masks as TM
    from deepinpainting_torch.ops import quant as TQ
    from deepinpainting_torch.serve.app import InferenceSession
    from deepinpainting_torch.utils.metrics import psnr

    s = p9_cfg.fine_size
    q_cfg = p9_cfg.replace(quant="int8")
    pk_cfg = p9_cfg.replace(pack_small_cin=True, pack_out=True)
    counts = lambda: {"scan_stream": TAC.launches,
                      "kbar_build": TAC.kbar_launches}
    paths, figures = {}, {}
    rng = np.random.default_rng(10)
    gen = torch.Generator(device=dev).manual_seed(10)

    def image(b=1):
        return rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)

    def center(b=1):
        m = np.zeros((b, s, s), np.uint8)
        lo, hi = s // 4 + p9_cfg.overlap, 3 * s // 4 - p9_cfg.overlap
        m[:, lo:hi, lo:hi] = 1
        return m

    def stroke():
        return TM.random_stroke_mask(gen, s).to(torch.uint8).cpu().numpy(
            )[None]

    def requests(n):
        return [(image(), center() if i % 2 else stroke(), image())
                for i in range(n)]

    f32 = InferenceSession(p9_cfg, epoch, device=dev)
    models = f32.state

    # ---- (a) int8 per conv shape, B=1 and B=8 ----
    t0 = time.perf_counter()
    shapes = int8_conv_shapes(models, p9_cfg, dev, requests(1)[0])
    totals = {b: {"int8": 0.0, "f32": 0.0, "bf16": 0.0} for b in (1, 8)}
    rows = []
    for label, mod, kind, (c, h, w) in shapes:
        weight, bias = mod.weight.detach(), mod.bias
        bias = None if bias is None else bias.detach()
        st, p, d = mod.stride[0], mod.padding[0], mod.dilation[0]
        if kind == "conv":
            fast = lambda a, q: TQ.conv2d_int32(a, q, st, p, d)
            plain = lambda a, q: TQ.conv2d_int32_reference(a, q, st, p, d)
            int8 = lambda x: TQ.conv2d_int8(x, weight, bias, st, p, d)
            lib = lambda x, wt, bs: F.conv2d(x, wt, bs, st, p, d)
        else:
            fast = lambda a, q: TQ.conv_transpose2d_int32(a, q, st, p)
            plain = lambda a, q: TQ.conv_transpose2d_int32_reference(
                a, q, st, p)
            int8 = lambda x: TQ.conv_transpose2d_int8(x, weight, bias, st, p)
            lib = lambda x, wt, bs: F.conv_transpose2d(x, wt, bs, st, p)
        row = {"label": label}
        for b in (1, 8):
            x = torch.randn((b, c, h, w), device=dev,
                            generator=gen).relu_()
            xq, _ = TQ.quantize_activation(x)
            wq, _ = TQ.quantize_weight(weight, transposed=kind == "deconv")
            got, want = fast(xq, wq), plain(xq, wq)
            same = bool(torch.equal(got, want))
            check(same, f"(a) {label} B={b}: int32 sums vs plain version")
            xb, wb = x.bfloat16(), weight.bfloat16()
            bb = None if bias is None else bias.bfloat16()
            t = {"int8": cuda_ms(lambda: int8(x), reps),
                 "f32": cuda_ms(lambda: lib(x, weight, bias), reps),
                 "bf16": cuda_ms(lambda: lib(xb, wb, bb), reps)}
            for k, v in t.items():
                totals[b][k] += v
            row[b] = t
            row[f"rows{b}"] = got.shape[0] * got.shape[2] * got.shape[3]
            del x, xq, wq, got, want, xb, wb
        rows.append(row)
        log(f"phase 10 (a) {label}: int32 sums bit for bit with the plain "
            f"version at B=1 ({row['rows1']} rows) and B=8; ms B=1 int8 "
            f"{row[1]['int8']:.4f} f32 {row[1]['f32']:.4f} bf16 "
            f"{row[1]['bf16']:.4f}; B=8 int8 {row[8]['int8']:.4f} f32 "
            f"{row[8]['f32']:.4f} bf16 {row[8]['bf16']:.4f}")
    check(any(r["rows1"] <= 16 for r in rows),
          "(a) a conv with at most 16 output rows (the padded M)")
    for b in (1, 8):
        tb = totals[b]
        log(f"phase 10 (a) sum over the {len(rows)} shapes at B={b}: int8 "
            f"{tb['int8']:.3f} ms, f32 cuDNN {tb['f32']:.3f} ms, bf16 "
            f"cuDNN {tb['bf16']:.3f} ms (medians of {reps} single calls; "
            f"int8 {tb['int8'] / tb['f32']:.3f} of f32, "
            f"{tb['int8'] / tb['bf16']:.3f} of bf16)  [{card}]")
    figures["a"] = {"shapes": len(rows), "totals": totals,
                    "s": time.perf_counter() - t0}
    torch.cuda.empty_cache()

    # ---- (b) int8 serving ----
    def serve(label, cfg_):
        """b1 p50 over n_b1 requests and b8 img/s over n_b8, with the
        launches of exactly those requests."""
        single = InferenceSession(cfg_, state=models, device=dev)
        batched = InferenceSession(cfg_, state=models, device=dev,
                                   max_batch=8, batch_wait_ms=50.0)
        single.run(*requests(1)[0])
        reqs, jobs = requests(n_b1 + 1), requests(n_b8)
        torch.cuda.synchronize()
        calls0 = single.calls, batched.calls
        TAC.launches = TAC.kbar_launches = 0   # counts: this path only
        lat = []
        for r in reqs:
            t0 = time.perf_counter()
            out = single.run(*r)
            lat.append((time.perf_counter() - t0) * 1e3)
            check(out.dtype == np.uint8 and out.shape == (1, s, s, 3)
                  and out.std() > 0, f"{label}: uint8, not constant")
        img_s = concurrent_img_s(f"{label} requests", [
            lambda r=r: batched.run(*r) for r in jobs])
        torch.cuda.synchronize()
        launches = counts()
        forwards = (single.calls - calls0[0]) + (batched.calls - calls0[1])
        check(launches == {"scan_stream": forwards, "kbar_build": 0},
              f"{label}: one scan launch a netG forward, no kbar")
        for x in (single, batched):
            x.close()
        p50 = statistics.median(lat[1:])
        log(f"phase 10 {label}: b1 request p50 {p50:.2f} ms ({n_b1} "
            f"requests), b8 {img_s:.2f} img/s ({n_b8} requests over 8 "
            f"clients, {batched.calls - calls0[1]} batched calls), launches "
            f"{launches}; phase 6 f32 in this run: b1 p50 "
            f"{phase6['p50']:.2f} ms, b8 {phase6['img_s']:.2f} img/s  "
            f"[{card}]")
        return {"p50": p50, "img_s": img_s}, launches

    figures["b"], paths["serving_int8"] = serve("(b) int8 serving", q_cfg)
    # int8 against f32 on the same weights.  With the default
    # faithful_known_replacement every position of netG's attention level
    # takes its best-matching reference patch, an argmax over near-equal
    # scores of untrained features that any rounding can flip, so fake_B's
    # gap is printed beside bf16's own, with known replacement off at the
    # small hole, and with int8 in one network at a time.  JAX's limit is
    # held on fake_P (netP has no attention) and in the setting of the JAX
    # package's own test (tests/test_quant.py:95-120: the tiny config,
    # fresh weights, uniform images, the centre quarter; 64 px here, the
    # port's smallest size).
    batch = [np.concatenate(x) for x in zip(*requests(8))]
    out = {name: TI.make_inference_fn(c, dev)(*models, *batch)
           for name, c in (("f32", p9_cfg), ("int8", q_cfg),
                           ("bf16", p9_cfg.replace(dtype="bfloat16")))}
    check(all(bool(torch.isfinite(t).all()) for t in out["int8"]),
          "int8 fake_B and fake_P must be finite")
    gap = lambda a, b: (a - b).abs().mean().item()
    per_net = {}
    for name in ("vgg", "P", "G"):
        with int8_in(getattr(models, name)):
            per_net[name] = gap(TI.make_inference_fn(p9_cfg, dev)(
                *models, *batch)[0], out["f32"][0])
    gt, ref = image(), image()
    no_kr = lambda c: TI.make_inference_fn(
        c.replace(faithful_known_replacement=False), dev)(
            *models, gt, small, ref)[0]
    small_f32 = no_kr(p9_cfg)
    match = psnr(out["f32"][0].permute(0, 3, 1, 2),
                 out["int8"][0].permute(0, 3, 1, 2))
    tiny = Config(fine_size=64, ngf=8, ndf=8, vgg_width_scale=1 / 8,
                  is_train=False)
    trng = np.random.default_rng(4)
    tgt, tref = trng.uniform(-1, 1, (2, 1, 64, 64, 3)).astype(np.float32)
    tmask = np.zeros((1, 64, 64), np.float32)
    tmask[:, 24:40, 24:40] = 1.0
    tmodels = TI.init_params(tiny, torch.Generator().manual_seed(0), dev)
    t_out = [TI.make_inference_fn(tiny.replace(quant=q), dev)(
        *tmodels, tgt, tmask, tref)[0] for q in ("none", "int8")]
    figures["b"].update(
        mean_d=gap(out["int8"][0], out["f32"][0]),
        max_d=(out["int8"][0] - out["f32"][0]).abs().max().item(),
        psnr=match.mean().item(),
        bf16_mean_d=gap(out["bf16"][0], out["f32"][0]),
        fake_P_mean_d=gap(out["int8"][1], out["f32"][1]),
        small_no_kr=gap(no_kr(q_cfg), small_f32),
        small_no_kr_bf16=gap(no_kr(p9_cfg.replace(dtype="bfloat16")),
                             small_f32),
        per_net=per_net, jax_test=gap(t_out[1], t_out[0]))
    fb = figures["b"]
    log(f"phase 10 (b) int8 against f32 on the same weights, 8 requests "
        f"(center holes and random_stroke_mask strokes): fake_B mean |d| "
        f"{fb['mean_d']:.5f}, max {fb['max_d']:.4f}, PSNR {fb['psnr']:.2f} "
        f"dB (per-image {', '.join(f'{v:.2f}' for v in match.tolist())}); "
        f"bf16's own {fb['bf16_mean_d']:.5f}; int8 in one network only: "
        + ", ".join(f"{k} {v:.5f}" for k, v in per_net.items())
        + f"; small hole, known replacement off: int8 {fb['small_no_kr']:.5f}"
        f", bf16 {fb['small_no_kr_bf16']:.5f}; fake_P mean |d| "
        f"{fb['fake_P_mean_d']:.5f} (limit {INT8_GAP}); JAX's test setting "
        f"(64 px tiny config, fresh weights): fake_B mean |d| "
        f"{fb['jax_test']:.5f} (limit {INT8_GAP})")
    check(fb["fake_P_mean_d"] <= INT8_GAP, "int8 fake_P against f32")
    check(fb["jax_test"] < INT8_GAP and not torch.equal(*t_out),
          "int8 against f32 in the JAX package's test setting")
    del out, small_f32, tmodels, t_out
    gtf = torch.from_numpy(gt).to(dev).float() / 127.5 - 1.0
    infer_k = TI.make_inference_fn(q_cfg.replace(attention_impl="cuda"), dev)
    infer_p = TI.make_inference_fn(q_cfg.replace(attention_impl="torch"),
                                   dev)
    # deterministic cuDNN: int8 turns the 1-LSB noise of cuDNN's default
    # transposed conv (netP's last layer) into flipped q values downstream
    with deterministic_cudnn():
        kb, _ = infer_k(*models, gtf, small, ref)
        pb, _ = infer_p(*models, gtf, small, ref)
        qb, _ = infer_p(*models, gtf * (1.0 + PERTURB), small, ref)
    d_small = (kb - pb).abs().max().item()
    log(f"phase 10 (b) int8 at phase 4's small hole: fake_B kernel vs "
        f"plain scan max|d|={d_small:.3e} (limit {E2E_TOL}); int8's own "
        f"envelope (input x (1 + {PERTURB})) max "
        f"{(pb - qb).abs().max().item():.3e} mean "
        f"{(pb - qb).abs().mean().item():.3e}")
    check(d_small <= E2E_TOL, "int8 small-hole fake_B kernel vs plain")
    del kb, pb, qb

    # ---- (c) the int8 artifact ----
    art = os.path.join(p9_cfg.checkpoints_dir, "artifact_int8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    EM.export_serving(q_cfg, models, art, device=dev)
    export_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(art, f))
                 for f in os.listdir(art))
    t0 = time.perf_counter()
    loaded = EM.load_serving(art, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ops = EM.graph_ops(next(iter(loaded.exported.values())))
    check("aten._int_mm.default" in ops and f"{EM.SCAN_OP}.default" in ops
          and not any(EM.KBAR_OP in op for op in ops),
          "the int8 graph calls _int_mm and the scan op, not kbar")
    live = TI.make_serving_fn(q_cfg, dev)
    sizes = (1, 8)
    batches = {b: [np.concatenate(x) for x in zip(*requests(b))]
               for b in sizes}
    with deterministic_cudnn():
        want = {b: live(*models, *x) for b, x in batches.items()}
        torch.cuda.synchronize()
        TAC.launches = TAC.kbar_launches = 0   # counts: the loaded calls
        got = {b: loaded.call(loaded.G, loaded.P, loaded.vgg, *x)
               for b, x in batches.items()}
        torch.cuda.synchronize()
    paths["exported_int8"] = counts()
    same = all(torch.equal(got[b], want[b]) for b in sizes)
    calls = 2 if loaded.batch == "symbolic" else sum(
        (b + max(loaded.batch) - 1) // max(loaded.batch) for b in sizes)
    figures["c"] = {"export_s": export_s, "load_s": load_s, "bytes": nbytes,
                    "batch": loaded.batch}
    log(f"phase 10 (c) int8 artifact: export {export_s:.2f} s (batch "
        f"{loaded.batch}), {nbytes} bytes, load {load_s:.2f} s; the graph "
        f"calls aten._int_mm; loaded call against live int8 serving at B = "
        f"{sizes}, deterministic cuDNN: bit for bit {same}; launches "
        f"{paths['exported_int8']}  [{card}]")
    check(same, "the int8 artifact must answer as live int8 serving")
    check(paths["exported_int8"] == {"scan_stream": calls, "kbar_build": 0},
          "the int8 artifact: one scan launch a graph call, no kbar")
    del loaded, got, want
    shutil.rmtree(art, ignore_errors=True)

    # ---- (d) both pack modes, f32: serving, then training ----
    figures["d"], paths["serving_packed"] = serve("(d) packed serving",
                                                  pk_cfg)
    gt, ref = image(), image()
    pb, _ = TI.make_inference_fn(pk_cfg, dev)(*models, gt, small, ref)
    ub, _ = TI.make_inference_fn(p9_cfg, dev)(*models, gt, small, ref)
    d_pack = (pb - ub).abs().max().item()
    log(f"phase 10 (d) packed fake_B against unpacked at phase 4's small "
        f"hole: max|d|={d_pack:.3e} (limit {PACK_TOL})")
    check(d_pack <= PACK_TOL, "packed fake_B against unpacked")
    f32.close()
    del f32, models, pb, ub
    torch.cuda.empty_cache()

    ptcfg = tcfg.replace(pack_small_cin=True, pack_out=True)
    state = TI.create_state(ptcfg, torch.Generator().manual_seed(tcfg.seed),
                            dev)
    step = TI.make_train_step(ptcfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TAC.launches = TAC.kbar_launches = 0    # counts: the packed steps
    _, m = step(state, small_batch)
    losses = {k: v.item() for k, v in m.items()}
    d_step = max(abs(losses[k] - unpacked_losses[k])
                 / max(abs(unpacked_losses[k]), 1e-12) for k in losses)
    ms = []
    for b in train_batches:
        t0 = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    paths["train_packed"] = counts()
    n_steps = 1 + len(train_batches)
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    figures["d"].update(step_ms=steady, peak=peak, d_step=d_step)
    log(f"phase 10 (d) packed train step at B={ptcfg.batch_size}: first "
        f"step at phase 4's small hole against phase 5's unpacked step: max "
        f"relative loss difference {d_step:.3e} (limit {STEP_TOL}); "
        f"{steady:.1f} ms a step (steps " + " / ".join(f"{x:.1f}" for x in ms)
        + f" ms), peak allocated {peak / 2 ** 30:.2f} GiB ({peak} B), "
        f"launches {paths['train_packed']}  [{card}]")
    check(d_step <= STEP_TOL, "packed train step against unpacked")
    check(paths["train_packed"] == {"scan_stream": n_steps,
                                    "kbar_build": n_steps},
          "packed steps: one scan and one kbar launch a step")
    del state, step
    torch.cuda.empty_cache()

    rcfg = ptcfg.replace(remat=True, remat_depth=1)
    state = TI.create_state(rcfg, torch.Generator().manual_seed(tcfg.seed),
                            dev)
    step = TI.make_train_step(rcfg, dev)
    kbars, core = [], TA.attention_core_batched

    def spy(*a, **kw):
        out, kbar = core(*a, **kw)
        kbars.append(kbar)
        return out, kbar

    TA.attention_core_batched = spy
    TAC.launches = TAC.kbar_launches = 0    # counts: the packed remat step
    try:
        step(state, train_batches[0])
    finally:
        TA.attention_core_batched = core
    torch.cuda.synchronize()
    paths["train_packed_remat"] = counts()
    same = len(kbars) == 2 and torch.equal(kbars[0], kbars[1])
    log(f"phase 10 (d) packed step at remat depth 1: {len(kbars)} kbar "
        f"builds, the recompute's equal to the forward's bit for bit: "
        f"{same}; launches {paths['train_packed_remat']}")
    check(same, "the packed recompute must build the forward's kbar")
    check(paths["train_packed_remat"] == step_launches(rcfg),
          "packed remat step launches")
    del state, step, kbars
    torch.cuda.empty_cache()
    return {"paths": paths, "figures": figures}


# ---- phase 11: data parallelism (parallel/mesh.py) ------------------------

P11_WORLD = 2          # (a), (c): gloo ranks sharing the one card
DP_AGREE = 0.995       # (a): share of G's parameters within rtol 1e-3 /
                       # atol 1e-5 after the step (JAX's rule: Adam's first
                       # update is +-lr, so near-zero gradients flip), or
                       # where the batch's chaos is wider, twice the share
                       # the one-process step loses against itself when G's
                       # first weight moves by DP_NUDGE
BN_TOL = 1e-4          # (a): running statistics, relative to each tensor's
                       # largest entry, or ENVELOPE_K x the same nudge's
DP_NUDGE = 1e-7        # (a): the chaos envelope's relative perturbation
# phase 12 (b): the one-process step's envelope is its largest change over
# these runs, each with the first weight of the named networks 1e-7 larger
# (+1) or smaller (-1), and one more on images 1 ulp away (true_division):
# one nudge alone can miss most of the chaos (F's gradients under
# norm='batch' on the H100 moved an order of magnitude more under some
# nudges than under others), and a nudge of a first weight is a uniform
# scaling that netP's norms take out, where a slab's sums in another order
# change every value by an ulp or so
SP_NUDGES = ((("G", "P"), 1.0), (("G", "P"), -1.0), (("G",), 1.0),
             (("P",), 1.0))
CHILD_TIMEOUT_S = 300


def flat_params(net):
    """A network's parameters as one host f32 vector."""
    import torch
    return torch.cat([p.detach().reshape(-1).cpu() for p in net.parameters()])


def applied_grads(state) -> dict:
    """The gradient that the last step applied to each parameter of G, P,
    D and F (the .grad its phase left), on the host."""
    return {f"{n}.{k}": p.grad.detach().cpu().clone()
            for n in ("G", "P", "D", "F")
            for k, p in getattr(state, n).named_parameters()}


def grad_tops(grads: dict) -> dict:
    """The largest entry of each net's gradients (applied_grads' keys)."""
    out = {}
    for k, g in grads.items():
        net = k.split(".")[0]
        out[net] = max(out.get(net, 1e-30), float(g.abs().max()))
    return out


def true_division(batch: dict) -> dict:
    """`batch` with its uint8 images as f32 in [-1, 1], x / 127.5 - 1
    rounded once from f64: the train step takes f32 images as they are,
    and its own f32 division by 127.5 (a reciprocal multiply) lands 1 ulp
    away on about half the pixels."""
    out = dict(batch)
    for k in ("image", "ref"):
        out[k] = (batch[k] / 127.5 - 1.0).astype(np.float32)
    return out


def grad_scales(grads: dict, ref: dict) -> dict:
    """For each net, the scale of its gradients along the reference's,
    <g, ref> / <ref, ref>: 1 for the same gradients, n for n times them."""
    dots = {}
    for k, g in grads.items():
        d = dots.setdefault(k.split(".")[0], [0.0, 0.0])
        w = ref[k].double()
        d[0] += float((g.double() * w).sum())
        d[1] += float((w * w).sum())
    return {n: a / max(b, 1e-300) for n, (a, b) in dots.items()}


def running_stats(state) -> dict:
    """The BatchNorm running statistics of G, P and D, on the host."""
    return {f"{n}.{k}": v.detach().cpu().clone()
            for n in ("G", "P", "D")
            for k, v in getattr(state, n).state_dict().items()
            if "running_" in k}


def run_children(target, args_list, label: str) -> None:
    """One spawned process per argument tuple; fails unless every one exits
    0 within CHILD_TIMEOUT_S.  A child that fails ends the others (a rank
    left alone would wait on a collective)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_list]
    for p in procs:
        p.start()
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            if (time.monotonic() > deadline
                    or any(p.exitcode not in (None, 0) for p in procs)):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * len(procs), f"{label}: child exit codes {codes}")


def gloo_rank(rank: int, url: str):
    """Join phase 11's two-rank gloo group on the one card (cuda:0 for both
    ranks; gloo takes CUDA tensors for all_reduce and broadcast) with TF32
    off and cuDNN deterministic.  Returns (device, group)."""
    import torch
    from deepinpainting_torch.parallel import mesh
    torch.backends.cudnn.deterministic = True
    dev = mesh.init_distributed("cuda", "gloo", url, P11_WORLD, rank)
    return dev, mesh.default_group()


def dp_step_rank(rank: int, url: str, root: str, labels) -> None:
    """Phase 11 (a), one of two gloo ranks sharing the card: for each
    configuration, a fresh full-width state from seed 0 replicated from
    rank 0, one data-parallel step on the rank's rows of the global batch,
    held against the parent's one-process step on the whole batch; the f32
    instance configuration then takes a second step, for its time alone.
    Writes rank{r}.json."""
    import torch
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.parallel import mesh
    dev, group = gloo_rank(rank, url)
    try:
        with np.load(os.path.join(root, "batch.npz")) as f:
            batch = dict(f)
        out = {}
        for label in labels:
            ref = torch.load(os.path.join(root, f"{label}.pt"),
                             weights_only=False)
            cfg = ref["cfg"]
            state = mesh.replicate_state(TI.create_state(
                cfg, torch.Generator().manual_seed(cfg.seed), dev), group)
            step = mesh.make_dp_train_step(cfg, dev, group)
            local = mesh.shard_batch(batch, rank, P11_WORLD, cfg.grad_accum)
            TAC.launches = TAC.kbar_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = step(state, local)
            torch.cuda.synchronize()
            r = {"first_ms": (time.perf_counter() - t0) * 1e3,
                 "rows": int(local["image"].shape[0]),
                 "launches": {"scan_stream": TAC.launches,
                              "kbar_build": TAC.kbar_launches}}
            losses = {k: v.item() for k, v in metrics.items()}
            r["loss_rel"] = max(abs(losses[k] - ref["losses"][k])
                                / max(abs(ref["losses"][k]), 1e-12)
                                for k in losses)
            r["agree"] = float(np.isclose(
                flat_params(state.G).numpy(), ref["G"].numpy(), rtol=1e-3,
                atol=1e-5).mean())
            r["bn_rel"] = max((float((v - ref["bn"][k]).abs().max()
                                     / ref["bn"][k].abs().max().clamp(
                                         min=1e-12))
                               for k, v in running_stats(state).items()),
                              default=0.0)
            r["bn_tensors"] = len(ref["bn"])
            if label == labels[0]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, local)
                torch.cuda.synchronize()
                r["second_ms"] = (time.perf_counter() - t0) * 1e3
                r["launches_timed"] = {"scan_stream": TAC.launches,
                                       "kbar_build": TAC.kbar_launches}
            out[label] = r
            del state, step
            torch.cuda.empty_cache()
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def dp_fit_rank(rank: int, url: str, root: str, cfg, dirs: dict) -> None:
    """Phase 11 (c), one of two gloo ranks sharing the card: Trainer.fit of
    `cfg`, the checkpoint restored into a fresh state and held against the
    rank's trained state bit for bit, then a resume of one more epoch.
    Writes fit{r}.json: the checkpoint writes this rank made, its
    validation losses, the restore's verdict, the epochs run, the steps and
    the kernels' launches."""
    import torch
    from deepinpainting_torch.data import InpaintDataset
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.engine.state import NETWORKS, TRAINED
    from deepinpainting_torch.engine.trainer import Trainer
    from deepinpainting_torch.ops import attention_cuda as TAC
    dev, _ = gloo_rank(rank, url)
    try:
        s = cfg.fine_size
        train_ds = InpaintDataset(dirs["img"], dirs["mask"], dirs["ref"], s,
                                  seed=cfg.seed)
        valid_ds = InpaintDataset(dirs["val"], dirs["mask"], dirs["ref"], s,
                                  seed=cfg.seed + 1)
        out = {"writes": 0, "valid": [], "epochs": []}

        def watched(tr):
            write, validate = tr.ckpt._write, tr.validate
            epoch = tr.train_epoch

            def counted_write(*a):
                out["writes"] += 1
                return write(*a)

            def recorded_validate(state):
                out["valid"].append(validate(state))
                return out["valid"][-1]

            def recorded_epoch(state, e, total):
                out["epochs"].append(e)
                return epoch(state, e, total)

            tr.ckpt._write, tr.validate = counted_write, recorded_validate
            tr.train_epoch = recorded_epoch
            return tr

        TAC.launches = TAC.kbar_launches = 0
        t0 = time.perf_counter()
        tr = watched(Trainer(cfg, train_ds, valid_ds, device=dev))
        state = tr.fit()
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["steps"] = state.step
        fresh = TI.create_state(cfg, torch.Generator().manual_seed(99), dev)
        tr.ckpt.restore(cfg.niter, fresh, dev)
        same = fresh.step == state.step
        for n in NETWORKS:
            a, b = getattr(state, n).state_dict(), getattr(fresh, n
                                                          ).state_dict()
            same &= set(a) == set(b) and all(torch.equal(a[k], b[k])
                                             for k in a)
        for n in TRAINED:
            oa, ob = getattr(state, f"opt_{n}"), getattr(fresh, f"opt_{n}")
            for p, q in zip(getattr(state, n).parameters(),
                            getattr(fresh, n).parameters()):
                same &= all(torch.equal(oa.state[p][k], ob.state[q][k])
                            for k in ("exp_avg", "exp_avg_sq", "step"))
        out["restored_bit_for_bit"] = bool(same)
        del fresh, state
        cfg3 = cfg.replace(continue_train=True, which_epoch="latest",
                           niter=cfg.niter + 1)
        state = watched(Trainer(cfg3, train_ds, valid_ds, device=dev)).fit()
        torch.cuda.synchronize()
        out["resumed_steps"] = state.step
        out["launches"] = {"scan_stream": TAC.launches,
                           "kbar_build": TAC.kbar_launches}
        train_ds.close()
        valid_ds.close()
        with open(os.path.join(root, f"fit{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def dp_cli_child(result_path: str, argv) -> int:
    """Phase 11 (b), run by torch.distributed.run: `_cli train --multihost`
    with `argv`, the trainer's steps timed between synchronises, then two
    more steps under the profiler (outside the counts).  cuDNN keeps its
    defaults, as phase 5 timed the plain step.  Writes `result_path`."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepinpainting_torch import _cli
    from deepinpainting_torch.engine import trainer as T
    from deepinpainting_torch.engine.state import TRAINED
    from deepinpainting_torch.ops import attention_cuda as TAC
    out = {"step_ms": []}

    class TimedTrainer(T.Trainer):
        def train_epoch(self, state, epoch, total_steps):
            inner = self.train_step

            def timed(state, batch, generator):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = inner(state, batch, generator)
                torch.cuda.synchronize()
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                self.last_batch = batch
                return res

            self.train_step = timed
            try:
                return super().train_epoch(state, epoch, total_steps)
            finally:
                self.train_step = inner

        def fit(self, *a, **k):
            TAC.launches = TAC.kbar_launches = 0
            state = super().fit(*a, **k)
            out["launches"] = {"scan_stream": TAC.launches,
                               "kbar_build": TAC.kbar_launches}
            world = torch.distributed.get_world_size(self.group)
            out["group"] = [torch.distributed.get_backend(self.group), world]
            out["grad_bytes"] = 4 * sum(
                p.numel() for n in TRAINED
                for p in getattr(state, n).parameters())
            out["profile"] = profile_calls(
                f"DP steps, nccl, world size {world}, B="
                f"{self.cfg.batch_size}",
                [lambda: self.train_step(state, self.last_batch,
                                         self.generator)] * 2, card_line())
            with open(os.path.join(self.out_dir, "metrics.csv")) as f:
                out["metric_rows"] = [
                    {k: float(v) for k, v in row.items()}
                    for row in csv.DictReader(f)]
            return state

    T.Trainer = TimedTrainer
    _cli.train(argv)
    with open(result_path, "w") as f:
        json.dump(out, f)
    return 0


def data_parallel(dev, card: str, small_batch: dict, plain_ms: float,
                  center, strokes, small) -> dict:
    """Phase 11: the data-parallel step and training program at 256 px,
    full width, weights from seed 0, TF32 off.  (a) two gloo ranks sharing
    the card, one step at global B=8 against the one-process step on the
    same batch (f32 instance norm, norm='batch', grad_accum=2); (b) one
    rank over NCCL through torch.distributed.run and `_cli train
    --multihost`, one epoch; (c) a two-rank gloo Trainer.fit with its
    checkpoint, restore and resume.  The two-rank times share one card and
    move gradients through the host: they are no scaling figure.  Returns
    the kernels' launches by path."""
    import torch
    from deepinpainting_torch.config import Config
    from deepinpainting_torch.engine import inpaint as TI
    os.makedirs(BUILD, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_phase11_", dir=BUILD)
    paths = {}
    try:
        # -- (a) the step: references in this process first --
        cfgs = {"f32_instance": Config(batch_size=TRAIN_BATCH),
                "norm_batch": Config(batch_size=TRAIN_BATCH, norm="batch"),
                "grad_accum_2": Config(batch_size=TRAIN_BATCH, grad_accum=2)}
        np.savez(os.path.join(root, "batch.npz"), **small_batch)
        envelope = {}
        with deterministic_cudnn():
            for label, cfg in cfgs.items():
                # the one-process step, then the same step with G's first
                # weight DP_NUDGE larger: how far the batch's chaos alone
                # moves G's parameters and the running statistics
                ref = None
                for nudge in (0.0, DP_NUDGE):
                    state = TI.create_state(
                        cfg, torch.Generator().manual_seed(cfg.seed), dev)
                    with torch.no_grad():
                        next(state.G.parameters()).mul_(1.0 + nudge)
                    _, m = TI.make_train_step(cfg, dev)(state, small_batch)
                    got = {"cfg": cfg, "G": flat_params(state.G),
                           "losses": {k: v.item() for k, v in m.items()},
                           "bn": running_stats(state)}
                    if ref is None:
                        ref = got
                        torch.save(ref, os.path.join(root, f"{label}.pt"))
                    else:
                        envelope[label] = {
                            "agree": float(np.isclose(
                                got["G"].numpy(), ref["G"].numpy(),
                                rtol=1e-3, atol=1e-5).mean()),
                            "bn_rel": max((float(
                                (v - ref["bn"][k]).abs().max()
                                / ref["bn"][k].abs().max().clamp(min=1e-12))
                                for k, v in got["bn"].items()), default=0.0)}
                    del state
                    torch.cuda.empty_cache()
        t0 = time.perf_counter()
        run_children(dp_step_rank, [(r, f"file://{root}/rendezvous_a", root,
                                     list(cfgs)) for r in range(P11_WORLD)],
                     "phase 11 (a)")
        a_s = time.perf_counter() - t0
        ranks = []
        for r in range(P11_WORLD):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        verdicts = []       # every figure is logged before any check fails
        for label, cfg in cfgs.items():
            want = step_launches(cfg)
            env = envelope[label]
            agree_min = 1.0 - max(1.0 - DP_AGREE, 2.0 * (1.0 - env["agree"]))
            bn_max = max(BN_TOL, ENVELOPE_K * env["bn_rel"])
            log(f"phase 11 (a) {label}: the one-process step against itself "
                f"with G's first weight {DP_NUDGE:g} larger: G parameters "
                f"agreeing {env['agree']:.4%}, running statistics max rel "
                f"{env['bn_rel']:.3e}")
            for r, res in enumerate(ranks):
                x = res[label]
                log(f"phase 11 (a) {label}, gloo rank {r} of {P11_WORLD} "
                    f"sharing one card, {x['rows']} of {TRAIN_BATCH} rows: "
                    f"losses vs the one-process step max rel "
                    f"{x['loss_rel']:.3e} (limit {STEP_TOL}), G parameters "
                    f"agreeing {x['agree']:.4%} (limit {agree_min:.4%}), "
                    f"running statistics max rel {x['bn_rel']:.3e} over "
                    f"{x['bn_tensors']} tensors (limit {bn_max:.3e}), "
                    f"launches {x['launches']} (step_launches {want}), step "
                    f"{x['first_ms']:.1f} ms (first)")
                verdicts += [
                    (x["loss_rel"] <= STEP_TOL,
                     f"(a) {label}: DP losses vs one process"),
                    (x["agree"] >= agree_min,
                     f"(a) {label}: G after the DP step vs one process"),
                    (x["bn_rel"] <= bn_max,
                     f"(a) {label}: running statistics vs one process"),
                    ((x["bn_tensors"] > 0) == (cfg.norm == "batch"),
                     f"(a) {label}: running statistics under norm=batch"),
                    (x["launches"] == want,
                     f"(a) {label}: launches a rank == step_launches")]
        first = next(iter(cfgs))
        gloo_ms = [res[first]["second_ms"] for res in ranks]
        for cond, msg in verdicts:
            check(cond, msg)
        log(f"phase 11 (a) two gloo ranks sharing one card (gradients "
            f"through the host; not a scaling figure): second f32 step "
            f"{gloo_ms[0]:.1f} / {gloo_ms[1]:.1f} ms against the plain "
            f"step's {plain_ms:.1f} ms at B={TRAIN_BATCH} (phase 5); "
            f"(a) took {a_s:.1f} s  [{card}]")
        paths["dp_gloo_steps"] = {k: sum(
            res[label]["launches"][k] for res in ranks for label in cfgs)
            + sum(res[first]["launches_timed"][k] - res[first]["launches"][k]
                  for res in ranks)
            for k in ("scan_stream", "kbar_build")}

        # -- (b) one rank over NCCL through the command line --
        dirs = write_synthetic_data(os.path.join(root, "data"), 256, center,
                                    strokes, small)
        result = os.path.join(root, "b.json")
        args = ["--multihost", "--dataroot", dirs["img"], "--maskroot",
                dirs["mask"], "--refroot", dirs["ref"], "--validroot",
                dirs["val"], "--batch_size", str(TRAIN_BATCH), "--niter",
                "1", "--niter_decay", "0", "--save_epoch_freq", "5",
                "--metrics_every", "3", "--data_workers", "4",
                "--checkpoints_dir", os.path.join(root, "b"), "--name", "b"]
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", os.path.abspath(__file__),
             "--phase11b", result, "--"] + args,
            cwd=here, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
            env=dict(os.environ, PYTHONPATH=here))
        b_s = time.perf_counter() - t0
        for line in res.stdout.splitlines():
            log(f"  (b) {line}")
        check(res.returncode == 0, "phase 11 (b): torch.distributed.run "
              f"exited {res.returncode}: {res.stderr[-3000:]}")
        with open(result) as f:
            b = json.load(f)
        steps = b["step_ms"]
        dp_ms = statistics.median(steps[1:])
        coll = b["profile"].get("collective (NCCL)", 0.0)
        log(f"phase 11 (b) _cli train --multihost under torch.distributed.run"
            f" ({b['group'][0]}, world size {b['group'][1]}): {len(steps)} "
            f"steps at B={TRAIN_BATCH}, DP step median {dp_ms:.1f} ms (steps "
            f"2-{len(steps)}, {min(steps[1:]):.1f} to {max(steps[1:]):.1f}; "
            f"first {steps[0]:.1f}) against the plain step's {plain_ms:.1f} "
            f"ms (phase 5): {dp_ms / plain_ms:.3f}x; NCCL device time "
            f"{coll:.3f} ms a step, {b['grad_bytes']} bytes of gradients "
            f"all-reduced a step; launches {b['launches']}; {b_s:.1f} s  "
            f"[{card}]")
        check(b["group"] == ["nccl", 1], "(b) one rank over NCCL")
        check(len(steps) == 6 and len(b["metric_rows"]) == 6
              and all(np.isfinite(v) for row in b["metric_rows"]
                      for v in row.values()),
              "(b) 6 steps with finite metrics")
        check(b["launches"] == {"scan_stream": 6 + 2, "kbar_build": 6},
              "(b) scan: 6 steps + 2 validation batches; kbar: 6 steps")
        paths["dp_nccl_cli"] = b["launches"]

        # -- (c) a two-rank gloo Trainer.fit: 2 epochs of 3 steps --
        cdirs = dict(dirs, img=os.path.join(root, "c_img"))
        os.makedirs(cdirs["img"])
        for name in sorted(os.listdir(dirs["img"]))[:3 * TRAIN_BATCH]:
            os.symlink(os.path.join(dirs["img"], name),
                       os.path.join(cdirs["img"], name))
        # a constant learning rate ('lambda' with niter_decay 0 would stop
        # training after the first epoch)
        ccfg = Config(batch_size=TRAIN_BATCH, niter=2, niter_decay=0,
                      lr_policy="step", lr_decay_iters=100,
                      save_epoch_freq=2, metrics_every=3, data_workers=2,
                      checkpoints_dir=os.path.join(root, "c"), name="c")
        t0 = time.perf_counter()
        run_children(dp_fit_rank, [(r, f"file://{root}/rendezvous_c", root,
                                    ccfg, cdirs) for r in range(P11_WORLD)],
                     "phase 11 (c)")
        c_s = time.perf_counter() - t0
        fits = []
        for r in range(P11_WORLD):
            with open(os.path.join(root, f"fit{r}.json")) as f:
                fits.append(json.load(f))
        for r, x in enumerate(fits):
            log(f"phase 11 (c) gloo rank {r}: checkpoint writes "
                f"{x['writes']}, validation losses {x['valid']}, restore bit"
                f" for bit {x['restored_bit_for_bit']}, epochs {x['epochs']},"
                f" steps {x['steps']} then {x['resumed_steps']}, fit "
                f"{x['fit_s']:.1f} s, launches {x['launches']}")
        check([x["writes"] for x in fits] == [1, 0],
              "(c) the checkpoint is written once, by rank 0")
        check(sorted(f for f in os.listdir(os.path.join(root, "c", "c"))
                     if f.endswith(".pt")) == ["epoch_2.pt"],
              "(c) one checkpoint file")
        check(all(x["restored_bit_for_bit"] for x in fits),
              "(c) every rank restores rank 0's state bit for bit")
        check(fits[0]["valid"] == fits[1]["valid"] and len(fits[0]["valid"])
              == 3 and all(np.isfinite(fits[0]["valid"]))
              and len(set(fits[0]["valid"])) == 3,
              "(c) the ranks' validation losses are the same (and move)")
        check(all(x["epochs"] == [1, 2, 3] and x["steps"] == 6
                  and x["resumed_steps"] == 9 for x in fits),
              "(c) 2 epochs of 3 steps, then the resume runs epoch 3")
        # 9 steps; each epoch validates 2 batches of which a rank holds half
        check(all(x["launches"] == {"scan_stream": 9 + 3 * 2,
                                    "kbar_build": 9} for x in fits),
              "(c) launches a rank: scan 9 steps + 6 validation batches, "
              "kbar 9 steps")
        log(f"phase 11 (c) two gloo ranks sharing one card: {c_s:.1f} s "
            f"(spawn included)  [{card}]")
        paths["dp_gloo_fit"] = {k: sum(x["launches"][k] for x in fits)
                                for k in ("scan_stream", "kbar_build")}
        return {"paths": paths, "gloo_ms": gloo_ms, "dp_ms": dp_ms,
                "nccl_ms": coll, "grad_bytes": b["grad_bytes"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- phase 12: spatial partitioning (parallel/spatial.py) ------------------

P12_WORLD = 2          # (a)-(c): gloo ranks sharing the one card
SP_FAKE_P_TOL = 2e-4   # (a): fake_P, the JAX package's SP tolerance
                       # (tests/test_parallel.py::
                       # test_sp_inference_matches_single_device)
SP_AGREE = 0.90        # (b): G's parameters agreeing, JAX's SP rule
                       # (test_dp_sp_train_step_matches_single), or twice
                       # the share the one-process step loses to DP_NUDGE
SP_BN_TOL = {"G": 1e-3, "P": 1e-3, "D": 1e-2}   # (b): running statistics,
                       # relative, JAX's SP rule
                       # (test_dp_sp_batch_norm_stats_match_single), or
                       # ENVELOPE_K x the nudge's
SP_GRAD_TOL = 1e-4     # (b): applied gradients, of the leaf's largest entry,
                       # + 1e-6 + ENVELOPE_K x the envelope's change of the
                       # leaf (tests/test_torch_sp_step.py's rule), + 1e-3 of
                       # the net's largest entry: with norm='batch' netP's
                       # innermost BatchNorm normalises 1x1 maps over the
                       # batch alone, and the one-process step's gradients
                       # of its deep leaves move by ~1% of their largest
                       # entry when its images move by 1 ulp
SP_GRAD_NET_TOL = 1e-3
SP_SCALE_TOL = 1e-2    # (b): a net's gradient scale against the one-process
                       # step's, or ENVELOPE_K x the envelope's; counting
                       # replicated work n_sp times reads n_sp - 1 = 1
SP_TIMED = 10          # (a), (d): timed requests
SP_BN_SIZE = 256       # (b): norm='batch' size (128 if the phase runs long)


def count_collectives() -> dict:
    """Count this process's torch.distributed all_reduce and broadcast
    calls and their bytes, by the function that made them: the halo
    exchange, the gather of rows, the all-reduced sums of the norms and
    means (forward and backward each), or the call itself (the gradient
    all-reduce, the request's broadcast).  Returns the live dict, {kind:
    [calls, bytes]}; clear it between the windows it measures."""
    import torch.distributed as dist
    counts = {}
    kinds = {"_HaloExchange": "halo", "_GatherRows": "gather",
             "_AllReduceSum": "sum"}

    def wrap(fn, name):
        def counted(tensor, *a, **k):
            caller = sys._getframe(1).f_code.co_qualname.split(".")[0]
            c = counts.setdefault(kinds.get(caller, name), [0, 0])
            c[0] += 1
            c[1] += tensor.numel() * tensor.element_size()
            return fn(tensor, *a, **k)
        return counted

    dist.all_reduce = wrap(dist.all_reduce, "all_reduce")
    dist.broadcast = wrap(dist.broadcast, "broadcast")
    return counts


def sp_gloo_rank(rank: int, url: str):
    """Join phase 12's two-rank gloo group on the one card, as phase 11's
    ranks join theirs."""
    import torch
    from deepinpainting_torch.parallel import mesh
    torch.backends.cudnn.deterministic = True
    return mesh.init_distributed("cuda", "gloo", url, P12_WORLD, rank)


def sp_infer_rank(rank: int, url: str, root: str, cfg, epoch: int) -> None:
    """Phase 12 (a), one of two gloo ranks sharing the card: phase 5's
    networks restored from phase 9's checkpoint, make_sp_inference_fn over
    both ranks, this rank's slab of the small-hole and the center-hole
    request, then SP_TIMED more small-hole requests timed.  Writes
    sp_infer{r}.json (launches, collectives, ms) and .npz (the slabs)."""
    import torch
    from deepinpainting_torch.engine.checkpoint import CheckpointManager
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.parallel import spatial
    dev = sp_gloo_rank(rank, url)
    try:
        models = CheckpointManager(cfg).restore_models(epoch, dev)
        grid = spatial.make_sp_group()
        infer = spatial.make_sp_inference_fn(cfg, dev, grid)
        with np.load(os.path.join(root, "requests.npz")) as f:
            reqs = {name: spatial.slab({k: f[f"{name}_{k}"] for k in
                                        ("image", "mask", "ref")}, grid)
                    for name in ("small", "center")}
        counts = count_collectives()
        out, arrays = {}, {}
        for name, req in reqs.items():
            TAC.launches = TAC.kbar_launches = 0
            counts.clear()
            fake_B, fake_P = infer(*models, req["image"], req["mask"],
                                   req["ref"])
            torch.cuda.synchronize()
            out[name] = {"launches": {"scan_stream": TAC.launches,
                                      "kbar_build": TAC.kbar_launches},
                         "collectives": {k: list(v)
                                         for k, v in counts.items()}}
            arrays[f"{name}_B"] = fake_B.cpu().numpy()
            arrays[f"{name}_P"] = fake_P.cpu().numpy()
        req = reqs["small"]
        ms = []
        TAC.launches = TAC.kbar_launches = 0
        for _ in range(SP_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infer(*models, req["image"], req["mask"], req["ref"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["ms"] = ms
        out["timed_launches"] = {"scan_stream": TAC.launches,
                                 "kbar_build": TAC.kbar_launches}
        np.savez(os.path.join(root, f"sp_infer{rank}.npz"), **arrays)
        with open(os.path.join(root, f"sp_infer{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def sp_step_rank(rank: int, url: str, root: str, labels) -> None:
    """Phase 12 (b), one of two gloo ranks sharing the card: for each
    configuration, a fresh state from seed 0, one step of the 1 x 2 grid
    (data 1, sp 2) on this rank's slab of the global batch, held against
    the parent's one-process step.  Writes sp_step{r}.json."""
    import torch
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.parallel import spatial
    dev = sp_gloo_rank(rank, url)
    try:
        grid = spatial.make_dp_sp_groups(1, P12_WORLD)
        counts = count_collectives()
        out = {}
        for label in labels:
            ref = torch.load(os.path.join(root, f"{label}.pt"),
                             weights_only=False)
            cfg = ref["cfg"]
            with np.load(os.path.join(root, f"{label}_batch.npz")) as f:
                batch = spatial.place_spatial(dict(f), grid)
            state = TI.create_state(
                cfg, torch.Generator().manual_seed(cfg.seed), dev)
            step = spatial.make_dp_sp_train_step(cfg, dev, grid)
            TAC.launches = TAC.kbar_launches = 0
            counts.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = step(state, batch)
            torch.cuda.synchronize()
            g = flat_params(state.G)
            r = {"ms": (time.perf_counter() - t0) * 1e3,
                 "shape": list(batch["image"].shape),
                 "launches": {"scan_stream": TAC.launches,
                              "kbar_build": TAC.kbar_launches},
                 "collectives": {k: list(v) for k, v in counts.items()}}
            losses = {k: v.item() for k, v in metrics.items()}
            r["loss_rel"] = max(abs(losses[k] - ref["losses"][k])
                                / max(abs(ref["losses"][k]), 1e-12)
                                for k in losses)
            r["max_dG_over_lr"] = float((g - ref["G"]).abs().max()) / cfg.lr
            r["agree"] = float(np.isclose(g.numpy(), ref["G"].numpy(),
                                          rtol=1e-3, atol=1e-5).mean())
            r["bn_rel"] = bn_rel_by_net(running_stats(state), ref["bn"])
            # the applied gradients, leaf by leaf: each net's largest gap
            # over its largest entry, and its worst leaf over the limit
            r["grad_rel"], r["grad_worst"] = {}, {}
            grads = applied_grads(state)
            r["scale"] = {n: v - 1.0 for n, v in
                          grad_scales(grads, ref["grads"]).items()}
            r["scale_limit"] = ref["scale_limit"]
            for k, g in grads.items():
                net, want = k.split(".")[0], ref["grads"][k]
                gap = float((g - want).abs().max())
                r["grad_rel"][net] = max(r["grad_rel"].get(net, 0.0),
                                         gap / ref["grad_top"][net])
                ratio = gap / ref["grad_limit"][k]
                if ratio >= r["grad_worst"].get(net, {"ratio": -1})["ratio"]:
                    r["grad_worst"][net] = {
                        "ratio": ratio, "leaf": k, "gap": gap,
                        "leaf_max": float(want.abs().max()),
                        "limit": ref["grad_limit"][k]}
            out[label] = r
            del state, step
            torch.cuda.empty_cache()
        with open(os.path.join(root, f"sp_step{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def fmt_by_net(d: dict) -> str:
    return "{" + ", ".join(f"{k}: {v:.3e}" for k, v in sorted(d.items())) \
        + "}"


def bn_rel_by_net(got: dict, want: dict) -> dict:
    """For G, P and D, the largest change of a running-statistics tensor
    relative to the reference tensor's largest entry."""
    out = {}
    for k, v in got.items():
        net = k.split(".")[0]
        rel = float((v - want[k]).abs().max()
                    / want[k].abs().max().clamp(min=1e-12))
        out[net] = max(out.get(net, 0.0), rel)
    return out


def sp_cli_child(result_path: str, argv) -> int:
    """Phase 12 (c), run by torch.distributed.run on two ranks: `_cli serve
    --sp` with `argv`, gloo in place of nccl (two ranks share the card).
    Rank 0's server, once up, takes one POST over a socket and a GET of
    /result, answers the request once more in process for the numbers,
    and stops; rank 1 follows until the session closes.  Each rank writes
    `result_path`.rank{r}.json (and rank 0 its answer, .npz)."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import wsgiref.simple_server
    from deepinpainting_torch import _cli
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.parallel import mesh
    from deepinpainting_torch.serve import app as A
    rank = int(os.environ["RANK"])
    out = {"rank": rank}
    torch.backends.cudnn.deterministic = True   # as the plain session's
    init = mesh.init_distributed
    # both ranks on the one card (cuda:LOCAL_RANK would name a second)
    mesh.init_distributed = lambda device: init("cuda:0", "gloo")

    class Once:
        """The server of `_cli serve`: serve_forever answers one POST over
        a socket, then returns."""

        def __init__(self, app):
            self.app = app

        def serve_forever(self):
            with np.load(result_path + ".request.npz") as f:
                img, mask, ref = f["image"], f["mask"], f["ref"]
            status, location, ms, body = A.post_over_socket(self.app, {
                "srcImage": encode(img[0], "PNG"),
                "binaryMask": encode(mask[0] * 255, "PNG"),
                "refImage": encode(ref[0], "PNG")})
            from PIL import Image
            with Image.open(io.BytesIO(body)) as im:
                out["result_image"] = list(im.size)
            page = wsgi_call(self.app, "GET", "/result")
            sess = self.app.session
            out.update(post_status=status, location=location, post_ms=ms,
                       result_page=[page[0], b"test.jpg" in page[2]],
                       grid=list(sess.grid[:4]))
            np.savez(result_path + ".answer.npz",
                     u8=sess.run(img, mask, ref))
            out["calls"] = sess.calls

    wsgiref.simple_server.make_server = lambda host, port, app, **k: Once(app)
    follow = A.InferenceSession.follow

    def recorded_follow(self):
        follow(self)
        out.update(calls=self.calls, grid=list(self.grid[:4]))

    A.InferenceSession.follow = recorded_follow
    _cli.serve(argv)
    out["group_left"] = not torch.distributed.is_initialized()
    out["launches"] = {"scan_stream": TAC.launches,
                       "kbar_build": TAC.kbar_launches}
    with open(f"{result_path}.rank{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def sp_train_steps(dev, card: str, s: int, small_batch: dict,
                   plain_ms: float, bn_size: int, root: str):
    """Phase 12 (b): the 1 x 2 grid's train step at global B=8 in f32
    instance norm and norm='batch' (at `bn_size` px), on two gloo
    ranks sharing the card, against the one-process step and its own
    envelope (SP_NUDGES, true_division).  Returns the step times a rank
    and the kernels' launches."""
    import torch
    from deepinpainting_torch.config import Config
    from deepinpainting_torch.engine import inpaint as TI
    s_bn = bn_size
    crop = lambda b, n: {k: v[:, :n, :n] for k, v in b.items()}
    cfgs = {"f32_instance": (Config(batch_size=TRAIN_BATCH), s),
            "norm_batch": (Config(batch_size=TRAIN_BATCH, norm="batch",
                                  fine_size=s_bn), s_bn)}
    envelope = {}
    with deterministic_cudnn():
        for label, (cfg, size) in cfgs.items():
            batch = crop(small_batch, size)
            np.savez(os.path.join(root, f"{label}_batch.npz"), **batch)
            runs = []
            for nets, sign in ((), 0.0), *SP_NUDGES, ("input", 0.0):
                state = TI.create_state(
                    cfg, torch.Generator().manual_seed(cfg.seed), dev)
                with torch.no_grad():
                    for n in nets if nets != "input" else ():
                        next(getattr(state, n).parameters()).mul_(
                            1.0 + sign * DP_NUDGE)
                _, m = TI.make_train_step(cfg, dev)(
                    state, true_division(batch) if nets == "input"
                    else batch)
                runs.append({"G": flat_params(state.G),
                             "losses": {k: v.item() for k, v in m.items()},
                             "bn": running_stats(state),
                             "grads": applied_grads(state)})
                del state
                torch.cuda.empty_cache()
            # each figure's envelope: its largest change over those runs
            ref, nudged = runs[0], runs[1:]
            ref.update(cfg=cfg, grad_top=grad_tops(ref["grads"]),
                       grad_limit={}, scale_limit={})
            env = envelope[label] = {
                "agree": min(float(np.isclose(
                    x["G"].numpy(), ref["G"].numpy(), rtol=1e-3,
                    atol=1e-5).mean()) for x in nudged),
                "bn_rel": {}, "grad_rel": {}, "scale": {}}
            for x in nudged:
                for n, v in bn_rel_by_net(x["bn"], ref["bn"]).items():
                    env["bn_rel"][n] = max(env["bn_rel"].get(n, 0.0), v)
                for n, v in grad_scales(x["grads"], ref["grads"]).items():
                    env["scale"][n] = max(env["scale"].get(n, 0.0),
                                          abs(v - 1.0))
            for k, want in ref["grads"].items():
                n = k.split(".")[0]
                change = max(float((x["grads"][k] - want).abs().max())
                             for x in nudged)
                ref["grad_limit"][k] = (
                    1e-6 + SP_GRAD_TOL * float(want.abs().max())
                    + ENVELOPE_K * change
                    + SP_GRAD_NET_TOL * ref["grad_top"][n])
                env["grad_rel"][n] = max(env["grad_rel"].get(n, 0.0),
                                         change / ref["grad_top"][n])
            ref["scale_limit"] = {n: max(SP_SCALE_TOL, ENVELOPE_K * v)
                                  for n, v in env["scale"].items()}
            torch.save(ref, os.path.join(root, f"{label}.pt"))
            del runs, ref, nudged
    t0 = time.perf_counter()
    run_children(sp_step_rank, [(r, f"file://{root}/rendezvous_b", root,
                                 list(cfgs)) for r in range(P12_WORLD)],
                 "phase 12 (b)")
    b_s = time.perf_counter() - t0
    steps = []
    for r in range(P12_WORLD):
        with open(os.path.join(root, f"sp_step{r}.json")) as f:
            steps.append(json.load(f))
    verdicts = []
    for label, (cfg, size) in cfgs.items():
        want = step_launches(cfg)
        env = envelope[label]
        agree_min = 1.0 - max(1.0 - SP_AGREE, 2.0 * (1.0 - env["agree"]))
        bn_max = {n: max(t, ENVELOPE_K * env["bn_rel"].get(n, 0.0))
                  for n, t in SP_BN_TOL.items()}
        log(f"phase 12 (b) {label} ({size} px): the one-process step "
            f"against itself with a first weight {DP_NUDGE:g} larger or "
            f"smaller ({len(SP_NUDGES)} runs) and on images 1 ulp away, the "
            f"largest change: G "
            f"parameters agreeing {env['agree']:.4%}, running "
            f"statistics max rel {env['bn_rel']}, applied gradients' "
            f"largest change over the net's largest entry "
            f"{fmt_by_net(env['grad_rel'])}, |scale - 1| "
            f"{fmt_by_net(env['scale'])}")
        for r, res in enumerate(steps):
            x = res[label]
            coll = x["collectives"]
            log(f"phase 12 (b) {label}, gloo rank {r} of the 1 x "
                f"{P12_WORLD} grid, slab {x['shape']} of global B="
                f"{TRAIN_BATCH}: losses vs the one-process step max rel "
                f"{x['loss_rel']:.3e} (limit {STEP_TOL}), G max|d| "
                f"{x['max_dG_over_lr']:.3f} lr (limit 2.2), agreeing "
                f"{x['agree']:.4%} (limit {agree_min:.4%}), running "
                f"statistics max rel {x['bn_rel']} (limits {bn_max}), "
                f"applied gradients' scale - 1 {fmt_by_net(x['scale'])} "
                f"(limits {fmt_by_net(x['scale_limit'])}), largest gap "
                f"over the net's largest entry {fmt_by_net(x['grad_rel'])},"
                f" the worst leaf's gap "
                f"over its limit (limit 1) "
                + ", ".join(f"{n}: {w['ratio']:.3e} ({w['leaf']}: gap "
                            f"{w['gap']:.3e}, leaf max {w['leaf_max']:.3e},"
                            f" limit {w['limit']:.3e})"
                            for n, w in sorted(x["grad_worst"].items()))
                + ", "
                f"launches {x['launches']} (step_launches {want}), "
                f"step {x['ms']:.1f} ms (first), collectives "
                + ", ".join(f"{k} {c}/{b} B"
                            for k, (c, b) in sorted(coll.items())))
            verdicts += [
                (x["loss_rel"] <= STEP_TOL,
                 f"(b) {label}: SP losses vs one process"),
                (x["max_dG_over_lr"] <= 2.2,
                 f"(b) {label}: G's largest change vs one process"),
                (x["agree"] >= agree_min,
                 f"(b) {label}: G after the SP step vs one process"),
                (all(x["bn_rel"].get(n, 0.0) <= t
                     for n, t in bn_max.items()),
                 f"(b) {label}: running statistics vs one process"),
                (bool(x["bn_rel"]) == (cfg.norm == "batch"),
                 f"(b) {label}: running statistics under norm=batch"),
                (set(x["grad_worst"]) == {"G", "P", "D", "F"}
                 and max(w["ratio"] for w in x["grad_worst"].values())
                 <= 1.0,
                 f"(b) {label}: applied gradients vs one process"),
                (all(abs(x["scale"][n]) <= x["scale_limit"][n]
                     for n in ("G", "P", "D", "F")),
                 f"(b) {label}: applied gradients' scale vs one process"),
                (x["launches"] == want,
                 f"(b) {label}: launches a rank == step_launches")]
    for cond, msg in verdicts:
        check(cond, msg)
    log(f"phase 12 (b) took {b_s:.1f} s (spawn included; the two ranks "
        f"share one card: no scaling figure; the plain step "
        f"{plain_ms:.1f} ms, phase 5)  [{card}]")
    return ({label: [x[label]["ms"] for x in steps] for label in cfgs},
            {k: sum(x[label]["launches"][k] for x in steps for label in cfgs)
             for k in ("scan_stream", "kbar_build")})


def spatial_partitioning(dev, card: str, p9_cfg, epoch: int, small_req,
                         center_req, small_batch: dict, plain_ms: float,
                         plain_p50: float, bn_size: int = SP_BN_SIZE
                         ) -> dict:
    """Phase 12: spatial partitioning at p9_cfg's size, full width, f32,
    TF32 off.  (a) two gloo ranks sharing the card serve one request's
    rows on phase 5's weights, against the one-process forward; (b) the
    1 x 2 grid's train step at global B=8 in instance norm and
    norm='batch', against the one-process step; (c) `_cli serve --sp`
    under torch.distributed.run on two gloo ranks; (d) a group of one over
    NCCL, bit for bit with the plain path, and what the SP builders cost
    there.  The two-rank times share one card and move rows through the
    host: they are no scaling figure.  Returns the kernels' launches by
    path."""
    import torch
    import torch.distributed as dist
    from deepinpainting_torch.config import Config
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.engine.checkpoint import CheckpointManager
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.parallel import spatial
    from deepinpainting_torch.serve.app import InferenceSession
    os.makedirs(BUILD, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_phase12_", dir=BUILD)
    paths, figures = {}, {}
    s = p9_cfg.fine_size
    try:
        # -- (a) SP inference: references in this process first --
        models = CheckpointManager(p9_cfg).restore_models(epoch, dev)
        infer = TI.make_inference_fn(p9_cfg, dev)
        reqs = {"small": small_req, "center": center_req}
        np.savez(os.path.join(root, "requests.npz"),
                 **{f"{name}_{k}": v for name, r in reqs.items()
                    for k, v in zip(("image", "mask", "ref"), r)})
        one = {}
        with deterministic_cudnn():
            TAC.launches = TAC.kbar_launches = 0
            for name, (img, mask, ref) in reqs.items():
                one[name] = [t.cpu().numpy() for t in infer(
                    *models, img, mask, ref)]
            one_launches = TAC.launches // len(reqs)
            img, mask, ref = center_req
            imgf = img.astype(np.float32) / 127.5 - 1.0
            env_B = np.abs(infer(*models, imgf * (1.0 + DP_NUDGE), mask, ref
                                 )[0].cpu().numpy()
                           - infer(*models, imgf, mask, ref)[0].cpu().numpy())
        t0 = time.perf_counter()
        run_children(sp_infer_rank, [(r, f"file://{root}/rendezvous_a", root,
                                      p9_cfg, epoch)
                                     for r in range(P12_WORLD)],
                     "phase 12 (a)")
        a_s = time.perf_counter() - t0
        ranks = []
        for r in range(P12_WORLD):
            with open(os.path.join(root, f"sp_infer{r}.json")) as f:
                ranks.append(json.load(f))
            with np.load(os.path.join(root, f"sp_infer{r}.npz")) as f:
                ranks[-1]["arrays"] = dict(f)
        whole = {k: np.concatenate([x["arrays"][k] for x in ranks], 1)
                 for k in ranks[0]["arrays"]}
        d_small_B = float(np.abs(whole["small_B"] - one["small"][0]).max())
        d_small_P = float(np.abs(whole["small_P"] - one["small"][1]).max())
        d_center = np.abs(whole["center_B"] - one["center"][0])
        coll = ranks[0]["small"]["collectives"]
        n_coll = sum(c for c, _ in coll.values())
        p50 = statistics.median(ranks[0]["ms"])
        log(f"phase 12 (a) SP inference, {P12_WORLD} gloo ranks sharing one "
            f"card, b1 at {s} px, phase 5's weights: small hole fake_B max|d| "
            f"{d_small_B:.3e} (limit {E2E_TOL}), fake_P max|d| "
            f"{d_small_P:.3e} (limit {SP_FAKE_P_TOL}); center hole fake_B "
            f"max {d_center.max():.3e} mean {d_center.mean():.3e}, the "
            f"one-process forward's own {DP_NUDGE:g} envelope max "
            f"{env_B.max():.3e} mean {env_B.mean():.3e}; scan launches a "
            f"rank {[x['small']['launches'] for x in ranks]} (one process "
            f"{one_launches} a forward)")
        log(f"phase 12 (a) a request's collectives on rank 0: {n_coll} "
            f"calls, " + ", ".join(f"{k} {c} calls {b} bytes"
                                   for k, (c, b) in sorted(coll.items()))
            + f"; b1 p50 {p50:.2f} ms ({SP_TIMED} requests, "
            f"{min(ranks[0]['ms']):.2f} to {max(ranks[0]['ms']):.2f}) against "
            f"the plain session's {plain_p50:.2f} ms (phase 6): not a "
            f"scaling figure, two ranks share the card and every exchange "
            f"goes through the host; (a) took {a_s:.1f} s  [{card}]")
        check(d_small_B <= E2E_TOL, "(a) SP fake_B at the small hole")
        check(d_small_P <= SP_FAKE_P_TOL, "(a) SP fake_P at the small hole")
        check(bool(np.isfinite(whole["center_B"]).all()),
              "(a) SP fake_B must be finite")
        check(d_center.max() <= ENVELOPE_K * max(env_B.max(), 1e-6)
              and d_center.mean() <= ENVELOPE_K * max(env_B.mean(), 1e-2),
              "(a) SP center-hole fake_B outside 8x the envelope")
        check(all(x[name]["launches"] == {"scan_stream": one_launches,
                                          "kbar_build": 0}
                  for x in ranks for name in reqs),
              "(a) scan launches a rank == the one-process forward's")
        check(all(x["timed_launches"] == {"scan_stream":
                                          SP_TIMED * one_launches,
                                          "kbar_build": 0} for x in ranks),
              "(a) the timed requests' scan launches a rank == the "
              "one-process forward's")
        figures["a"] = {"p50": p50, "collectives": n_coll,
                        "bytes": {k: b for k, (_, b) in coll.items()}}
        paths["sp_gloo_infer"] = {
            "scan_stream": sum(x[name]["launches"]["scan_stream"]
                               for x in ranks for name in reqs)
            + sum(x["timed_launches"]["scan_stream"] for x in ranks),
            "kbar_build": 0}
        del models
        torch.cuda.empty_cache()

        # -- (b) the 1 x 2 grid's train step --
        figures["b"], paths["sp_gloo_steps"] = sp_train_steps(
            dev, card, s, small_batch, plain_ms, bn_size, root)

        # -- (c) `_cli serve --sp` under torch.distributed.run --
        result = os.path.join(root, "c")
        img, mask, ref = small_req
        np.savez(result + ".request.npz", image=img, mask=mask, ref=ref)
        args = ["--sp", "--checkpoints_dir", p9_cfg.checkpoints_dir,
                "--name", p9_cfg.name, "--which_epoch", str(epoch),
                "--static_dir", os.path.join(root, "static")]
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(P12_WORLD), os.path.abspath(__file__),
             "--phase12c", result, "--"] + args,
            cwd=here, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
            env=dict(os.environ, PYTHONPATH=here))
        c_s = time.perf_counter() - t0
        for line in res.stdout.splitlines():
            log(f"  (c) {line}")
        check(res.returncode == 0, "phase 12 (c): torch.distributed.run "
              f"exited {res.returncode}: {res.stderr[-3000:]}")
        c = []
        for r in range(P12_WORLD):
            with open(f"{result}.rank{r}.json") as f:
                c.append(json.load(f))
        with np.load(result + ".answer.npz") as f:
            sp_u8 = f["u8"]
        with deterministic_cudnn():
            plain = InferenceSession(p9_cfg, epoch, device=dev)
            plain_u8 = plain.run(img, mask, ref)
            plain.close()
        diff = np.abs(sp_u8.astype(np.int16) - plain_u8.astype(np.int16))
        same = float((diff == 0).mean())
        log(f"phase 12 (c) _cli serve --sp under torch.distributed.run "
            f"({P12_WORLD} gloo ranks): POST /getImage -> "
            f"{c[0]['post_status']} {c[0]['location']} in "
            f"{c[0]['post_ms']:.1f} ms, GET /result "
            f"{c[0]['result_page']}, result image {c[0]['result_image']}; "
            f"the sp session's uint8 answer against the plain session's at "
            f"the small hole: max |d| {diff.max()} level(s), {same:.4%} "
            f"equal; calls rank 0 {c[0]['calls']}, follower {c[1]['calls']};"
            f" grids {c[0]['grid']} / {c[1]['grid']}; both left the group: "
            f"{[x['group_left'] for x in c]}; {c_s:.1f} s  [{card}]")
        check(c[0]["post_status"] == 302 and c[0]["location"] == "/result",
              "(c) POST /getImage -> 302 /result")
        check(c[0]["result_page"] == ["200 OK", True]
              and c[0]["result_image"] == [s, s],
              "(c) /result shows the result image")
        check(diff.max() <= 1 and same >= 0.999,
              "(c) sp answer within 1 level of the plain session's")
        check(c[1]["calls"] == c[0]["calls"] >= 3
              and c[0]["grid"] == [1, P12_WORLD, 0, 0]
              and c[1]["grid"] == [1, P12_WORLD, 0, 1]
              and all(x["group_left"] for x in c),
              "(c) the follower runs every call and leaves cleanly")
        check(all(x["launches"] == {"scan_stream": c[0]["calls"],
                                    "kbar_build": 0} for x in c),
              "(c) one scan launch a call on each rank")
        paths["sp_cli_serve"] = {k: sum(x["launches"][k] for x in c)
                                 for k in ("scan_stream", "kbar_build")}

        # -- (d) a group of one over NCCL --
        dist.init_process_group("nccl", init_method=f"file://{root}/rdv_d",
                                world_size=1, rank=0)
        # each call's launches go to its path alone: the counts are zeroed
        # just before the call and read just after it
        launched = {name: {"scan_stream": 0, "kbar_build": 0}
                    for name in ("plain", "sp")}

        def counted(name, fn, *args):
            TAC.launches = TAC.kbar_launches = 0
            out = fn(*args)
            launched[name]["scan_stream"] += TAC.launches
            launched[name]["kbar_build"] += TAC.kbar_launches
            return out

        try:
            models = CheckpointManager(p9_cfg).restore_models(epoch, dev)
            grid = spatial.make_sp_group()
            infers = {"plain": infer,
                      "sp": spatial.make_sp_inference_fn(p9_cfg, dev, grid)}
            img, mask, ref = small_req
            with deterministic_cudnn():
                same_infer = all(
                    torch.equal(a, b) for a, b in zip(
                        *(counted(name, fn, *models, img, mask, ref)
                          for name, fn in infers.items())))
            timed = {"plain": [], "sp": []}
            for i in range(2 * SP_TIMED):       # in turns
                name = ("plain", "sp")[i % 2]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                counted(name, infers[name], *models, img, mask, ref)
                torch.cuda.synchronize()
                timed[name].append((time.perf_counter() - t0) * 1e3)
            del models
            cfg = Config(batch_size=TRAIN_BATCH)
            one_grid = spatial.make_dp_sp_groups(1, 1)
            steps = {"plain": TI.make_train_step(cfg, dev),
                     "sp": spatial.make_dp_sp_train_step(cfg, dev, one_grid)}
            states, outs, step_ms = {}, {}, {"plain": [], "sp": []}
            with deterministic_cudnn():
                for name, step in steps.items():
                    states[name] = TI.create_state(
                        cfg, torch.Generator().manual_seed(cfg.seed), dev)
                    _, m = counted(name, step, states[name], small_batch)
                    outs[name] = {k: v.item() for k, v in m.items()}
            same_step = outs["plain"] == outs["sp"] and all(
                torch.equal(p, q) for n in ("G", "P", "D", "F")
                for p, q in zip(getattr(states["plain"], n).parameters(),
                                getattr(states["sp"], n).parameters()))
            for i in range(6):                   # in turns
                name = ("plain", "sp", "sp", "plain", "plain", "sp")[i]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                counted(name, steps[name], states[name], small_batch)
                torch.cuda.synchronize()
                step_ms[name].append((time.perf_counter() - t0) * 1e3)
            del states
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        ratio_req = (statistics.median(timed["sp"])
                     / statistics.median(timed["plain"]))
        ratio_step = (statistics.median(step_ms["sp"])
                      / statistics.median(step_ms["plain"]))
        log(f"phase 12 (d) a group of one over NCCL (sp_devices 1 in the SP "
            f"builders): inference bit for bit with the plain path "
            f"{same_infer}, train step (losses and parameters) bit for bit "
            f"{same_step}; b1 request {statistics.median(timed['sp']):.2f} "
            f"against {statistics.median(timed['plain']):.2f} ms "
            f"({ratio_req:.3f}x), step {statistics.median(step_ms['sp']):.1f}"
            f" against {statistics.median(step_ms['plain']):.1f} ms "
            f"({ratio_step:.3f}x); launches of the SP builders' "
            f"{1 + SP_TIMED} requests and 4 steps {launched['sp']}, the "
            f"plain path's same calls {launched['plain']}  [{card}]")
        check(same_infer, "(d) SP inference at one rank == the plain path")
        check(same_step, "(d) SP train step at one rank == the plain step")
        check(launched["sp"] == launched["plain"]
              and launched["sp"]["kbar_build"] > 0,
              "(d) the SP builders' launches == the plain path's")
        paths["sp_nccl_one"] = launched["sp"]
        figures["d"] = {"request_ratio": ratio_req, "step_ratio": ratio_step}
        return {"paths": paths, "figures": figures}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)


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
    from deepinpainting_torch.engine.checkpoint import CheckpointManager
    from deepinpainting_torch.ops import attention as TA
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.serve.app import InferenceSession

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
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
    def compare_kbar(feat, ref, flag, kr):
        """The kbar kernel against its plain version on the (flag, ind, a,
        b) that the training forward gives it: prep, then the scan kernel."""
        _, pn, ind, vmax, known = TA.prep(feat, ref, flag, kr)
        flag = flag.contiguous()
        _, a, b = TAC.scan_stream_cuda(flag, vmax.contiguous(), pn, known)
        ind = ind.contiguous()
        got = TAC.kbar_build_cuda(flag, ind, a, b)
        want = TA.kbar_build_reference(flag, ind, a, b)
        torch.cuda.synchronize()
        um = flag == 0
        onehot = F.one_hot(ind[um], flag.shape[1]).to(torch.float32)
        return {"equal": torch.equal(got, want),
                "trunc_equal": torch.equal(got.trunc(), want.trunc()),
                "d": (got - want).abs().max().item(),
                "onehot": torch.equal(got[um], onehot),
                "int32": torch.equal(
                    got, TAC.kbar_build_cuda(flag, ind.int(), a, b))}

    def compare_function(feat, ref, flag, kr, truncate):
        """out and d(out.g)/d(feat) of the attention Function, kernels
        against plain versions, same inputs and cotangent."""
        b, n, c = feat.shape
        side = int(n ** 0.5)
        img = lambda t: t.transpose(1, 2).reshape(b, c, side, side)
        g = torch.from_numpy(np.random.default_rng(n + int(kr)
                                                   ).standard_normal(
            (b, c, side, side)).astype(np.float32)).to(dev)
        res = {}
        for impl in ("cuda", "torch"):
            x = img(feat).detach().clone().requires_grad_(True)
            out = TA.ipsr_attention_batched(
                x, img(ref), flag, triple_weight=1.0,
                truncate_backward=truncate, known_replacement=kr, impl=impl)
            out.backward(g)
            res[impl] = (out.detach(), x.grad)
        torch.cuda.synchronize()
        return ((res["cuda"][0] - res["torch"][0]).abs().max().item(),
                (res["cuda"][1] - res["torch"][1]).abs().max().item())

    max_abs_err = 0.0
    kbar_max_abs_err = 0.0
    for name, seed, b, h, w, holes, kr, crit in cases:
        case = make_case(seed, b, h, w, holes)
        r = compare(*case, kr)
        k = compare_kbar(*case, kr)
        log(f"phase 2 kbar_build {name} (B={b}, N={h * w}): kernel vs plain "
            f"max|d|={k['d']:.3e} equal={k['equal']} trunc equal="
            f"{k['trunc_equal']} unmasked rows one-hot={k['onehot']} "
            f"int32 ind same bits={k['int32']}")
        check(all(k[key] for key in ("equal", "trunc_equal", "onehot",
                                     "int32")),
              f"{name}: kbar kernel must equal its plain version bit for bit")
        kbar_max_abs_err = max(kbar_max_abs_err, k["d"])
        if crit == "direct":
            for truncate in (True, False):
                d_out, d_grad = compare_function(*case, kr, truncate)
                log(f"phase 2 attention Function {name}, truncate_backward="
                    f"{truncate}: kernels vs plain out {d_out:.3e} grad "
                    f"{d_grad:.3e} (limit {GRAD_TOL})")
                check(d_out <= GRAD_TOL and d_grad <= GRAD_TOL,
                      f"{name}: attention Function kernels vs plain")
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

    # what the designs make special: the chain runs over the masked rows
    # only, other blocks copy or fill the rest.  Non-negative pn and known
    # keep (a, b) in (0, 1), so every chain stays within the direct limit.
    def special_flag(kind, b, n):
        flag = torch.zeros(b, n)
        if kind == "every row":
            flag[:] = 1
        elif kind == "first row":
            flag[:, 0] = 1
            flag[:, n // 2:n // 2 + 5] = 1
        elif kind == "hole per sample":       # sample 0 has no masked row
            for i in range(b):
                flag[i, (7 * i) % n:(7 * i) % n + 3 * i] = 1
        elif kind == "scattered":
            flag = (torch.rand(b, n, generator=torch.Generator()
                               .manual_seed(n)) < 0.2).float()
        return flag.to(dev)

    special = [("no row", 2, 1024, SCAN_C), ("every row", 2, 1024, SCAN_C),
               ("first row", 2, 1024, SCAN_C),
               ("hole per sample", 5, 1024, SCAN_C),
               ("scattered", 2, 48, SCAN_C), ("scattered", 1, 4096, SCAN_C),
               ("scattered", 3, 1024, 64), ("scattered", 2, 512, 1024),
               ("hole per sample", 200, 256, 128)]
    for kind, b, n, c in special:
        rng = np.random.default_rng(n + c)
        draw = lambda *shape: torch.from_numpy(np.abs(rng.standard_normal(
            shape)).astype(np.float32)).to(dev)
        pn = draw(b, n, c)
        pn = (pn / pn.norm(dim=2, keepdim=True)).contiguous()
        known, vmax = draw(b, n, c), draw(b, n) + 0.5
        flag = special_flag(kind, b, n)
        ind = torch.from_numpy(rng.integers(0, n, (b, n))).to(dev)
        got = TAC.scan_stream_cuda(flag, vmax, pn, known)
        kgot = TAC.kbar_build_cuda(flag, ind, got[1], got[2])
        torch.cuda.synchronize()
        want = TA.scan_stream_reference(flag, vmax, pn, known)
        kwant = TA.kbar_build_reference(flag, ind, got[1], got[2])
        d = max((g - w).abs().max().item() for g, w in zip(got, want))
        um = flag == 0
        struct = bool(torch.equal(got[0][um], known[um])
                      and bool((got[1][um] == 1).all())
                      and bool((got[2][um] == 0).all()))
        k_equal = (torch.equal(kgot, kwant)
                   and torch.equal(kgot.trunc(), kwant.trunc())
                   and torch.equal(kgot, TAC.kbar_build_cuda(
                       flag, ind.int(), got[1], got[2])))
        log(f"phase 2 special case {kind} (B={b}, N={n}, C={c}, masked "
            f"{int(flag.sum().item())}): scan kernel vs plain {d:.3e} (limit "
            f"{DIRECT_TOL}), structure={'exact' if struct else 'BROKEN'}; "
            f"kbar bit for bit={k_equal}")
        check(d <= DIRECT_TOL and struct, f"{kind}: scan kernel vs plain")
        check(k_equal, f"{kind}: kbar kernel must equal its plain version")
        max_abs_err = max(max_abs_err, d)
    # nothing of phase 2 stays allocated under phase 5's peak-memory figure
    del pn, known, vmax, flag, ind, got, kgot, want, kwant, um

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

    TAC.launches = TAC.kbar_launches = 0  # counts: the serving path only
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
    launches = {"scan_stream": TAC.launches,
                "kbar_build": TAC.kbar_launches}
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
    check(launches["kbar_build"] == 0, "serving must build no kbar")

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

    # ---- phase 5: the training path, full width, batch 8 ------------------
    tcfg = Config(batch_size=TRAIN_BATCH)

    def train_batch(seed, mask=None):
        brng = np.random.default_rng(seed)
        if mask is None:      # center squares and strokes, half and half
            mask = np.concatenate([center(TRAIN_BATCH // 2),
                                   strokes(TRAIN_BATCH - TRAIN_BATCH // 2)])
        return {"image": brng.integers(0, 256, (TRAIN_BATCH, s, s, 3),
                                       dtype=np.uint8),
                "ref": brng.integers(0, 256, (TRAIN_BATCH, s, s, 3),
                                     dtype=np.uint8),
                "mask": mask}

    t0 = time.perf_counter()
    state = TI.create_state(tcfg, torch.Generator().manual_seed(tcfg.seed),
                            dev)
    train_step = TI.make_train_step(tcfg, dev)
    nets = {n: getattr(state, n) for n in ("G", "P", "D", "F")}
    before = {n: [p.detach().clone() for p in net.parameters()]
              for n, net in nets.items()}
    n_train = sum(p.numel() for net in nets.values()
                  for p in net.parameters())
    torch.cuda.synchronize()
    log(f"phase 5 create_state: {n_train} trainable parameters, four Adam "
        f"optimisers, {time.perf_counter() - t0:.1f} s")
    batches = [train_batch(100 + i) for i in range(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    TAC.launches = TAC.kbar_launches = 0  # counts: the training path only
    step_ms = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        values = {k: v.item() for k, v in metrics.items()}
        log(f"phase 5 step {i + 1}: {step_ms[-1]:.1f} ms  " + "  ".join(
            f"{k}={v:.4f}" for k, v in values.items()))
        check(all(np.isfinite(v) for v in values.values()),
              f"step {i + 1}: every metric must be finite")
    train_launches = {"scan_stream": TAC.launches,
                      "kbar_build": TAC.kbar_launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 5 trained {TRAIN_STEPS} steps at B={TRAIN_BATCH}: launches "
        f"{train_launches}, state.step={state.step}")
    check(state.step == TRAIN_STEPS, "state.step must count the steps")
    check(train_launches == {"scan_stream": TRAIN_STEPS,
                             "kbar_build": TRAIN_STEPS},
          "each kernel must launch exactly once a train step")
    for n, net in nets.items():
        check(any(not torch.equal(p, q)
                  for p, q in zip(net.parameters(), before[n])),
              f"net{n}'s parameters must change")
    del before

    # phase 3's InferenceSession answers with the trained generators
    single.state = TI.Models(state.G.eval(), state.P.eval(), state.vgg)
    scan0, calls0 = TAC.launches, single.calls
    out = single.run(image(), center(), image())
    check(out.dtype == np.uint8 and out.shape == (1, s, s, 3)
          and out.std() > 0, "trained generators must still serve")
    check(TAC.launches - scan0 == single.calls - calls0 == 1
          and TAC.kbar_launches == TRAIN_STEPS,
          "serving the trained generators: one scan launch, no kbar")
    # phase 9 restores this state from a checkpoint and holds its answers
    # against these, so both are taken before the timing steps move it
    p9_root = tempfile.mkdtemp(prefix="chip_smoke_phase9_", dir=BUILD)
    atexit.register(shutil.rmtree, p9_root, True)
    p9_cfg = cfg.replace(checkpoints_dir=p9_root, name="phase9")
    p9_mgr = CheckpointManager(tcfg.replace(checkpoints_dir=p9_root,
                                            name="phase9"))
    p9_mgr.save(TRAIN_STEPS, state)
    p9_requests = serving_requests(s, cfg.overlap)
    with deterministic_cudnn():
        p9_live = [single.run(*r) for r in p9_requests]
    log(f"phase 5 state saved for phase 9: {p9_mgr.last_save['bytes']} "
        f"bytes in {p9_mgr.last_save['total_ms']:.1f} ms; "
        f"{len(p9_requests)} requests answered by phase 3's session")
    single.state = models
    # more steps for the timing alone, then where a step's device time goes
    # (two further steps under the profiler); all outside the counts
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        train_step(state, batches[i % TRAIN_STEPS])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gib = max(peak_gib, torch.cuda.max_memory_allocated() / 2 ** 30)
    profile_calls(f"train steps at 256 px, B={TRAIN_BATCH}",
                  [lambda b=b: train_step(state, b) for b in batches[:2]],
                  card)
    del state, nets

    # one step with the kernels against the same step with the plain
    # versions, same weights and batch, at a 9-position hole
    small_batch = train_batch(200, np.repeat(small, TRAIN_BATCH, axis=0))
    losses = {}
    for impl in ("cuda", "torch"):
        icfg = tcfg.replace(attention_impl=impl)
        fresh = TI.create_state(icfg,
                                torch.Generator().manual_seed(tcfg.seed), dev)
        _, m = TI.make_train_step(icfg, dev)(fresh, small_batch)
        losses[impl] = {k: v.item() for k, v in m.items()}
        del fresh
    d_step = max(abs(losses["cuda"][k] - losses["torch"][k])
                 / max(abs(losses["torch"][k]), 1e-12) for k in losses["cuda"])
    log(f"phase 5 first step at a {n_small}-position hole, kernels vs plain "
        f"versions: max relative loss difference {d_step:.3e} (limit "
        f"{STEP_TOL}); kernels {losses['cuda']}")
    check(d_step <= STEP_TOL, "train-step losses, kernels vs plain versions")
    torch.cuda.empty_cache()

    # ---- phase 6: numbers -------------------------------------------------
    log(f"card: {card}")
    cflag = TI.prepare_masks(cfg, torch.from_numpy(center()).float())[1]
    timings, kbar_timings = {}, {}
    for b in (1, 8):
        feat, refr, _ = make_case(10 + b, b, 32, 32, [])
        flag = cflag.to(dev).expand(b, -1).contiguous()
        args = scan_args(feat, refr, flag, True)
        bound = scan_bound(flag, SCAN_C)
        k_ms = cuda_ms(lambda: TAC.scan_stream_cuda(*args), reps=50)
        k_b2b = cuda_ms_back_to_back(lambda: TAC.scan_stream_cuda(*args))
        p_ms = cuda_ms(lambda: TA.scan_stream_reference(*args), reps=20,
                       warmup=1)
        timings[b] = dict(ms=k_b2b, single_ms=k_ms, plain_ms=p_ms, **bound)
        m = bound["masked"] // b          # the chain of one sample
        log(f"phase 6 scan_stream B={b} N=1024 C={SCAN_C} masked "
            f"{bound['masked']} rows: kernel {k_ms:.4f} ms single launch, "
            f"{k_b2b:.4f} ms a launch back to back, plain "
            f"{p_ms:.2f} ms, bound {bound['bound_ms']:.5f} ms "
            f"({bound['bound_by']}: {bound['bytes']} B, {bound['ops']} ops), "
            f"share {bound['bound_ms'] / k_b2b:.2%} (back to back), chain "
            f"m={m} steps, {k_b2b / m * 1e6:.1f} ns a masked step, library "
            f"call: none  [{card}]")

        _, pn, ind, vmax, known = TA.prep(feat, refr, flag, True)
        _, ka, kb_ = TAC.scan_stream_cuda(*args)
        kargs = (flag, ind.contiguous(), ka, kb_)
        kbound = kbar_bound(b, flag.shape[1], ind.element_size())
        kk_ms = cuda_ms(lambda: TAC.kbar_build_cuda(*kargs), reps=50)
        kk_b2b = cuda_ms_back_to_back(lambda: TAC.kbar_build_cuda(*kargs))
        kp_ms = cuda_ms(lambda: TA.kbar_build_reference(*kargs), reps=5,
                        warmup=1)
        kbar_timings[b] = dict(ms=kk_b2b, single_ms=kk_ms, plain_ms=kp_ms,
                               **kbound)
        log(f"phase 6 kbar_build B={b} N=1024 ({ind.dtype} ind): kernel "
            f"{kk_ms:.4f} ms single launch, {kk_b2b:.4f} ms a launch back "
            f"to back, plain {kp_ms:.2f} ms, bound "
            f"{kbound['bound_ms']:.5f} ms ({kbound['bound_by']}: "
            f"{kbound['bytes']} B, {kbound['ops']} ops), share "
            f"{kbound['bound_ms'] / kk_b2b:.2%} (back to back), library "
            f"call: none  [{card}]")

    steady = statistics.median(step_ms[1:])
    log(f"phase 6 training 256 px B={TRAIN_BATCH}: {steady:.1f} ms a step "
        f"(median of steps 2-{len(step_ms)}, {min(step_ms[1:]):.1f} to "
        f"{max(step_ms[1:]):.1f}; first step {step_ms[0]:.1f} ms), "
        f"{TRAIN_BATCH / steady * 1e3:.2f} img/s, peak allocated "
        f"{peak_gib:.2f} GiB  [{card}]")

    # chain probe: the same shapes with no row and with every row masked
    for label, value in (("no row masked", 0.0), ("every row masked", 1.0)):
        flag = torch.full((8, 1024), value, device=dev)
        args = (flag,) + scan_args(feat, refr, flag, True)[1:]
        scan = lambda: TAC.scan_stream_cuda(*args)
        log(f"phase 6 scan_stream B=8 N=1024 {label}: kernel "
            f"{cuda_ms(scan, reps=50):.4f} ms single launch, "
            f"{cuda_ms_back_to_back(scan):.4f} ms a launch back to back, "
            f"bound {scan_bound(flag, SCAN_C)['bound_ms']:.5f} ms  [{card}]")

    lat = []
    for i in range(21):
        r = (image(), center() if i % 2 else strokes(), image())
        t0 = time.perf_counter()
        single.run(*r)
        lat.append((time.perf_counter() - t0) * 1e3)
    p50 = statistics.median(lat[1:])
    profile_calls("b1 requests at 256 px",
                  [lambda r=(image(), center(), image()): single.run(*r)
                   for _ in range(5)], card)
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
    log(f"phase 6 serving 256 px: b1 request p50 {p50:.2f} ms "
        f"(20 requests), b8 throughput {n_req / wall:.2f} img/s "
        f"({n_req} requests over 8 clients, {batched.calls - calls0} "
        f"batched calls)  [{card}]")
    single.close()
    batched.close()
    phase6 = {"p50": p50, "img_s": n_req / wall}

    # ---- phase 7: the training program at full width ----------------------
    program_launches = training_program(
        dev, card, TRAIN_BATCH / steady * 1e3, center, strokes, small,
        n_small)

    # ---- phase 8: bf16, remat and grad_accum at 512 px, N=4096 ------------
    p8 = precision_and_memory(
        dev, card, Config(fine_size=P8_SIZE, batch_size=TRAIN_BATCH), models,
        phase6)

    # ---- phase 9: the serving program at full width, 256 px ---------------
    t0 = time.perf_counter()
    p9 = serving_program(dev, card, p9_cfg, TRAIN_STEPS, p9_requests,
                         p9_live)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")

    # ---- phase 10: the conv knobs at full width, 256 px -------------------
    t0 = time.perf_counter()
    p10 = conv_knobs(dev, card, p9_cfg, TRAIN_STEPS, tcfg, small,
                     small_batch, losses["cuda"], batches, phase6)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")

    # ---- phase 11: data parallelism, 256 px, full width -------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p11 = data_parallel(dev, card, small_batch, steady, center, strokes,
                        small)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # ---- phase 12: spatial partitioning, 256 px, full width ---------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = lambda t: t.cpu().numpy()
    p12 = spatial_partitioning(
        dev, card, p9_cfg, TRAIN_STEPS, (host(gt), small, host(ref)),
        (host(gt), center(), host(ref)), small_batch, steady, phase6["p50"])
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # `launches` sums the main paths (serving, the train step, the trainer,
    # evaluate, phase 8's bf16 / remat / grad_accum paths, phase 9's
    # serving program, phase 10's int8 and packed paths, phase 11's
    # data-parallel paths and phase 12's spatially partitioned ones, each
    # rank's launches counted); the
    # times are those at B=8, N=1024, the shapes a 256 px train step gives
    # both: `ms` a launch of 20 back to back, `single_launch_ms` the median
    # of single launches, each between its own pair of events.  `n4096`
    # holds the same at N=4096 (512 px), B=1 and B=8, center hole.
    t8, k8 = timings[8], kbar_timings[8]
    by_path = lambda name: {"serving": launches[name],
                            "training": train_launches[name],
                            "trainer": program_launches["trainer"][name],
                            "evaluate": program_launches["evaluate"][name],
                            **{path: n[name]
                               for paths in (p8["paths"], p9,
                                             p10["paths"], p11["paths"],
                                             p12["paths"])
                               for path, n in paths.items()}}
    n4096 = lambda name: {
        f"B{b}": {k: t[name][k] for k in ("ms", "single_ms", "plain_ms",
                                          "bound_ms", "bound_by")}
        for b, t in p8["timings"].items()}
    log(f"all phases: {time.perf_counter() - t_start:.1f} s  [{card}]")
    print(json.dumps({"kernels": [{
        "name": "scan_stream", "route": "cuda",
        "source": "deepinpainting_torch/csrc/scan_stream.cu",
        "replaces": "deepinpainting_tpu/ops/attention_pallas.py:107",
        "launches": sum(by_path("scan_stream").values()),
        "launches_by_path": by_path("scan_stream"),
        "max_abs_err": max_abs_err,
        "ms": t8["ms"], "single_launch_ms": t8["single_ms"],
        "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
        "library_ms": None, "n4096": n4096("scan_stream")}, {
        "name": "kbar_build", "route": "cuda",
        "source": "deepinpainting_torch/csrc/kbar_build.cu",
        "replaces": "deepinpainting_tpu/ops/attention_pallas.py:186",
        "launches": sum(by_path("kbar_build").values()),
        "launches_by_path": by_path("kbar_build"),
        "max_abs_err": kbar_max_abs_err,
        "ms": k8["ms"], "single_launch_ms": k8["single_ms"],
        "plain_ms": k8["plain_ms"],
        "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
        "library_ms": None, "n4096": n4096("kbar_build")}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase11b"]:     # phase 11 (b)'s rank
        sys.exit(dp_cli_child(sys.argv[2], sys.argv[4:]))
    if sys.argv[1:2] == ["--phase12c"]:     # phase 12 (c)'s ranks
        sys.exit(sp_cli_child(sys.argv[2], sys.argv[4:]))
    sys.exit(main())
