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
     InferenceSession.from_export's p50 and b8; (c') `_cli export
     --platforms cuda,cpu`: one directory, one set of npz files, its cuda
     graph on the card bit for bit with live serving at B = 1 and 8, its
     cpu graph on the CPU bit for bit with live CPU serving at B=1; and
     `--attention_impl torch`: a graph with the plain scan's op and no scan
     op, bit for bit with live attention_impl='torch' serving;
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
     validation losses on both, a resume; (d) int8 evaluate() on two
     gloo ranks at global batch 8 on phase 5's weights (the ranks' halves
     of different contrast), against one process's int8 evaluation of the
     same batch (per-image PSNR / SSIM and fake_B), beside each rank's
     rows evaluated alone.  The two-rank times share one card: they are
     no scaling figure;
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
     session, and (c') the same with --quant int8 against the one-process
     int8 session (the median over five draws, the image and four ulp
     nudges, of the mean |d| within 6.4 levels, or int8's own chaos, the
     largest mean change of the one-process int8 under 48 nudges of the
     image by 1 to 24 ulps); (d) a group of one over NCCL:
     the SP builders bit for bit with the plain path, their request and
     step time as a ratio; (e) the conv knobs on slabs, in (a)'s and (b)'s
     ranks: int8 requests at both holes (each int8 conv's int32 sums on
     the slabs bit for bit with one process's on the whole tensor, the
     MAX all-reduces of the scales counted, the median over five draws,
     the image and four ulp nudges, of fake_B's mean |d| to the
     one-process int8 forward within 0.05 or int8's own chaos as in (c');
     controls: each slab's own maximum as its scale fails the scale
     check, the slabs in the wrong order fail the fake_B limit), a packed
     request (fake_B 1e-3, the same rewrites as one process) and the
     1 x 2 packed step by (b)'s rules.
     The two-rank times are no scaling figure either;
 13. reference checkpoints at 256 px, full width, f32, TF32 off:
     stand-ins of the reference's netP, netG, netD and netF in plain
     torch.nn (weights from a seed, parameter counts checked against the
     reference's) and a torchvision VGG16 state_dict; the VGG converted by
     `python -m deepinpainting_torch.convert.vgg_import` in a subprocess,
     the four nets imported with `convert/net_import.py` into a
     create_state state, saved with CheckpointManager and restored by
     InferenceSession(cfg, which_epoch) with Config(vgg_weights=npz): (a)
     every imported and restored tensor bit for bit, P, D and F forwards
     against the stand-ins' within 1e-5, relu4_3 against torchvision's
     recomputation; (b) fake_B kernel vs plain at phase 4's small hole,
     b1 requests and their launches, one train step at B=8 kernels vs
     plain (losses), launches 1 / 1; conversion, import, restore and b1
     times;
 14. the quality protocols' runner (deepinpainting_torch/demo.py) at a cut
     depth, full width: data/synth.py's 24 training and 8 held-out
     images, one epoch of 3 steps at 128 px for each 128 px protocol's
     overrides (f32, bf16, bn, trunc, cosis, corrected, kr) through
     demo.run_protocol and `_cli train`, then the f32 run's three
     evaluations (f32, known replacement off, int8), its int8 fake_B gap
     and one POST; every loss finite, 8 finite per-image PSNR and SSIM an
     evaluation, each run's launches; the band check on fabricated
     figures (a miss on both seeds exits 1 naming it).  The real figures
     are not judged at this depth.  (b) the kernels against their plain
     versions at the protocols' shape; (c) the f32 cut run twice under
     cuDNN's defaults (the largest loss difference reported) and twice
     under deterministic algorithms (bit for bit), the latter in a child
     process with CUBLAS_WORKSPACE_CONFIG=:4096:8.
     `python3 chip_smoke.py --phase 14` runs the build and this phase
     alone, with no result line;
 15. the f32 protocol's first 8 train steps at full width (128 px, batch
     8, ngf 64) from the JAX trainer's own seed-0 draw (the packed
     artifacts/jax_cpu_f32/jax_draw_ngf64_s0.npz, every leaf's SHA-256
     checked) on the first batches its trainer draws: step 1's losses
     against the JAX package's on the CPU from the same draw and batches
     (artifacts/jax_cpu_f32/fullwidth_s0/pair.json), steps 2-8 printed
     beside 8x JAX's one-ulp envelope, and (b) netP's first gradient
     against its f64 recomputation.  `python3 chip_smoke.py --phase 15`
     runs the build and this phase alone.
Three lines end the output, each on its own: a JSON object with a `kernels`
list, the card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import atexit
import contextlib
import csv
import dataclasses
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
from pathlib import Path

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
    paths.update(artifact_platforms(dev, card, p9_cfg, epoch, requests,
                                    sess))
    for x in (single, batched, sess, app.session):
        x.close()
    return paths


def artifact_platforms(dev, card: str, p9_cfg, epoch: int, requests,
                       sess) -> dict:
    """Phase 9 (c'): `_cli export --platforms cuda,cpu` of phase 5's
    checkpoint, one directory and one set of npz files: its cuda graph on
    the card bit for bit with live serving at B = 1 and 8 (deterministic
    cuDNN), its cpu graph on the CPU bit for bit with the port's live CPU
    serving at B=1; then `--attention_impl torch`: a graph with the plain
    scan's op and no scan op, on the card bit for bit with live
    attention_impl='torch' serving at B=1.  Export and load times, bytes
    and each graph's node count.  Returns the cuda graph's launches."""
    import torch
    from deepinpainting_torch import _cli
    from deepinpainting_torch.engine import export_model as EM
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.engine.checkpoint import CheckpointManager
    from deepinpainting_torch.ops import attention_cuda as TAC
    t_part = time.perf_counter()
    base = ["--checkpoints_dir", p9_cfg.checkpoints_dir, "--name",
            p9_cfg.name, "--which_epoch", str(epoch)]
    batches = {b: [np.concatenate(x) for x in zip(*(
        requests[i % len(requests)] for i in range(b)))] for b in (1, 8)}
    arts, times, graphs = {}, {}, {}
    for name, extra in (("cuda_cpu", ["--platforms", "cuda,cpu"]),
                        ("torch_impl", ["--platforms", "cuda",
                                        "--attention_impl", "torch"])):
        arts[name] = os.path.join(p9_cfg.checkpoints_dir, f"art_{name}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _cli.export(base + ["--out", arts[name]] + extra)
        times[f"{name} export"] = time.perf_counter() - t0
    for name, device in (("cuda_cpu", dev), ("cuda_cpu", "cpu"),
                         ("torch_impl", dev)):
        t0 = time.perf_counter()
        graphs[name, str(device)] = EM.load_serving(arts[name], device)
        torch.cuda.synchronize()
        times[f"{name} load on {device}"] = time.perf_counter() - t0
    files = {name: {f: os.path.getsize(os.path.join(art, f))
                    for f in sorted(os.listdir(art))}
             for name, art in arts.items()}
    nodes = {k: len(next(iter(g.exported.values())).graph.nodes)
             for k, g in graphs.items()}
    ops = {k: EM.graph_ops(next(iter(g.exported.values())))
           for k, g in graphs.items()}
    call = lambda g, batch: g.call(g.G, g.P, g.vgg, *batch)
    cuda_graph = graphs["cuda_cpu", str(dev)]
    live = TI.make_serving_fn(sess.cfg, dev)
    live_torch = TI.make_serving_fn(sess.cfg.replace(attention_impl="torch"),
                                    dev)
    with deterministic_cudnn():
        want = {b: live(*sess.state, *batch) for b, batch in batches.items()}
        want_torch = live_torch(*sess.state, *batches[1])
        torch.cuda.synchronize()
        TAC.launches = TAC.kbar_launches = 0   # counts: the cuda graph only
        got = {b: call(cuda_graph, batch) for b, batch in batches.items()}
        torch.cuda.synchronize()
        launched = {"scan_stream": TAC.launches,
                    "kbar_build": TAC.kbar_launches}
        got_torch = call(graphs["torch_impl", str(dev)], batches[1])
        torch.cuda.synchronize()
    torch_launched = TAC.launches - launched["scan_stream"]
    cpu_models = CheckpointManager(p9_cfg).restore_models(epoch, "cpu")
    t0 = time.perf_counter()
    cpu_want = TI.make_serving_fn(sess.cfg, "cpu")(*cpu_models, *batches[1])
    cpu_live_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_got = call(graphs["cuda_cpu", "cpu"], batches[1])
    cpu_graph_s = time.perf_counter() - t0
    same = {f"cuda graph B={b}": torch.equal(got[b], want[b])
            for b in batches}
    same["cpu graph B=1"] = torch.equal(cpu_got, cpu_want)
    same["torch-impl graph B=1"] = torch.equal(got_torch, want_torch)
    log(f"phase 9 (c') _cli export --platforms cuda,cpu: "
        f"{sum(files['cuda_cpu'].values())} bytes ({files['cuda_cpu']}); "
        f"--platforms cuda --attention_impl torch: "
        f"{sum(files['torch_impl'].values())} bytes; times (s) "
        + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
        + f"; graph nodes {({f'{a} on {d}': n for (a, d), n in nodes.items()})}"
        f"; the cpu graph at B=1 {cpu_graph_s:.2f} s, live CPU serving "
        f"{cpu_live_s:.2f} s  [{card}]")
    log(f"phase 9 (c') bit for bit (deterministic cuDNN on the card): "
        f"{same}; the cuda graph's launches over B = 1 and 8 {launched}, "
        f"the torch-impl graph's {torch_launched}; the torch-impl graph "
        f"calls {sorted(op for op in ops['torch_impl', str(dev)] if 'deepinpainting' in op)}")
    check(all(same.values()), f"(c') exported graphs vs live: {same}")
    check(f"{EM.SCAN_OP}.default" in ops["cuda_cpu", str(dev)]
          and f"{EM.SCAN_OP}.default" in ops["cuda_cpu", "cpu"],
          "(c') both platforms' graphs call the scan op")
    check(f"{EM.PLAIN_SCAN_OP}.default" in ops["torch_impl", str(dev)]
          and not any(op.startswith(f"{EM.SCAN_OP}.")
                      for op in ops["torch_impl", str(dev)])
          and nodes["torch_impl", str(dev)] == nodes["cuda_cpu", str(dev)],
          "(c') the torch-impl graph: the plain op, no scan op, no loop")
    check(launched == {"scan_stream": 2, "kbar_build": 0}
          and torch_launched == 0,
          "(c') one scan launch a cuda-graph call, none in the torch graph")
    for art in arts.values():
        shutil.rmtree(art, ignore_errors=True)
    log(f"phase 9 (c') took {time.perf_counter() - t_part:.1f} s  [{card}]")
    return {"exported_platforms": launched}


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


def dp_eval_rank(rank: int, url: str, root: str, cfg, p9_cfg,
                 epoch: int) -> None:
    """Phase 11 (d), one of two gloo ranks sharing the card: phase 5's
    networks restored from phase 9's checkpoint, evaluate() of `cfg`
    (int8) over the images of (d), then the data-parallel eval step on
    this rank's rows of their global batch.  Writes eval{r}.json (the
    per-image metrics, launches) and eval{r}.npy (fake_B of its rows)."""
    import torch
    from deepinpainting_torch.data import SelfRefDataset
    from deepinpainting_torch.engine.checkpoint import CheckpointManager
    from deepinpainting_torch.engine.evaluator import evaluate
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.parallel import mesh
    dev, group = gloo_rank(rank, url)
    try:
        models = CheckpointManager(p9_cfg).restore_models(epoch, dev)
        ds = SelfRefDataset(os.path.join(root, "d_val"),
                            os.path.join(root, "d_mask"), cfg.fine_size)
        TAC.launches = TAC.kbar_launches = 0
        res = evaluate(cfg, models, ds, device=dev, verbose=False,
                       return_per_image=True)
        with np.load(os.path.join(root, "d_batch.npz")) as f:
            batch = mesh.shard_batch(dict(f), rank, P11_WORLD)
        out = mesh.make_dp_eval_step(cfg, dev, group)(models, batch)
        np.save(os.path.join(root, f"eval{rank}.npy"),
                out["fake_B"].cpu().numpy())
        res["launches"] = {"scan_stream": TAC.launches,
                           "kbar_build": TAC.kbar_launches}
        with open(os.path.join(root, f"eval{rank}.json"), "w") as f:
            json.dump(res, f)
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


def dp_int8_eval(dev, card: str, root: str, dirs: dict, p9_cfg,
                 epoch: int) -> dict:
    """Phase 11 (d): evaluate() with quant='int8' on two gloo ranks sharing
    the card, over 8 of phase 7's validation images at global B=8 (the
    last 4, rank 1's rows, pulled to mid grey, so the ranks' activations'
    maxima differ), on phase 5's weights, against one process's int8
    evaluation of the same batch: per-image PSNR / SSIM and fake_B bit for
    bit, or, where cuDNN sums a 4-row batch in another order than an
    8-row one, within ENVELOPE_K x that order's own effect: the f32
    evaluation of the same rows as two 4-row halves against the 8-row
    batch, in max and in mean |d| (the control below is held to the mean,
    which one flipped attention patch cannot blow up).  Beside it, what a
    rank computed
    before the scale was global: each rank's rows evaluated alone.
    Returns the ranks' launches."""
    import torch
    from PIL import Image
    from deepinpainting_torch.data import SelfRefDataset
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.engine.checkpoint import CheckpointManager
    from deepinpainting_torch.engine.evaluator import evaluate
    from deepinpainting_torch.parallel import mesh
    t_part = time.perf_counter()
    cfg = p9_cfg.replace(quant="int8", batch_size=TRAIN_BATCH,
                         is_train=False, data_workers=0)
    val, masks = os.path.join(root, "d_val"), os.path.join(root, "d_mask")
    os.makedirs(val)
    shutil.copytree(dirs["mask"], masks)
    for i, name in enumerate(sorted(os.listdir(dirs["val"]))[:TRAIN_BATCH]):
        with Image.open(os.path.join(dirs["val"], name)) as im:
            img = np.asarray(im.convert("RGB")).astype(np.int16)
        if i >= TRAIN_BATCH // 2:
            img = 128 + (img - 128) // 4
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(val, f"x{i}.png"))
    ds = SelfRefDataset(val, masks, cfg.fine_size)
    items = [ds.fetch(i) for i in range(TRAIN_BATCH)]
    batch = {k: np.stack([x[k] for x in items]) for k in items[0]}
    np.savez(os.path.join(root, "d_batch.npz"), **batch)
    models = CheckpointManager(p9_cfg).restore_models(epoch, dev)
    step = TI.make_eval_step(cfg, dev)
    with deterministic_cudnn():
        one = evaluate(cfg, models, ds, device=dev, verbose=False,
                       return_per_image=True)
        want = step(models, batch)
        want_B = want["fake_B"].cpu().numpy()
        halves = np.concatenate([
            step(models, mesh.shard_batch(batch, r, P11_WORLD))["fake_B"]
            .cpu().numpy() for r in range(P11_WORLD)])
        # the f32 evaluation split as the ranks split it: what the batch
        # size alone does to cuDNN's sums
        f32_step = TI.make_eval_step(cfg.replace(quant="none"), dev)
        f32_whole = f32_step(models, batch)
        f32_halves = [f32_step(models, mesh.shard_batch(batch, r, P11_WORLD))
                      for r in range(P11_WORLD)]
    env = {k: float((torch.cat([h[k] for h in f32_halves]) - f32_whole[k])
                    .abs().max()) for k in ("fake_B", "psnr", "ssim")}
    # the mean as well: one attention patch that flips between the two
    # orders moves the max by O(1) (1.32 once), not the mean
    env["fake_B_mean"] = float((torch.cat([h["fake_B"] for h in f32_halves])
                                - f32_whole["fake_B"]).abs().mean())
    del models, step, want, f32_step, f32_whole, f32_halves
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_children(dp_eval_rank, [(r, f"file://{root}/rendezvous_d", root,
                                 cfg, p9_cfg, epoch)
                                for r in range(P11_WORLD)], "phase 11 (d)")
    d_s = time.perf_counter() - t0
    ranks = []
    for r in range(P11_WORLD):
        with open(os.path.join(root, f"eval{r}.json")) as f:
            ranks.append(json.load(f))
        ranks[-1]["fake_B"] = np.load(os.path.join(root, f"eval{r}.npy"))
    got_B = np.concatenate([x["fake_B"] for x in ranks])
    d_B = np.abs(got_B - want_B)
    d_m = {k: max(abs(a - b) for a, b in zip(ranks[0][f"{k}_per_image"],
                                             one[f"{k}_per_image"]))
           for k in ("psnr", "ssim")}
    bit = (d_B.max() == 0 and all(v == 0 for v in d_m.values())
           and ranks[0]["psnr_per_image"] == ranks[1]["psnr_per_image"])
    d_parent = np.abs(halves - want_B)
    log(f"phase 11 (d) int8 evaluate() on {P11_WORLD} gloo ranks sharing "
        f"the card, {one['images']} images at global B={TRAIN_BATCH} "
        f"(rank 1's rows at a quarter of the contrast), phase 5's weights: "
        f"against one process's int8 evaluation, fake_B max |d| "
        f"{d_B.max():.3e} mean {d_B.mean():.3e}, per-image PSNR max |d| "
        f"{d_m['psnr']:.3e} dB, SSIM {d_m['ssim']:.3e}, bit for bit: "
        f"{bit}; f32 as two 4-row halves against the 8-row batch (the "
        f"envelope, max |d|) {env}; PSNR {one['psnr']:.4f} dB SSIM "
        f"{one['ssim']:.4f} "
        f"(ranks "
        f"{ranks[0]['psnr']:.4f} / {ranks[0]['ssim']:.4f}); before the "
        f"global scale (each rank's rows evaluated alone): fake_B max |d| "
        f"{d_parent.max():.3e} mean {d_parent.mean():.3e}; launches a rank "
        f"{[x['launches'] for x in ranks]}; {d_s:.1f} s of ranks, the part "
        f"{time.perf_counter() - t_part:.1f} s  [{card}]")
    check(bit or (d_B.max() <= ENVELOPE_K * max(env["fake_B"], 1e-6)
                  and d_B.mean() <= ENVELOPE_K * max(env["fake_B_mean"],
                                                     1e-6)
                  and all(d_m[k] <= ENVELOPE_K * max(env[k], 1e-6)
                          for k in d_m)),
          "(d) two-rank int8 evaluation vs one process")
    check(ranks[0]["psnr_per_image"] == ranks[1]["psnr_per_image"]
          and ranks[0]["images"] == TRAIN_BATCH,
          "(d) the ranks' per-image metrics are the same")
    check(d_parent.max() > 0.0 if bit else
          d_parent.mean() > ENVELOPE_K * max(env["fake_B_mean"], 1e-6),
          "(d) the halves' own scales must move fake_B (the check bites)")
    check(all(x["launches"] == {"scan_stream": 2, "kbar_build": 0}
              for x in ranks),
          "(d) a scan launch a rank for evaluate()'s batch and the step's")
    return {k: sum(x["launches"][k] for x in ranks)
            for k in ("scan_stream", "kbar_build")}


def data_parallel(dev, card: str, small_batch: dict, plain_ms: float,
                  center, strokes, small, p9_cfg, epoch: int) -> dict:
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
        paths["dp_gloo_int8_eval"] = dp_int8_eval(dev, card, root, dirs,
                                                  p9_cfg, epoch)
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
SP_KNOB_TIMED = 3      # (e): timed int8 and packed requests
ULP = 2.0 ** -23       # (e), (c'): one ulp of 1.0
# (e), (c'): int8's own chaos is the one-process int8 forward's largest
# mean change over these relative nudges of the image (whole ulps: each
# one a different f32 image); (e) and (c') run the SP int8 request at the
# image and at the first four of them, and hold the median of its five
# distances to the one-process forward at the same images
INT8_NUDGES = tuple(k * ULP for n in range(1, 25) for k in (n, -n))
SP_INT8_DRAWS = (0.0,) + INT8_NUDGES[:4]


def count_collectives() -> dict:
    """Count this process's torch.distributed all_reduce and broadcast
    calls and their bytes, by the function that made them: the halo
    exchange, the gather of rows, the all-reduced sums of the norms and
    means (forward and backward each), int8's MAX of a scale, or the call
    itself (the gradient all-reduce, the request's broadcast).  Returns the live dict, {kind:
    [calls, bytes]}; clear it between the windows it measures."""
    import torch.distributed as dist
    counts = {}
    kinds = {"_HaloExchange": "halo", "_GatherRows": "gather",
             "_AllReduceSum": "sum", "all_reduce_max": "max"}

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


def check_int32_on_slabs(models):
    """Hook every conv of `models` on an sp rank: for each int8 conv that
    runs on a slab, whether its int32 sums (a transposed conv's on the
    halo'd slab cut to its own rows) and its activation scale equal, bit
    for bit, this rank's rows of the one-process int8 conv on the same
    whole tensor (the slabs' inputs gathered) and its scale.  A gathered
    level's conv runs on the whole tensor already and is counted only.
    Returns (the live {"slabs": [(sums equal, scale equal)], "whole": n},
    a function that removes the hooks)."""
    import torch
    from deepinpainting_torch.ops import convs, quant
    from deepinpainting_torch.parallel import collectives as C
    pending, seen = [], {"slabs": [], "whole": 0}
    dequantize = quant._dequantize

    def recorded(acc, sx, *a):
        pending.append((acc, sx))
        return dequantize(acc, sx, *a)

    def hook(module, inputs, y):
        if not pending:
            return
        acc, sx = pending.pop()
        sp = C.current_spatial()
        if sp is None:
            seen["whole"] += 1
            return
        rows = y.shape[2]
        acc = acc.narrow(2, (acc.shape[2] - rows) // 2, rows)
        xw = C.gather_rows(inputs[0], sp.group, sp.index, sp.size)
        w = module.weight.to(xw.dtype)
        with C.use_group(None), C.replicated():
            xq, sxw = quant.quantize_activation(xw)
        args = (module.stride[0], module.padding[0])
        if isinstance(module, convs.ConvTranspose2d):
            whole = quant.conv_transpose2d_int32(
                xq, quant.quantize_weight(w, transposed=True)[0], *args)
        else:
            whole = quant.conv2d_int32(xq, quant.quantize_weight(w)[0],
                                       *args, module.dilation[0])
        seen["slabs"].append((
            torch.equal(whole.narrow(2, sp.index * rows, rows), acc),
            torch.equal(sxw, sx)))

    quant._dequantize = recorded
    handles = [m.register_forward_hook(hook) for net in models
               for m in net.modules()
               if isinstance(m, (convs.Conv2d, convs.ConvTranspose2d))]

    def remove():
        quant._dequantize = dequantize
        for h in handles:
            h.remove()
    return seen, remove


def count_rewrites():
    """Count the pack rewrites' calls in this process (ops/convs.py looks
    them up by name).  Returns (the live {name: calls}, a function that
    puts the rewrites back)."""
    from deepinpainting_torch.ops import convs
    names = ("_conv2d_space_to_depth", "_conv2d_tap_stack",
             "_conv2d_hpack2", "_deconv_dpack4")
    calls, saved = {n: 0 for n in names}, {n: getattr(convs, n)
                                            for n in names}
    for n in names:
        def wrapped(*a, _n=n, _f=saved[n]):
            calls[_n] += 1
            return _f(*a)
        setattr(convs, n, wrapped)
    return calls, lambda: [setattr(convs, n, f) for n, f in saved.items()]


def packed_request(infer, models, req, rewrites: dict):
    """Phase 12 (e)'s packed request: `infer` (one process's, or a rank's
    on its slabs) on req = (image, mask, ref).  Returns ([fake_B, fake_P]
    on the host, {rewrite: calls})."""
    import torch
    for k in rewrites:
        rewrites[k] = 0
    out = [t.cpu().numpy() for t in infer(*models, *req)]
    torch.cuda.synchronize()
    return out, dict(rewrites)


def sp_infer_rank(rank: int, url: str, root: str, cfg, epoch: int) -> None:
    """Phase 12 (a), one of two gloo ranks sharing the card: phase 5's
    networks restored from phase 9's checkpoint, make_sp_inference_fn over
    both ranks, this rank's slab of the small-hole and the center-hole
    request, then SP_TIMED more small-hole requests timed; then (e): the
    same requests under int8 at SP_INT8_DRAWS' images (the first one's
    convs checked on the slabs), again with each slab's own maximum as
    its scale (a control), the small one with the pack modes, and
    SP_KNOB_TIMED of int8 and of packed requests timed.
    Writes sp_infer{r}.json (launches, collectives, ms) and .npz (the
    slabs)."""
    import torch
    from deepinpainting_torch.engine.checkpoint import CheckpointManager
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.ops import quant
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
        # -- (e) int8 at both holes, SP_INT8_DRAWS of each (the first
        # with its convs checked on the slabs), then the same with each
        # slab's own maximum as its scale (a control); the pack modes at
        # the small hole --
        out["e"] = {}
        qinfer = spatial.make_sp_inference_fn(cfg.replace(quant="int8"),
                                              dev, grid)
        real_max = quant.all_reduce_max
        for mode in ("int8", "int8_slab"):
            if mode == "int8_slab":
                quant.all_reduce_max = lambda x, group: x.detach().clone()
            TAC.launches = TAC.kbar_launches = 0
            counts.clear()
            record = {}
            try:
                for name in ("small", "center"):
                    r = reqs[name]
                    x = r["image"].astype(np.float32) / 127.5 - 1.0
                    for j, e in enumerate(SP_INT8_DRAWS):
                        seen, remove = (check_int32_on_slabs(models) if j == 0
                                        else ({}, lambda: None))
                        try:
                            fake_B, fake_P = qinfer(
                                *models, x * np.float32(1.0 + e), r["mask"],
                                r["ref"])
                            torch.cuda.synchronize()
                        finally:
                            remove()
                        if j == 0:
                            record[name] = seen
                        arrays[f"e_{mode}_{name}_{j}_B"] = fake_B.cpu().numpy()
                        arrays[f"e_{mode}_{name}_{j}_P"] = fake_P.cpu().numpy()
            finally:
                quant.all_reduce_max = real_max
            out["e"][mode] = {"record": record,
                              "launches": {"scan_stream": TAC.launches,
                                           "kbar_build": TAC.kbar_launches},
                              "collectives": {k: list(v)
                                              for k, v in counts.items()}}
        rewrites, _ = count_rewrites()
        small_req = tuple(reqs["small"][k] for k in ("image", "mask", "ref"))
        pinfer = spatial.make_sp_inference_fn(
            cfg.replace(pack_small_cin=True, pack_out=True), dev, grid)
        TAC.launches = TAC.kbar_launches = 0
        kout, calls = packed_request(pinfer, models, small_req, rewrites)
        out["e"]["packed"] = {"rewrites": calls, "launches": {
            "scan_stream": TAC.launches, "kbar_build": TAC.kbar_launches}}
        arrays.update({f"e_packed_small_{k}": v for k, v in zip("BP", kout)})
        for knob, kinfer in (("int8", qinfer), ("packed", pinfer)):
            TAC.launches = TAC.kbar_launches = 0
            ms = []
            for _ in range(SP_KNOB_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kinfer(*models, *small_req)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            out["e"][knob].update(ms=ms, timed_launches={
                "scan_stream": TAC.launches, "kbar_build": TAC.kbar_launches})
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
    """Phase 12 (c) and (c'), run by torch.distributed.run on two ranks:
    `_cli serve --sp` with `argv`, gloo in place of nccl (two ranks share
    the card).
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
            answers = {"u8": sess.run(img, mask, ref)}
            if "int8" in argv:      # (c'): SP_INT8_DRAWS of the request
                x = img.astype(np.float32) / 127.5 - 1.0
                answers["draws"] = np.stack([
                    sess.run(x * np.float32(1.0 + e), mask, ref)
                    for e in SP_INT8_DRAWS])
            np.savez(result_path + ".answer.npz", **answers)
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
                                  fine_size=s_bn), s_bn),
            # phase 12 (e): both pack modes on the slabs
            "packed": (Config(batch_size=TRAIN_BATCH, pack_small_cin=True,
                              pack_out=True), s)}
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
            {label: {k: sum(x[label]["launches"][k] for x in steps)
                     for k in ("scan_stream", "kbar_build")}
             for label in cfgs})


def sp_int8_check(card: str, ranks: list, whole: dict, e_draws: dict,
                  e_env: dict) -> dict:
    """Phase 12 (e)'s int8 checks, from (a)'s ranks, at each hole: each
    int8 conv on a slab bit for bit with the one-process int8 conv on the
    same whole tensor (check_int32_on_slabs), one MAX all-reduce of one
    f32 a sharded int8 conv, fake_P within INT8_GAP mean |d| of the
    one-process int8 forward at every draw, and the median over
    SP_INT8_DRAWS of fake_B's mean |d| within INT8_GAP or, where int8's
    own chaos is wider, within `e_env`, the one-process int8 forward's
    largest mean change over INT8_NUDGES (int8 on these weights moves
    by as much under a nudge of an ulp as SP's f32 sums move it).  Two
    controls: with each slab's own maximum as its scale the convs'
    scales must differ from the whole tensor's (the end-to-end figures
    are printed: on noise images that fault stays inside int8's own
    chaos), and the slabs put together in the wrong order must fail the
    fake_B limit.  Returns the launches by path."""
    n_draws = len(SP_INT8_DRAWS)
    for name in ("small", "center"):
        d = {mode: [[float(np.abs(whole[f"e_{mode}_{name}_{j}_{k}"]
                                  - e_draws[name][j][i]).mean())
                     for j in range(n_draws)] for i, k in enumerate("BP")]
             for mode in ("int8", "int8_slab")}
        med = {mode: statistics.median(v[0]) for mode, v in d.items()}
        limit = max(INT8_GAP, e_env[name]["B"])
        swapped = np.concatenate([x["arrays"][f"e_int8_{name}_0_B"]
                                  for x in reversed(ranks)], 1)
        d_swap = float(np.abs(swapped - e_draws[name][0][0]).mean())
        recs = {mode: [x["e"][mode]["record"][name] for x in ranks]
                for mode in d}
        sharded = len(recs["int8"][0]["slabs"])
        sums = [all(a for a, _ in r["slabs"]) for r in recs["int8"]]
        scales = {mode: [all(b for _, b in r["slabs"]) for r in rs]
                  for mode, rs in recs.items()}
        got = whole[f"e_int8_{name}_0_B"]
        u8 = lambda x: np.floor(np.clip((x + 1.0) * 127.5, 0, 255))
        same_u8 = float((u8(got) == u8(e_draws[name][0][0])).mean())
        fmt = lambda v: " ".join(f"{x:.3e}" for x in v)
        log(f"phase 12 (e) int8 SP request at the {name} hole: {sharded} "
            f"int8 convs on slabs (and {recs['int8'][0]['whole']} on "
            f"gathered levels), int32 sums bit for bit with the one-process "
            f"int8 conv on the same whole tensor, rank by rank: {sums}, "
            f"scales {scales['int8']}; against the one-process int8 forward "
            f"at the same images ({n_draws} draws: the image and 4 ulp "
            f"nudges): fake_B mean |d| {fmt(d['int8'][0])}, median "
            f"{med['int8']:.3e} (limit {limit:.3e}: {INT8_GAP}, or the "
            f"one-process int8 forward's largest mean change over "
            f"{len(INT8_NUDGES)} nudges of the image by 1 to "
            f"{len(INT8_NUDGES) // 2} ulps, "
            f"{e_env[name]['B']:.3e}), max "
            f"{np.abs(got - e_draws[name][0][0]).max():.3e}, uint8 pixels "
            f"equal {same_u8:.4%}; fake_P mean |d| "
            f"{fmt(d['int8'][1])} (limit {INT8_GAP}; its own largest nudge "
            f"change {e_env[name]['P']:.3e}); controls: each slab's own "
            f"maximum as its scale: scales equal rank by rank "
            f"{scales['int8_slab']}, fake_B mean |d| "
            f"{fmt(d['int8_slab'][0])} (median {med['int8_slab']:.3e}), "
            f"fake_P {fmt(d['int8_slab'][1])}; the slabs in the wrong order: "
            f"fake_B mean |d| {d_swap:.3e}  [{card}]")
        check(all(sums) and all(scales["int8"]) and sharded > 0
              and all(len(r["slabs"]) == sharded for r in recs["int8"]),
              f"(e) int8 sums and scales on slabs, {name} hole")
        check(all(x <= INT8_GAP for x in d["int8"][1]),
              f"(e) int8 SP fake_P, {name} hole")
        check(med["int8"] <= limit and np.isfinite(got).all(),
              f"(e) int8 SP fake_B, {name} hole")
        check(not all(scales["int8_slab"]),
              f"(e) control: each slab's own scale must fail the scale "
              f"check, {name} hole")
        check(d_swap > limit, f"(e) control: the slabs in the wrong order "
              f"must fail the fake_B limit, {name} hole")
    maxes = {mode: [x["e"][mode]["collectives"].get("max", [0, 0])
                    for x in ranks] for mode in ("int8", "int8_slab")}
    n_max = sharded * 2 * n_draws
    launches = {mode: [x["e"][mode]["launches"] for x in ranks]
                for mode in ("int8", "int8_slab")}
    timed = [x["e"]["int8"]["timed_launches"] for x in ranks]
    ms = ranks[0]["e"]["int8"]["ms"]
    log(f"phase 12 (e) int8 SP: MAX all-reduces (calls, bytes) a rank over "
        f"{2 * n_draws} requests {maxes['int8']} (the control's "
        f"{maxes['int8_slab']}); b1 p50 {statistics.median(ms):.2f} ms on "
        f"rank 0 ({SP_KNOB_TIMED} requests at the small hole, "
        f"{min(ms):.2f} to {max(ms):.2f}): not a scaling figure, two ranks "
        f"share the card; launches a rank {launches['int8']} (the "
        f"control's {launches['int8_slab']}), timed {timed}  [{card}]")
    check(all(m == [n_max, 4 * n_max] for m in maxes["int8"])
          and all(m == [0, 0] for m in maxes["int8_slab"]),
          "(e) one MAX all-reduce of one f32 a sharded int8 conv")
    one = {"scan_stream": 2 * n_draws, "kbar_build": 0}
    check(all(v == one for v in launches["int8"] + launches["int8_slab"])
          and all(v == {"scan_stream": SP_KNOB_TIMED, "kbar_build": 0}
                  for v in timed),
          "(e) int8: one scan launch a request on each rank")
    return {"sp_gloo_int8": {k: sum(v[k] for v in launches["int8"] + timed)
                             for k in ("scan_stream", "kbar_build")}}


def sp_packed_check(card: str, ranks: list, whole: dict,
                    e_packed) -> dict:
    """Phase 12 (e)'s packed checks, from (a)'s ranks: fake_B within
    E2E_TOL of the one-process packed forward at the small hole, each
    rank calling the rewrites one process calls.  Returns the launches by
    path."""
    (want, _), mine = e_packed
    d = np.abs(whole["e_packed_small_B"] - want)
    calls = [x["e"]["packed"]["rewrites"] for x in ranks]
    launches = [x["e"]["packed"]["launches"] for x in ranks]
    timed = [x["e"]["packed"]["timed_launches"] for x in ranks]
    ms = ranks[0]["e"]["packed"]["ms"]
    log(f"phase 12 (e) packed SP request at the small hole: fake_B against "
        f"the one-process packed forward max |d| {d.max():.3e} (limit "
        f"{E2E_TOL}); rewrites called by one process {mine}, by each rank "
        f"{calls}; b1 p50 {statistics.median(ms):.2f} ms on rank 0 "
        f"({SP_KNOB_TIMED} requests, {min(ms):.2f} to {max(ms):.2f}): not "
        f"a scaling figure; launches a rank {launches}, timed {timed}  "
        f"[{card}]")
    check(d.max() <= E2E_TOL, "(e) packed SP fake_B, small hole")
    check(all(c == mine for c in calls) and mine["_conv2d_hpack2"] > 0,
          "(e) the ranks pack the convs one process packs")
    check(all(v == {"scan_stream": 1, "kbar_build": 0} for v in launches)
          and all(v == {"scan_stream": SP_KNOB_TIMED, "kbar_build": 0}
                  for v in timed),
          "(e) packed: one scan launch a request on each rank")
    return {"sp_gloo_packed": {k: sum(v[k] for v in launches + timed)
                               for k in ("scan_stream", "kbar_build")}}


def sp_cli_serve(dev, card: str, part: str, extra, p9_cfg, epoch: int,
                 small_req, root: str, int8_env: float) -> dict:
    """Phase 12 (c) and (c'): `_cli serve --sp` with `extra` options (f32,
    or --quant int8) under torch.distributed.run on two gloo ranks: a
    POST over a socket, the answer against the one-process session's with
    the same options (f32: within 1 level on 99.9% of the values; int8:
    the median over SP_INT8_DRAWS' images of the mean |d| within INT8_GAP
    on [-1, 1], 6.4 levels, or, where int8's own chaos is wider,
    `int8_env`, the largest mean change in levels of the one-process int8
    serving function over INT8_NUDGES of the image), the follower leaving
    with the session.  Returns the launches by path."""
    from deepinpainting_torch.serve.app import InferenceSession
    s = p9_cfg.fine_size
    int8 = "int8" in extra
    result = os.path.join(root, part.replace("'", "_prime"))
    img, mask, ref = small_req
    np.savez(result + ".request.npz", image=img, mask=mask, ref=ref)
    args = ["--sp", "--checkpoints_dir", p9_cfg.checkpoints_dir,
            "--name", p9_cfg.name, "--which_epoch", str(epoch),
            "--static_dir", os.path.join(root, "static")] + extra
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
        log(f"  ({part}) {line}")
    check(res.returncode == 0, f"phase 12 ({part}): torch.distributed.run "
          f"exited {res.returncode}: {res.stderr[-3000:]}")
    c = []
    for r in range(P12_WORLD):
        with open(f"{result}.rank{r}.json") as f:
            c.append(json.load(f))
    with np.load(result + ".answer.npz") as f:
        sp_u8, sp_draws = f["u8"], f["draws"] if int8 else None
    with deterministic_cudnn():
        plain = InferenceSession(p9_cfg.replace(
            quant="int8" if int8 else p9_cfg.quant), epoch, device=dev)
        plain_u8 = plain.run(img, mask, ref)
        if int8:
            x = img.astype(np.float32) / 127.5 - 1.0
            d_draws = [float(np.abs(a.astype(np.int16) - plain.run(
                x * np.float32(1.0 + e), mask, ref).astype(np.int16)).mean())
                       for a, e in zip(sp_draws, SP_INT8_DRAWS)]
        plain.close()
    diff = np.abs(sp_u8.astype(np.int16) - plain_u8.astype(np.int16))
    same = float((diff == 0).mean())
    near = float((diff <= 1).mean())
    log(f"phase 12 ({part}) _cli serve --sp {' '.join(extra)} under "
        f"torch.distributed.run ({P12_WORLD} gloo ranks): POST /getImage -> "
        f"{c[0]['post_status']} {c[0]['location']} in "
        f"{c[0]['post_ms']:.1f} ms, GET /result "
        f"{c[0]['result_page']}, result image {c[0]['result_image']}; "
        f"the sp session's uint8 answer against the one-process "
        f"session's at the small hole: max |d| {diff.max()} level(s), mean "
        f"{diff.mean():.4f}, {same:.4%} equal, {near:.4%} within 1 level; "
        f"calls rank 0 {c[0]['calls']}, follower {c[1]['calls']};"
        f" grids {c[0]['grid']} / {c[1]['grid']}; both left the group: "
        f"{[x['group_left'] for x in c]}; {c_s:.1f} s  [{card}]")
    check(c[0]["post_status"] == 302 and c[0]["location"] == "/result",
          f"({part}) POST /getImage -> 302 /result")
    check(c[0]["result_page"] == ["200 OK", True]
          and c[0]["result_image"] == [s, s],
          f"({part}) /result shows the result image")
    if int8:
        limit = max(INT8_GAP * 127.5, int8_env)
        med = statistics.median(d_draws)
        log(f"phase 12 ({part}) the sp session's answers at the image and "
            f"4 ulp nudges ({len(d_draws)} draws) against the one-process "
            f"int8 session's at the same images: mean |d| "
            + " ".join(f"{v:.3f}" for v in d_draws) + f" levels, median "
            f"{med:.3f} (limit {limit:.2f}: {INT8_GAP * 127.5:.2f}, or the "
            f"one-process int8 serving function's largest mean change over "
            f"{len(INT8_NUDGES)} nudges of the image by 1 to "
            f"{len(INT8_NUDGES) // 2} ulps, {int8_env:.2f})")
        check(med <= limit, f"({part}) int8 sp answers within the mean "
              "limit of the one-process int8 session's")
    else:
        check(diff.max() <= 1 and same >= 0.999,
              f"({part}) sp answer within 1 level of the plain session's")
    check(c[1]["calls"] == c[0]["calls"] >= 3
          and c[0]["grid"] == [1, P12_WORLD, 0, 0]
          and c[1]["grid"] == [1, P12_WORLD, 0, 1]
          and all(x["group_left"] for x in c),
          f"({part}) the follower runs every call and leaves cleanly")
    check(all(x["launches"] == {"scan_stream": c[0]["calls"],
                                "kbar_build": 0} for x in c),
          f"({part}) one scan launch a call on each rank")
    return {"sp_cli_serve_int8" if int8 else "sp_cli_serve": {
        k: sum(x["launches"][k] for x in c)
        for k in ("scan_stream", "kbar_build")}}


def spatial_partitioning(dev, card: str, p9_cfg, epoch: int, small_req,
                         center_req, small_batch: dict, plain_ms: float,
                         plain_p50: float, bn_size: int = SP_BN_SIZE
                         ) -> dict:
    """Phase 12: spatial partitioning at p9_cfg's size, full width, f32,
    TF32 off.  (a) two gloo ranks sharing the card serve one request's
    rows on phase 5's weights, against the one-process forward; (b) the
    1 x 2 grid's train step at global B=8 in instance norm and
    norm='batch' (and with the pack modes, (e)), against the one-process
    step; (c) `_cli serve --sp` under torch.distributed.run on two gloo
    ranks, and (c') with --quant int8; (d) a group of one over NCCL, bit
    for bit with the plain path, and what the SP builders cost there; (e)
    int8 and packed requests in (a)'s ranks.  The two-rank times share
    one card and move rows through the host: they are no scaling figure.
    Returns the kernels' launches by path."""
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
            # (e): the small request with the pack modes
            rewrites, undo = count_rewrites()
            try:
                e_packed = packed_request(
                    TI.make_inference_fn(p9_cfg.replace(
                        pack_small_cin=True, pack_out=True), dev), models,
                    small_req, rewrites)
            finally:
                undo()
            # (e): the one-process int8 forward at SP_INT8_DRAWS' images,
            # and int8's own chaos, its largest mean change over
            # INT8_NUDGES (fake_B and fake_P); (c'): the same in uint8
            # levels of the serving function at the small hole
            qcfg = p9_cfg.replace(quant="int8")
            q_infer = TI.make_inference_fn(qcfg, dev)
            e_draws, e_env = {}, {}
            for n, (img, mask, ref) in reqs.items():
                imgf = img.astype(np.float32) / 127.5 - 1.0
                run = lambda e: [t.cpu().numpy() for t in q_infer(
                    *models, imgf * np.float32(1.0 + e), mask, ref)]
                e_draws[n] = [run(e) for e in SP_INT8_DRAWS]
                moved = [run(e) for e in INT8_NUDGES]
                e_env[n] = {k: max(float(np.abs(m[i] - e_draws[n][0][i])
                                         .mean()) for m in moved)
                            for i, k in enumerate("BP")}
            q_serve = TI.make_serving_fn(qcfg, dev)
            img, mask, ref = small_req
            imgf = img.astype(np.float32) / 127.5 - 1.0
            level = lambda e: q_serve(*models, imgf * np.float32(1.0 + e),
                                      mask, ref).cpu().numpy().astype(
                                          np.int16)
            at = level(0.0)
            e_levels = max(float(np.abs(level(e) - at).mean())
                           for e in INT8_NUDGES)
            del q_infer, q_serve
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
        paths.update(sp_int8_check(card, ranks, whole, e_draws, e_env))
        paths.update(sp_packed_check(card, ranks, whole, e_packed))
        paths["sp_gloo_infer"] = {
            "scan_stream": sum(x[name]["launches"]["scan_stream"]
                               for x in ranks for name in reqs)
            + sum(x["timed_launches"]["scan_stream"] for x in ranks),
            "kbar_build": 0}
        del models
        torch.cuda.empty_cache()

        # -- (b) the 1 x 2 grid's train step --
        figures["b"], step_launched = sp_train_steps(
            dev, card, s, small_batch, plain_ms, bn_size, root)
        paths["sp_gloo_steps"] = {
            k: sum(v[k] for label, v in step_launched.items()
                   if label != "packed") for k in ("scan_stream", "kbar_build")}
        paths["sp_gloo_packed_step"] = step_launched["packed"]

        # -- (c) `_cli serve --sp` under torch.distributed.run, and (c')
        # the same with --quant int8 --
        for part, extra in (("c", []), ("c'", ["--quant", "int8"])):
            paths.update(sp_cli_serve(dev, card, part, extra, p9_cfg, epoch,
                                      small_req, root, e_levels))

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


# ---- phase 13: reference checkpoints (convert/net_import.py, vgg_import.py) -

# SURVEY.md §2.2: the reference networks' parameter counts at full width
# (train.ipynb's printed counts), and VGG16's first ten convs (the four
# slices); G + P + VGG is Config()'s 139,747,014 (PERF.md §4).
REFERENCE_PARAMS = {"G": 77_692_291, "P": 54_419_459, "D": 2_766_529,
                    "F": 10_487_296, "vgg": 7_635_264}
FWD_TOL = 1e-5         # phase 13: stand-in forwards vs the imported port nets
# torchvision vgg16 `features`: (index, in, out) of each conv; the first ten
# feed the four slices, conv5 (24, 26, 28) is what a real file also holds
VGG16_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
               (10, 128, 256), (12, 256, 256), (14, 256, 256),
               (17, 256, 512), (19, 512, 512), (21, 512, 512),
               (24, 512, 512), (26, 512, 512), (28, 512, 512))
VGG16_POOLS = (4, 9, 16)     # features indices of the max-pools before 23


def reference_nets(ngf: int = 64, ndf: int = 64, norm: str = "instance",
                   num_downs: int = 8, feat_in: int = 256,
                   feat_width: int = 512) -> dict:
    """Stand-ins for the reference's networks in plain torch.nn, laid out
    as its models/networks.py builds them (SURVEY.md §2.2): nested
    nn.Sequential blocks whose pre-order walk meets the layers in
    execution order.  {"P": unet_256 (runnable), "G": unet_ipsr with
    nn.Identity where the IPSR, InnerCos and InnerCos2 layers sit (they
    hold no parameters; not runnable as the reference), "D": basic with
    n_layers=3 (runnable), "F": feature (runnable)}.  Norm layers are
    InstanceNorm2d(affine=True) or BatchNorm2d; netD's middle convs lose
    their bias under BatchNorm; netF's norm is InstanceNorm2d without
    affine parameters.  Weights stay at torch's defaults (fill_reference_
    draws them); under `torch.device("meta")` only the shapes exist."""
    import torch
    import torch.nn as nn

    def norm_layer(c):
        return (nn.InstanceNorm2d(c, affine=True) if norm == "instance"
                else nn.BatchNorm2d(c))

    class SkipBlock(nn.Module):
        """A U-Net level: `model` is down + [submodule] + up; a level other
        than the outermost concatenates [model(x), x]."""

        def __init__(self, layers, outermost):
            super().__init__()
            self.outermost = outermost
            self.model = nn.Sequential(*layers)

        def forward(self, x):
            y = self.model(x)
            return y if self.outermost else torch.cat([y, x], 1)

    def unet_block(outer, inner, input_nc=None, sub=None, outermost=False,
                   innermost=False):
        """UnetSkipConnectionBlock (networks.py:395-452)."""
        input_nc = input_nc or outer
        down = [nn.LeakyReLU(0.2), nn.Conv2d(input_nc, inner, 4, 2, 1)]
        if outermost:
            return SkipBlock([down[1], sub, nn.ReLU(),
                              nn.ConvTranspose2d(2 * inner, outer, 4, 2, 1),
                              nn.Tanh()], True)
        if innermost:
            return SkipBlock(down + [nn.ReLU(), nn.ConvTranspose2d(
                inner, outer, 4, 2, 1), norm_layer(outer)], False)
        return SkipBlock(down + [norm_layer(inner), sub, nn.ReLU(),
                                 nn.ConvTranspose2d(2 * inner, outer, 4, 2, 1),
                                 norm_layer(outer)], False)

    def ipsr_block(outer, inner, input_nc=None, sub=None, outermost=False,
                   innermost=False, attention=False):
        """UnetSkipConnectionBlock_3 (networks.py:212-278) and, with
        attention, the IPSR block (:281-366)."""
        input_nc = input_nc or outer
        relu, lrelu = nn.ReLU(), nn.LeakyReLU(0.2)
        if outermost:
            return SkipBlock([nn.Conv2d(input_nc, inner, 3, 1, 1), sub,
                              relu, nn.ConvTranspose2d(2 * inner, outer, 3,
                                                       1, 1)], True)
        dil = nn.Conv2d(input_nc, input_nc, 4, 2, 3, dilation=2)
        if innermost:
            return SkipBlock([lrelu, dil, relu, nn.ConvTranspose2d(
                input_nc, outer, 4, 2, 1), norm_layer(outer)], False)
        taps = [nn.Identity(), nn.Identity()] if attention else []
        down = [lrelu, dil, norm_layer(input_nc), nn.LeakyReLU(0.2),
                nn.Conv2d(input_nc, inner, 3, 1, 1)] + taps + [
                    norm_layer(inner)]
        up = [nn.Identity()] if attention else []
        up += [relu, nn.ConvTranspose2d(2 * inner, outer, 3, 1, 1),
               norm_layer(outer), nn.ReLU(),
               nn.ConvTranspose2d(outer, outer, 4, 2, 1), norm_layer(outer)]
        return SkipBlock(down + [sub] + up, False)

    class Generator(nn.Module):
        def __init__(self, block, input_nc, ipsr):
            super().__init__()
            b = block(ngf * 8, ngf * 8, innermost=True)
            for _ in range(num_downs - 5 + int(ipsr)):
                b = block(ngf * 8, ngf * 8, sub=b)
            b = (block(ngf * 4, ngf * 8, sub=b, attention=True) if ipsr
                 else block(ngf * 4, ngf * 8, sub=b))
            b = block(ngf * 2, ngf * 4, sub=b)
            b = block(ngf, ngf * 2, sub=b)
            self.model = block(3, ngf, input_nc=input_nc, sub=b,
                               outermost=True)

        def forward(self, x):
            return self.model(x)

    class Net(nn.Module):
        """A network whose `model` is one nn.Sequential."""

        def __init__(self, layers):
            super().__init__()
            self.model = nn.Sequential(*layers)

        def forward(self, x):
            return self.model(x)

    bias = norm == "instance"
    d_layers = [nn.Conv2d(3, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
    for n in range(1, 4):                  # NLayerDiscriminator, n_layers=3
        cin, cout = ndf * min(2 ** (n - 1), 8), ndf * min(2 ** n, 8)
        d_layers += [nn.Conv2d(cin, cout, 4, 2 if n < 3 else 1, 1, bias=bias),
                     norm_layer(cout), nn.LeakyReLU(0.2)]
    d_layers.append(nn.Conv2d(ndf * 8, 1, 4, 1, 1))
    return {
        "G": Generator(ipsr_block, 6, True),
        "P": Generator(unet_block, 3, False),
        "D": Net(d_layers),
        "F": Net([nn.Conv2d(feat_in, feat_width, 4, 2, 1), nn.LeakyReLU(0.2),
                  nn.Conv2d(feat_width, feat_width, 4, 2, 1),
                  nn.InstanceNorm2d(feat_width), nn.LeakyReLU(0.2),
                  nn.Conv2d(feat_width, feat_width, 4, 2, 1)]),
    }


def fill_reference_(net, generator, std: float = 0.02):
    """Draw every tensor of a stand-in from `generator` (a CPU
    torch.Generator), in state_dict order: conv weights from N(0, std), the
    reference's init_type='normal'; biases, norm offsets and running means
    from N(0, std), norm scales from N(1, std) and running variances from
    U(0.5, 1.5), where the reference starts from constants, so that every
    tensor differs and a misplaced one shows.  Returns `net`."""
    import torch
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("num_batches_tracked"):
                t.fill_(3)
                continue
            layer = net.get_submodule(name.rsplit(".", 1)[0])
            draw = torch.randn(t.shape, generator=generator) * std
            if name.endswith("running_var"):
                draw = 0.5 + torch.rand(t.shape, generator=generator)
            elif (name.endswith("weight")
                  and not isinstance(layer, (torch.nn.Conv2d,
                                             torch.nn.ConvTranspose2d))):
                draw += 1.0
            t.copy_(draw)
    return net


def reference_vgg_state_dict(generator, std: float = 0.02) -> dict:
    """A torchvision VGG16 `features.*` state_dict (the thirteen convs,
    conv5 included) drawn from `generator`: weights N(0, std), biases
    N(0, std)."""
    import torch
    sd = {}
    for idx, cin, cout in VGG16_CONVS:
        sd[f"features.{idx}.weight"] = torch.randn(
            (cout, cin, 3, 3), generator=generator) * std
        sd[f"features.{idx}.bias"] = torch.randn(
            (cout,), generator=generator) * std
    return sd


def torchvision_relu4_3(sd: dict, x):
    """relu4_3 of torchvision's `features` on x, recomputed from the state
    dict: conv 3x3 p1 + ReLU, max-pools at 4, 9 and 16, up to index 22."""
    import torch.nn.functional as F
    for idx, _, _ in VGG16_CONVS[:10]:
        if idx - 1 in VGG16_POOLS:
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(F.conv2d(x, sd[f"features.{idx}.weight"],
                            sd[f"features.{idx}.bias"], padding=1))
    return x


def reference_param_counts() -> dict:
    """The full-width stand-ins' parameter counts, built on the meta
    device (shapes only), and the first ten VGG convs'."""
    import torch
    with torch.device("meta"):
        nets = reference_nets()
    counts = {n: sum(p.numel() for p in net.parameters())
              for n, net in nets.items()}
    counts["vgg"] = sum(cout * cin * 9 + cout
                        for _, cin, cout in VGG16_CONVS[:10])
    return counts


def tensor_multiset_equal(a, b) -> bool:
    """The tensors of state_dicts a and b are the same multiset, bit for
    bit: sorted by shape and leading values, then compared in pairs."""
    import torch
    key = lambda t: (tuple(t.shape), t.flatten()[:4].tolist())
    ta = sorted(a.values(), key=key)
    tb = sorted(b.values(), key=key)
    return len(ta) == len(tb) and all(
        x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        for x, y in zip(ta, tb))


def reference_checkpoints(dev, card: str, base, small, small_batch,
                          n_b1: int = 20, seed: int = 13) -> dict:
    """Phase 13: reference checkpoints to served requests at base's size
    and widths (Config(batch_size=8) on the card).  Reference-layout
    stand-ins and a torchvision VGG16 state_dict drawn from `seed`; the
    VGG converted by `python -m deepinpainting_torch.convert.vgg_import`
    in a subprocess; G, P, D and F imported with net_import into a
    create_state state; the state saved with CheckpointManager and
    restored by InferenceSession(cfg, which_epoch).  Checks: (a) every
    imported and restored tensor equals the stand-ins' bit for bit, the
    runnable stand-ins' forwards (P, D, F) agree with the port's within
    FWD_TOL, the restored VGG's relu4_3 with torchvision's recomputation;
    (b) fake_B at the `small` hole with the scan kernel against the plain
    versions (E2E_TOL), one train step at base.batch_size from the
    imported nets with the kernels against the plain versions (STEP_TOL,
    losses), each path's launches.  Returns each path's launches."""
    import torch
    from deepinpainting_torch.convert import net_import
    from deepinpainting_torch.convert.vgg_import import VGG16_FEATURES_INDEX
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.engine.checkpoint import CheckpointManager
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.serve.app import InferenceSession

    t_phase = time.perf_counter()
    counts = lambda: {"scan_stream": TAC.launches,
                      "kbar_build": TAC.kbar_launches}
    paths = {}
    full = reference_param_counts()
    log(f"phase 13 stand-ins at full width: parameters {full}; G + P + VGG "
        f"= {full['G'] + full['P'] + full['vgg']}")
    check(full == REFERENCE_PARAMS, "stand-in parameter counts must equal "
          f"SURVEY.md's {REFERENCE_PARAMS}")
    check(full["G"] + full["P"] + full["vgg"] == 139_747_014,
          "G + P + VGG must equal Config()'s 139,747,014")

    os.makedirs(BUILD, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_phase13_", dir=BUILD)
    atexit.register(shutil.rmtree, root, True)
    s = base.fine_size
    gen = torch.Generator().manual_seed(seed)
    nets = reference_nets(ngf=base.ngf, ndf=base.ndf, norm=base.norm,
                          num_downs=s.bit_length() - 1,
                          feat_in=int(256 * base.vgg_width_scale),
                          feat_width=int(512 * base.vgg_width_scale))
    nets = {n: fill_reference_(net, gen).to(dev).eval()
            for n, net in nets.items()}
    vgg_sd = reference_vgg_state_dict(gen)
    pth, npz = os.path.join(root, "vgg16.pth"), os.path.join(root, "vgg16.npz")
    torch.save(vgg_sd, pth)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "deepinpainting_torch.convert.vgg_import",
         pth, npz], cwd=here, capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S, env=dict(os.environ, PYTHONPATH=here))
    convert_s = time.perf_counter() - t0
    check(res.returncode == 0, f"vgg_import exited {res.returncode}: "
          f"{res.stderr[-2000:]}")
    with np.load(npz) as raw:
        npz_keys = sorted(raw.files)
    log(f"phase 13 vgg_import: {os.path.getsize(pth)} byte .pth (13 convs, "
        f"conv5 included) -> {os.path.getsize(npz)} byte .npz, "
        f"{len(npz_keys)} arrays, {convert_s:.2f} s (a python -m "
        f"subprocess, its start included)  [{card}]")
    check(len(npz_keys) == 20, "the npz holds the ten slice convs")

    cfg = base.replace(vgg_weights=npz, checkpoints_dir=root,
                       name="phase13")
    state = TI.create_state(cfg, torch.Generator().manual_seed(cfg.seed),
                            dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in ("G", "P", "D", "F"):
        net_import.load_torch_module(getattr(state, n), nets[n])
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) * 1e3
    same = {n: tensor_multiset_equal(getattr(state, n).state_dict(),
                                     nets[n].state_dict())
            for n in ("G", "P", "D", "F")}
    log(f"phase 13 (a) net_import of G, P, D and F into a create_state "
        f"state: {import_ms:.1f} ms; every port tensor equals a stand-in "
        f"tensor bit for bit, none left or added: {same}  [{card}]")
    check(all(same.values()), "imported tensors must equal the stand-ins'")

    mgr = CheckpointManager(cfg)
    mgr.save(1, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = InferenceSession(cfg, 1, device=dev)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    G, P, vgg = sess.state
    restored = {n: all(torch.equal(t, live[k]) for k, t in
                       net.state_dict().items())
                for n, net, live in (("G", G, state.G.state_dict()),
                                     ("P", P, state.P.state_dict()))}
    restored["vgg"] = all(
        torch.equal(getattr(vgg, name).weight,
                    vgg_sd[f"features.{idx}.weight"].to(dev))
        and torch.equal(getattr(vgg, name).bias,
                        vgg_sd[f"features.{idx}.bias"].to(dev))
        for idx, name in VGG16_FEATURES_INDEX.items())
    log(f"phase 13 (a) checkpoint {mgr.last_save['bytes']} bytes in "
        f"{mgr.last_save['total_ms']:.1f} ms; InferenceSession(cfg, "
        f"which_epoch=1) restored G, P and VGG in {restore_ms:.1f} ms, bit "
        f"for bit with the import and the converted VGG: {restored}  "
        f"[{card}]")
    check(all(restored.values()), "the restored nets must equal the import")

    # -- (a) the runnable stand-ins against the imported port nets --
    rng = np.random.default_rng(seed)
    draw = lambda *shape: torch.from_numpy(rng.uniform(
        -1, 1, shape).astype(np.float32)).to(dev)
    x = draw(1, 3, s, s)
    feat = draw(1, nets["F"].model[0].in_channels, s // 8, s // 8).abs()
    fwd = {}
    with torch.no_grad():
        for n, port, inp in (("P", P, x), ("D", state.D.eval(), x),
                             ("F", state.F.eval(), feat)):
            want, got = nets[n](inp), port(inp)
            fwd[n] = ((got - want).abs().max().item(),
                      want.abs().max().item())
        want = torchvision_relu4_3({k: v.to(dev) for k, v in vgg_sd.items()},
                                   x)
        got = vgg(x).relu4_3
        fwd["vgg relu4_3"] = ((got - want).abs().max().item(),
                              want.abs().max().item())
    log("phase 13 (a) forwards, stand-in against the imported port net "
        "(max |d|, the stand-in's max |y|): " + ", ".join(
            f"{n} {d:.3e} ({m:.3e})" for n, (d, m) in fwd.items())
        + f" (limit {FWD_TOL})  [{card}]")
    check(all(d <= FWD_TOL and np.isfinite(d) for d, _ in fwd.values()),
          f"stand-in forwards against the port's beyond {FWD_TOL}")

    # -- (b) serving: the kernel against the plain scan, then requests --
    img = rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8)
    n_small = int(TI.prepare_masks(cfg, torch.from_numpy(small).float())[1]
                  .sum().item())
    ref = rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8)
    fb = {impl: TI.make_inference_fn(cfg.replace(attention_impl=impl), dev)(
        G, P, vgg, img, small, ref)[0] for impl in ("cuda", "torch")}
    d_small = (fb["cuda"] - fb["torch"]).abs().max().item()
    check(bool(torch.isfinite(fb["cuda"]).all()), "fake_B must be finite")
    check(d_small <= E2E_TOL, "imported nets: fake_B kernel vs plain")
    sess.run(img, small, ref)                  # warm-up
    calls0 = sess.calls
    TAC.launches = TAC.kbar_launches = 0   # counts: the imported session
    lat = []
    for _ in range(n_b1):
        t0 = time.perf_counter()
        out = sess.run(img, small, ref)
        lat.append((time.perf_counter() - t0) * 1e3)
    paths["reference_serving"] = counts()
    p50 = statistics.median(lat)
    log(f"phase 13 (b) serving the imported nets at a "
        f"{n_small}-position hole: fake_B kernel vs plain "
        f"max|d| {d_small:.3e} (limit {E2E_TOL}); b1 p50 {p50:.2f} ms "
        f"({n_b1} requests), launches {paths['reference_serving']}  [{card}]")
    check(out.dtype == np.uint8 and out.shape == (1, s, s, 3),
          "result must be uint8 [1, s, s, 3]")
    check(paths["reference_serving"] == {"scan_stream": sess.calls - calls0,
                                         "kbar_build": 0},
          "imported session: one scan launch a request, no kbar")
    sess.close()
    del sess, G, P, vgg

    # -- (b) one train step from the imported nets, kernels vs plain --
    losses = {}
    for n in ("G", "P", "D", "F"):
        getattr(state, n).train()
    TAC.launches = TAC.kbar_launches = 0   # counts: the step from the import
    _, m = TI.make_train_step(cfg.replace(attention_impl="cuda"), dev)(
        state, small_batch)
    losses["cuda"] = {k: v.item() for k, v in m.items()}
    paths["reference_step"] = counts()
    del state
    plain = mgr.restore(1, TI.create_state(
        cfg, torch.Generator().manual_seed(cfg.seed + 1), dev), dev)
    _, m = TI.make_train_step(cfg.replace(attention_impl="torch"), dev)(
        plain, small_batch)
    losses["torch"] = {k: v.item() for k, v in m.items()}
    del plain
    torch.cuda.empty_cache()
    d_step = max(abs(losses["cuda"][k] - losses["torch"][k])
                 / max(abs(losses["torch"][k]), 1e-12) for k in losses["cuda"])
    log(f"phase 13 (b) one train step at B={cfg.batch_size} from the "
        f"imported nets (the plain step's state restored from the "
        f"checkpoint), kernels vs plain: max relative loss difference "
        f"{d_step:.3e} (limit {STEP_TOL}); launches "
        f"{paths['reference_step']}; kernels {losses['cuda']}  [{card}]")
    check(all(np.isfinite(v) for v in losses["cuda"].values()),
          "every loss must be finite")
    check(d_step <= STEP_TOL, "imported nets: train-step losses, kernels vs "
          "plain versions")
    check(paths["reference_step"] == {"scan_stream": 1, "kbar_build": 1},
          "the step from the import: one scan and one kbar launch")
    shutil.rmtree(root, ignore_errors=True)
    log(f"phase 13 times: conversion {convert_s:.2f} s, import "
        f"{import_ms:.1f} ms, restore {restore_ms:.1f} ms, b1 p50 "
        f"{p50:.2f} ms; the phase {time.perf_counter() - t_phase:.1f} s  "
        f"[{card}]")
    return paths


# ---- phase 14: the quality protocols' runner (demo.py) at a cut depth -------

# data/synth.py's arguments at the cut depth: 24 training images (3
# steps of 8), 8 held-out, 256 px images trained at 128 px as the
# protocols are
P14_DATA = ("--n", "24", "--n_valid", "8", "--n_masks", "8", "--size", "256")
P14_TRAIN = ("--niter", "1", "--niter_decay", "0", "--data_workers", "2")


def protocol_runner(device: str, card: str) -> dict:
    """Phase 14: demo.py's own protocol code (run_protocol, judge,
    report) at a cut depth: every 128 px protocol's overrides for one
    epoch of 3 steps at full width, then f32's evaluations at epoch 1
    (f32, --faithful_known_replacement false, --quant int8), its int8
    fake_B gap and its POST.  Checks every loss finite, every evaluation's
    8 finite per-image PSNR and SSIM, each protocol's launches against
    what its steps, validation and evaluations make, and that the band
    check flags a fabricated miss: a figure out of band on seed 0 asks
    for seed 1, and on both makes report() return 1 naming it.  The real
    figures at this depth are not judged.  Returns the path's launches."""
    import math

    from deepinpainting_torch import demo
    from deepinpainting_torch.ops import attention_cuda as TAC

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_phase14_", dir=BUILD))
    atexit.register(shutil.rmtree, str(root), True)
    names = [n for n, p in demo.PROTOCOLS.items()
             if demo.DATA[p.data] == demo.DATA["synth"]]
    check(len(names) == 7, f"the 128 px protocols: {names}")
    TAC.launches = TAC.kbar_launches = 0    # counts: this path only
    runs, expected = {}, {"scan_stream": 0, "kbar_build": 0}
    for name in names:
        proto = demo.PROTOCOLS[name]
        evaluated = proto.serve       # f32: its three evaluations
        # a protocol that is not evaluated saves no checkpoint
        cut = demo.Cut(P14_DATA, P14_TRAIN + (
            "--save_epoch_freq", "1" if evaluated else "2"),
            evaluate=evaluated)
        t0 = time.perf_counter()
        before = (TAC.launches, TAC.kbar_launches)
        runs[name] = fig = demo.run_protocol(proto, root, 0, device, cut)
        got = {"scan_stream": TAC.launches - before[0],
               "kbar_build": TAC.kbar_launches - before[1]}
        cfg = demo.train_config(demo.COMMON + proto.overrides + cut.train)
        per_step = step_launches(cfg)
        steps = 24 // cfg.batch_size
        want = {"scan_stream": steps * per_step["scan_stream"]
                + -(-8 // cfg.batch_size)             # validation
                + steps * cfg.batch_size // cfg.display_freq,
                "kbar_build": steps * per_step["kbar_build"]}
        evals = [ev for ev in proto.evaluations if ev.epoch == 20] \
            if evaluated else []
        # each evaluation: one eval batch; f32's fake_B gap: two more;
        # its POST: the session's warm-up and the request
        want["scan_stream"] += len(evals) + (4 if evaluated else 0)
        check(got == want, f"phase 14 {name}: launches {got}, want {want}")
        for k in want:
            expected[k] += want[k]
        run_dir = root / "checkpoints" / f"{name}_seed0"
        with open(run_dir / "metrics.csv") as f:
            rows = list(csv.DictReader(f))
        losses = [float(v) for row in rows for k, v in row.items()
                  if k not in ("step", "time")]
        check(len(rows) == steps and all(map(math.isfinite, losses)),
              f"phase 14 {name}: {len(rows)} step rows, every loss finite")
        for ev in evals:
            text = (root / "logs" / f"{name}_seed0.eval_{ev.name}.log"
                    ).read_text()
            psnr, ssim = demo.per_image(text)
            check(len(psnr) == len(ssim) == 8
                  and all(map(math.isfinite, psnr + ssim)),
                  f"phase 14 {name} {ev.name}: 8 finite per-image PSNR "
                  f"and SSIM")
        last = ", ".join(f"{k} {float(v):.4f}" for k, v in rows[-1].items()
                         if k not in ("step", "time"))
        log(f"phase 14 {name} ({' '.join(proto.overrides) or 'f32'}): "
            f"{steps} steps, last losses {last}, launches {got}, "
            f"{time.perf_counter() - t0:.1f} s"
            + "".join(f"; {ev.name} PSNR {fig[f'psnr_{ev.name}']:.3f} SSIM "
                      f"{fig[f'ssim_{ev.name}']:.4f}" for ev in evals))
    f32 = runs["f32"]
    check(f32["served_ok"] and f32["fake_B_int8_gap"]["images"] == 8
          and f32["fake_B_int8_gap"]["finite"],
          "phase 14 f32: the POST and int8's fake_B gap")
    log(f"phase 14 f32: kr off dPSNR {f32['d_psnr_e20_kr']:.4f}, int8 "
        f"dPSNR {f32['d_psnr_e20_int8']:.4f} dSSIM "
        f"{f32['d_ssim_e20_int8']:.4f}, int8 fake_B gap "
        f"{f32['fake_B_int8_gap']['mean_d']:.5f} (not judged at this depth)")

    # the band check, on fabricated figures: each at its band's low end,
    # then one of them below it
    proto = demo.PROTOCOLS["f32"]
    inside = {k: lo for k, (lo, _) in demo.bands(proto).items()}
    outside = dict(inside, psnr_e20=inside["psnr_e20"] - 0.5)
    check(demo.judge(proto, inside) == [], "in-band figures pass")
    check(demo.judge(proto, outside) == ["psnr_e20"],
          "a figure below its band asks for the next seed")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code_both = demo.report({"f32": [dict(outside, seed=0),
                                         dict(outside, seed=1)]})
        code_one = demo.report({"f32": [dict(outside, seed=0),
                                        dict(inside, seed=1)]})
    check(code_both == 1 and "MISS f32 psnr_e20" in err.getvalue()
          and code_one == 0,
          f"report(): a miss on both seeds exits 1 naming it ({code_both}, "
          f"{err.getvalue().strip()!r}), a miss on one seed 0 ({code_one})")
    launches = {"scan_stream": TAC.launches, "kbar_build": TAC.kbar_launches}
    check(launches == expected, f"phase 14 launches {launches}")
    log(f"phase 14 band check: a fabricated miss exits {code_both} "
        f"({err.getvalue().strip().splitlines()[0]}); launches {launches}")
    errs = protocol_kernels_vs_plain(device, card, root)
    repeats = protocol_repeats(device, card, root)
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return {"paths": {"protocols": launches, "protocol_repeats": repeats},
            **errs}


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms (an op without a deterministic
    version raises), cuDNN's deterministic algorithms, no autotuning."""
    import torch
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = old[1:]


def repeat_runs(mode: str, device: str, root: Path) -> list:
    """Phase 14 (c)'s two runs of the f32 protocol's cut (3 steps at full
    width, demo.run_protocol) at seed 0 in `mode`; returns each run's
    launches."""
    from deepinpainting_torch import demo
    from deepinpainting_torch.ops import attention_cuda as TAC

    cut = demo.Cut(P14_DATA, P14_TRAIN + ("--save_epoch_freq", "2"),
                   evaluate=False)
    per_run = []
    for rep in (0, 1):
        proto = dataclasses.replace(demo.PROTOCOLS["f32"],
                                    name=f"repeat_{mode}{rep}", serve=False)
        TAC.launches = TAC.kbar_launches = 0    # counts: this run only
        with (deterministic_algorithms() if mode == "deterministic"
              else contextlib.nullcontext()):
            demo.run_protocol(proto, root, 0, device, cut)
        per_run.append((TAC.launches, TAC.kbar_launches))
    return per_run


def repeat_child(result_path: str, root: str, device: str) -> int:
    """Phase 14 (c)'s deterministic pair, in a process of its own started
    with CUBLAS_WORKSPACE_CONFIG=:4096:8 (cuBLAS reads it once, before its
    first call; the rest of the script keeps cuBLAS's default workspace).
    Writes the two runs' launches to `result_path`."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepinpainting_torch import _build
    _build.build(_build.KERNELS)
    per_run = repeat_runs("deterministic", device, Path(root))
    with open(result_path, "w") as f:
        json.dump(per_run, f)
    return 0


def protocol_repeats(device: str, card: str, root: Path) -> dict:
    """Phase 14 (c): the f32 protocol's cut run twice at seed 0 under
    cuDNN's default algorithms, whose largest per-step loss difference is
    reported (the protocol's 20 epochs turn such differences into its
    spread of outcomes), then twice under deterministic_algorithms() in a
    child process (repeat_child), which must agree bit for bit in every
    step's losses.  Returns the four runs' launches."""
    import math

    t0 = time.perf_counter()
    per_run = repeat_runs("default", device, root)
    result = root / "repeat_deterministic.json"
    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase14c",
         str(result), str(root), device], cwd=here, capture_output=True,
        text=True, timeout=CHILD_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=here,
                 CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    check(res.returncode == 0, "phase 14 (c): the deterministic pair's "
          f"process exited {res.returncode}: {res.stderr[-3000:]}")
    with open(result) as f:
        per_run += [tuple(run) for run in json.load(f)]
    launches = {"scan_stream": sum(r[0] for r in per_run),
                "kbar_build": sum(r[1] for r in per_run)}
    rows = {}
    for mode in ("default", "deterministic"):
        for rep in (0, 1):
            with open(root / "logs" /
                      f"repeat_{mode}{rep}_seed0.metrics.csv") as f:
                rows[mode, rep] = [{k: v for k, v in r.items()
                                    if k != "time"} for r in csv.DictReader(f)]
    losses = [float(v) for run in rows.values() for r in run
              for k, v in r.items() if k != "step"]
    check(all(map(math.isfinite, losses))
          and all(len(run) == len(rows["default", 0])
                  for run in rows.values()),
          "phase 14 (c): every run's losses finite, the same steps")
    check(len(set(per_run)) == 1 and per_run[0][0] > 0
          and per_run[0][1] > 0,
          f"phase 14 (c): each run launches both kernels alike {per_run}")
    diffs = [(abs(float(a[k]) - float(b[k])),
              abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-30))
             for a, b in zip(rows["default", 0], rows["default", 1])
             for k in a if k != "step"]
    d_abs, d_rel = max(d for d, _ in diffs), max(r for _, r in diffs)
    same = rows["deterministic", 0] == rows["deterministic", 1]
    log(f"phase 14 (c) the f32 protocol's {len(rows['default', 0])} cut "
        f"steps twice at seed 0: cuDNN defaults, largest loss difference "
        f"{d_abs:.3e} ({d_rel:.3e} relative); deterministic algorithms, "
        f"bit for bit {same}; launches a run {per_run[0]}; "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")
    check(same, "phase 14 (c): two runs under deterministic algorithms must "
          "agree bit for bit")
    return launches


def protocol_kernels_vs_plain(device: str, card: str, root: Path) -> dict:
    """Phase 14 (b), outside the counts: the kernels against their plain
    versions at the protocols' shape (128 px, B=8: N=256, C=512), on a
    batch the port's dataset makes from phase 14's images and masks.
    One f32 protocol train step from fresh weights with the kernels and
    again with the plain versions (losses within STEP_TOL), one evaluation
    batch of the same weights both ways (fake_B within E2E_TOL), and the
    scan and kbar kernels on the attention inputs of the kernels' step
    against their plain versions (the scan by phase 2's rule: DIRECT_TOL,
    or within ENVELOPE_K of the plain scan's own change under a PERTURB
    nudge of the features; kbar bit for bit).  Returns the kernels' max
    |d| from their plain versions."""
    import torch
    import torch.nn.functional as F

    from deepinpainting_torch import demo
    from deepinpainting_torch.data.dataset import InpaintDataset
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.ops import attention as TA
    from deepinpainting_torch.ops import attention_cuda as TAC

    data, _ = demo.make_data(root, P14_DATA)
    cfg = demo.train_config(list(demo.COMMON))
    ds = InpaintDataset(str(data / "img"), str(data / "mask"),
                        str(data / "img"), cfg.fine_size, seed=0)
    rng = np.random.default_rng(14)
    items = [ds.fetch(i, rng) for i in range(cfg.batch_size)]
    ds.close()
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    seen, core = [], TA.attention_core_batched

    def spy(feat, ref, flag, **kw):
        seen.append((feat.detach().clone(), ref.detach().clone(),
                     flag.detach().clone(), kw))
        return core(feat, ref, flag, **kw)

    losses, fake_B = {}, {}
    for impl in ("cuda", "torch"):
        icfg = cfg.replace(attention_impl=impl)
        state = TI.create_state(
            icfg, torch.Generator().manual_seed(cfg.seed), device)
        nets = (state.G, state.P)
        for net in nets:
            net.eval()
        fake_B[impl] = TI.make_inference_fn(icfg, device)(
            state.G, state.P, state.vgg, batch["image"], batch["mask"],
            batch["ref"])[0]
        for net in nets:
            net.train()
        if impl == "cuda":
            TA.attention_core_batched = spy
        try:
            _, m = TI.make_train_step(icfg, device)(state, batch)
        finally:
            TA.attention_core_batched = core
        losses[impl] = {k: v.item() for k, v in m.items()}
        del state, nets
    torch.cuda.empty_cache()
    d_step = max(abs(losses["cuda"][k] - losses["torch"][k])
                 / max(abs(losses["torch"][k]), 1e-12) for k in losses["cuda"])
    d_fake = (fake_B["cuda"] - fake_B["torch"]).abs().max().item()

    check(len(seen) == 1, f"one kbar build in the step, saw {len(seen)}")
    feat, ref, flag, kw = seen[0]
    rows = lambda t: t.flatten(2).transpose(1, 2).contiguous()
    flag = flag.to(torch.float32).contiguous()

    def scan_args(f):
        _, pn, ind, vmax, known = TA.prep(rows(f), rows(ref), flag,
                                          kw["known_replacement"])
        return ind.contiguous(), (flag, vmax.contiguous(), pn.contiguous(),
                                  known.contiguous())

    ind, args = scan_args(feat)
    k_out, k_a, k_b = TAC.scan_stream_cuda(*args)
    p_out, p_a, p_b = TA.scan_stream_reference(*args)
    nudged, _, _ = TA.scan_stream_reference(
        *scan_args(feat * (1.0 + PERTURB))[1])
    k_kbar = TAC.kbar_build_cuda(flag, ind, k_a, k_b)
    p_kbar = TA.kbar_build_reference(flag, ind, k_a, k_b)
    torch.cuda.synchronize()
    um = flag == 0
    onehot = F.one_hot(ind[um], flag.shape[1]).to(torch.float32)
    d_out = (k_out - p_out).abs().max().item()
    d_mean = (k_out - p_out).abs().mean().item()
    d_ab = max((k_a - p_a).abs().max().item(),
               (k_b - p_b).abs().max().item())
    chaos = (nudged - p_out).abs().max().item()
    chaos_mean = (nudged - p_out).abs().mean().item()
    d_kbar = (k_kbar - p_kbar).abs().max().item()
    log(f"phase 14 (b) kernels vs plain at the protocols' shape "
        f"(B={flag.shape[0]}, N={flag.shape[1]}, C={feat.shape[1]}, masked "
        f"{flag.mean().item():.2%}, the kernels' step's attention inputs): "
        f"scan d_out={d_out:.3e} d_out_mean={d_mean:.3e} d_ab={d_ab:.3e} "
        f"(limit {DIRECT_TOL}, or {ENVELOPE_K}x the plain scan's change "
        f"under a {PERTURB} nudge: max {chaos:.3e} mean {chaos_mean:.3e}); "
        f"kbar max|d| {d_kbar:.3e}, bit for bit "
        f"{torch.equal(k_kbar, p_kbar)}; the f32 step's losses max relative "
        f"difference {d_step:.3e} (limit {STEP_TOL}); an evaluation batch's "
        f"fake_B max|d| {d_fake:.3e} (limit {E2E_TOL}); kernels "
        f"{losses['cuda']}  [{card}]")
    check(bool(torch.equal(k_out[um], args[3][um])
               and (k_a[um] == 1).all() and (k_b[um] == 0).all()),
          "phase 14 (b): unmasked rows must be known and (1, 0)")
    check((d_out <= DIRECT_TOL and d_ab <= DIRECT_TOL)
          or (d_out <= ENVELOPE_K * max(chaos, 1e-6)
              and d_mean <= ENVELOPE_K * max(chaos_mean, 1e-2)),
          "phase 14 (b): scan kernel vs plain at the protocols' shape")
    check(torch.equal(k_kbar, p_kbar) and torch.equal(k_kbar[um], onehot),
          "phase 14 (b): kbar kernel must equal its plain version bit for "
          "bit")
    check(all(np.isfinite(v) for v in losses["cuda"].values())
          and bool(torch.isfinite(fake_B["cuda"]).all()),
          "phase 14 (b): finite losses and fake_B")
    check(d_step <= STEP_TOL, "phase 14 (b): the protocol step's losses, "
          "kernels vs plain versions")
    check(d_fake <= E2E_TOL, "phase 14 (b): fake_B, kernels vs plain")
    return {"max_abs_err": max(d_out, d_ab), "kbar_max_abs_err": d_kbar}


# ---- phase 15: the f32 protocol's first steps at full width, JAX's draw ----

# the JAX trainer's own init_params at seed 0 at the protocol's full width
# (studies/jax_draw.py pack: 6.8 MB, unpacked by numpy, every leaf's
# SHA-256 checked) and the JAX package's steps on the CPU from it on the
# same batches (studies/jax_cpu_protocol.py --run pairjax: per-step
# losses and 8x JAX's own one-ulp envelope)
P15_DRAW = "artifacts/jax_cpu_f32/jax_draw_ngf64_s0.npz"
P15_RECORD = "artifacts/jax_cpu_f32/fullwidth_s0/pair.json"
P15_STEPS = 8
P15_LOSS_RTOL = 1e-5   # D, F, G_L1, cosis at step 1 (no Adam step before)
P15_G_GAN_RTOL = 1e-3  # after D's and F's first Adam step (8x JAX's nudges)


def fullwidth_steps(device: str, card: str) -> dict:
    """Phase 15: the port's make_train_step at the f32 protocol's full
    width (demo.COMMON: 128 px, batch 8, ngf = ndf = 64, VGG at full
    width) from the JAX trainer's own seed-0 draw (P15_DRAW), on the first
    P15_STEPS batches its trainer draws from the protocol's data
    (data/synth.py, the port's loader: epoch 1's BatchIterator at seed 1).
    Step 1's losses are held to the JAX package's on the CPU from the same
    draw and batch (P15_RECORD): D, F, G_L1 and cosis within 1e-5
    relative, G_GAN within 1e-3.  Steps 2-8 are printed beside 8x JAX's
    one-ulp envelope (a departure over 1.0 of it is reported, not held:
    the loop is chaotic from step 2).  (b) netP's first gradient against
    its recomputation in f64 on the same device (the norms' statistics
    too), and so an f32 recomputation with cuDNN off: the largest and
    median relative error of a weight printed.
    Returns the path's launches."""
    import copy
    import math

    import torch

    from deepinpainting_torch import demo
    from deepinpainting_torch.convert.jax_bridge import load_flat
    from deepinpainting_torch.data import BatchIterator, InpaintDataset
    from deepinpainting_torch.engine import inpaint as TI
    from deepinpainting_torch.losses import l1_loss
    from deepinpainting_torch.ops import attention_cuda as TAC
    from deepinpainting_torch.ops import convs as TC
    from deepinpainting_torch.ops import masks as TM

    t_phase = time.perf_counter()
    here = Path(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, str(here / "studies"))
    import jax_draw
    t0 = time.perf_counter()
    nets, report = jax_draw.load(here / P15_DRAW, workers=os.cpu_count())
    check(report["exact"], f"phase 15: the packed draw's leaves {report}")
    load_s = time.perf_counter() - t0
    with open(here / P15_RECORD) as f:
        record = json.load(f)
    dev = torch.device(device)
    cfg = demo.train_config(list(demo.COMMON))
    check((cfg.fine_size, cfg.batch_size, cfg.ngf, cfg.ndf,
           cfg.vgg_width_scale) == (128, 8, record["ngf"], record["ngf"],
                                    1.0), "phase 15: the protocol's width")
    state = TI.create_state(cfg, torch.Generator().manual_seed(0), dev)
    for net in ("G", "P", "D", "F", "vgg"):
        load_flat(getattr(state, net), nets[net])
    del nets
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_phase15_", dir=BUILD))
    atexit.register(shutil.rmtree, str(root), True)
    t0 = time.perf_counter()
    data, _ = demo.make_data(root, demo.DATA["synth"])
    ds = InpaintDataset(f"{data}/img", f"{data}/mask", f"{data}/img",
                        cfg.fine_size, seed=cfg.seed)
    it = iter(BatchIterator(ds, cfg.batch_size, seed=cfg.seed + 1))
    batches = [next(it) for _ in range(P15_STEPS)]
    data_s = time.perf_counter() - t0
    P0 = copy.deepcopy(state.P)              # netP before its first step

    step = TI.make_train_step(cfg, dev)
    TAC.launches = TAC.kbar_launches = 0     # counts: this path only
    losses, first = [], None
    t0 = time.perf_counter()
    for batch in batches:
        _, m = step(state, batch)
        losses.append({k: float(m[k]) for k in record["jax_losses"][0]})
        if first is None:        # netP's first gradient: Adam's (1-b1) g
            first = [state.opt_P.state[p]["exp_avg"] / (1 - cfg.beta1)
                     for p in state.P.parameters()]
    steps_s = time.perf_counter() - t0
    launches = {"scan_stream": TAC.launches, "kbar_build": TAC.kbar_launches}
    per_step = step_launches(cfg)
    check(launches == {k: P15_STEPS * v for k, v in per_step.items()},
          f"phase 15 launches {launches}")
    check(all(math.isfinite(v) for m in losses for v in m.values()),
          "phase 15: every loss finite")

    jax1, card1 = record["jax_losses"][0], losses[0]
    rel = {k: abs(card1[k] - jax1[k]) / abs(jax1[k]) for k in jax1}
    log(f"phase 15 step 1 at full width from JAX's seed-0 draw "
        f"({report['leaves']} leaves, SHA-256 exact, unpacked in "
        f"{load_s:.1f} s; data {data_s:.1f} s): "
        + ", ".join(f"{k} {card1[k]:.6f} (JAX CPU {jax1[k]:.6f}, "
                    f"{rel[k]:.2e} rel)" for k in jax1))
    for k, v in rel.items():
        check(v <= (P15_G_GAN_RTOL if k == "G_GAN" else P15_LOSS_RTOL),
              f"phase 15 step 1 {k}: {card1[k]!r} against JAX's "
              f"{jax1[k]!r}, {v:.3e} relative")
    worst = []
    for i in range(1, P15_STEPS):
        ratio = {k: abs(losses[i][k] - record["jax_losses"][i][k])
                 / record["limit"][k][i] for k in jax1}
        worst.append(max(ratio.values()))
        log(f"phase 15 step {i + 1}: " + ", ".join(
            f"{k} {losses[i][k]:.4f} (JAX {record['jax_losses'][i][k]:.4f}, "
            f"{ratio[k]:.2f} of 8x JAX's envelope)" for k in jax1))

    # (b) netP's first gradient against its f64 recomputation
    gt = TI.normalize_image(torch.from_numpy(batches[0]["image"]).to(dev)
                            ).permute(0, 3, 1, 2)
    mask = TI.resolve_mask(cfg, TI.normalize_mask(
        torch.from_numpy(batches[0]["mask"]).to(dev)))
    P64 = copy.deepcopy(P0).double()
    gt64 = gt.double()
    f32_norm = TC.InstanceNorm.forward       # its statistics in f64 too
    TC.InstanceNorm.forward = lambda self, x: torch.nn.functional.\
        instance_norm(x, weight=self.weight, bias=self.bias, eps=self.eps)
    try:
        loss = l1_loss(P64(TM.fill_hole_with_mean(gt64, mask.double())),
                       gt64) * cfg.lambda_A
        g64 = torch.autograd.grad(loss, list(P64.parameters()))
    finally:
        TC.InstanceNorm.forward = f32_norm
    with torch.backends.cudnn.flags(enabled=False):   # ATen's own convs
        P32 = copy.deepcopy(P0)
        loss = l1_loss(P32(TM.fill_hole_with_mean(gt, mask)),
                       gt) * cfg.lambda_A
        native = torch.autograd.grad(loss, list(P32.parameters()))

    def weight_errors(grads) -> str:
        errs = {name: float((g.double() - ref).norm()
                            / ref.norm().clamp_min(1e-300))
                for (name, _), g, ref in zip(P64.named_parameters(), grads,
                                             g64) if name.endswith("weight")}
        top = max(errs, key=errs.get)
        return (f"largest {errs[top]:.2e} ({top}), median "
                f"{statistics.median(errs.values()):.2e}")
    log(f"phase 15 (b) netP's first gradient against its f64 recomputation, "
        f"relative error of a weight: the step's (cuDNN) "
        f"{weight_errors(first)}; recomputed in f32 without cuDNN "
        f"{weight_errors(native)}")
    log(f"phase 15: {P15_STEPS} steps in {steps_s:.1f} s, launches "
        f"{launches}; steps 2-{P15_STEPS} at most {max(worst):.2f} of 8x "
        f"JAX's envelope; {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return {"fullwidth_steps": launches}


def phase_only(run) -> int:
    """`python3 chip_smoke.py --phase 14` (or 15): the build and that phase
    alone, for working on it; prints no result line."""
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepinpainting_torch import _build
    _build.build(_build.KERNELS)
    run("cuda", card_line())
    return 0


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
        ("25% hole, N=256 (128 px)", 4, 8, 16, 16, [(4, 4, 8, 8)], True,
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
                        small, p9_cfg, TRAIN_STEPS)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # ---- phase 12: spatial partitioning, 256 px, full width ---------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = lambda t: t.cpu().numpy()
    p12 = spatial_partitioning(
        dev, card, p9_cfg, TRAIN_STEPS, (host(gt), small, host(ref)),
        (host(gt), center(), host(ref)), small_batch, steady, phase6["p50"])
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # ---- phase 13: reference checkpoints to served requests, 256 px -------
    torch.cuda.empty_cache()
    p13 = reference_checkpoints(dev, card, tcfg, small, small_batch)

    # ---- phase 14: the quality protocols' runner at a cut depth -----------
    torch.cuda.empty_cache()
    p14 = protocol_runner("cuda", card)
    max_abs_err = max(max_abs_err, p14["max_abs_err"])
    kbar_max_abs_err = max(kbar_max_abs_err, p14["kbar_max_abs_err"])

    # ---- phase 15: the f32 protocol's first steps from JAX's draw ---------
    torch.cuda.empty_cache()
    p15 = fullwidth_steps("cuda", card)

    # `launches` sums the main paths (serving, the train step, the trainer,
    # evaluate, phase 8's bf16 / remat / grad_accum paths, phase 9's
    # serving program, phase 10's int8 and packed paths, phase 11's
    # data-parallel paths, phase 12's spatially partitioned ones, each
    # rank's launches counted, phase 13's paths from the imported
    # reference checkpoints, phase 14's protocol runs and phase 15's
    # full-width steps from JAX's draw); the
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
                                             p12["paths"], p13,
                                             p14["paths"], p15)
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
    if sys.argv[1:2] == ["--phase14c"]:     # phase 14 (c)'s pair
        sys.exit(repeat_child(*sys.argv[2:5]))
    if sys.argv[1:3] == ["--phase", "14"]:  # the build and phase 14 alone
        sys.exit(phase_only(protocol_runner))
    if sys.argv[1:3] == ["--phase", "15"]:  # the build and phase 15 alone
        sys.exit(phase_only(fullwidth_steps))
    sys.exit(main())
