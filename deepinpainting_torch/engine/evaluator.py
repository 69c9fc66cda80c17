"""PSNR/SSIM over a test set (counterpart of
deepinpainting_tpu/engine/evaluator.py).

The reference's evaluation (test.ipynb cell 3): ref = the image itself,
per-image PSNR = 10*log10(4/MSE) on [-1,1] tensors, SSIM per IQA_pytorch,
a 2x2 (real_A, ref, fake_P, fake_B) grid per image, running prints, and
averages over the first `max_images` (reference: 500).

Data-parallel (torch.distributed initialized, parallel/mesh.py): each rank
runs the eval step on its rows of every padded global batch, the
per-image metrics (and, for grids, the images) are gathered in rank order
as host arrays, and the result is the same on every rank and the same as
one process's on the same images, int8 included: each int8 conv scales by
the maximum over the global batch (ops/quant.py), as one process's does.
Rank 0 alone prints and writes grids.

Spatially partitioned (cfg.sp_devices > 1 in a group; one process
evaluates whole images whatever sp_devices says, as the JAX package's
evaluator does): the ranks form the data x sp grid (parallel/spatial.py),
a rank takes its data group's rows and its slab of their rows, and the
eval step computes PSNR and SSIM on the gathered images (SSIM's windows
cross the slabs); the per-image metrics are gathered from the ranks of
slab 0.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data.iterator import BatchIterator, device_batches
from ..device import DeviceLike, resolve_device
from ..parallel import mesh, spatial
from ..parallel.collectives import all_gather_host
from ..utils import imaging


def _pad_tail(batches, batch_size: int):
    """Pad a ragged final batch to full size by repeating its last item,
    so every step sees one batch shape; the caller counts only the first N
    images, never the padded rows."""
    for batch in batches:
        short = batch_size - next(iter(batch.values())).shape[0]
        if short > 0:
            batch = {k: np.concatenate([v, np.repeat(v[-1:], short, axis=0)])
                     for k, v in batch.items()}
        yield batch


def evaluate(cfg: Config, state, dataset, *, max_images: int = 500,
             save_dir: Optional[str] = None, device: DeviceLike = None,
             verbose: bool = True,
             return_per_image: bool = False) -> Dict[str, float]:
    """Mean PSNR and SSIM over the first min(max_images, len(dataset))
    images of `dataset`, at cfg.batch_size, with `state` (G, P and vgg on
    `device`).  One host fetch of the metrics a batch; the images come to
    the host only when `save_dir` asks for grids."""
    dev = resolve_device(device)
    group = mesh.default_group()
    grid = None
    rank, rows, gather = 0, None, (lambda a: a)
    if group is not None:
        rank = torch.distributed.get_rank(group)
        world = torch.distributed.get_world_size(group)
        data_index, n_data, n_sp = rank, world, 1
        if cfg.sp_devices > 1:
            grid = spatial.make_dp_sp_groups(*mesh.grid_shape(
                cfg.batch_size, world, cfg.sp_devices))
            data_index, n_data, n_sp = grid.data_index, grid.n_data, \
                grid.n_sp
        rows = mesh.row_index(mesh.process_batch_rows(
            cfg.batch_size, data_index, n_data))

        def gather(a):
            # in rank order d * n_sp + s; the ranks of an sp group agree,
            # so slab 0's ranks give each data group's rows once
            parts = all_gather_host(a, group).reshape(n_data, n_sp, -1,
                                                      *a.shape[1:])
            return parts[:, 0].reshape(-1, *a.shape[1:])
    eval_step = mesh.make_dp_eval_step(cfg, dev, grid or group)
    verbose = verbose and rank == 0
    it = BatchIterator(dataset, cfg.batch_size, shuffle=False,
                       drop_last=False, workers=cfg.data_workers)
    total = min(max_images, len(dataset))
    per_psnr, per_ssim = [], []
    # Bound the stream at its source, so the generator chain ends by
    # itself: breaking out of device_batches would abandon the prefetch
    # thread blocked on its queue and leave pool work nobody reads.
    n_batches = -(-total // cfg.batch_size)
    batches = itertools.islice(_pad_tail(iter(it), cfg.batch_size),
                               n_batches)
    if rows is not None:           # this rank's rows of each global batch
        batches = ({k: v[rows] for k, v in b.items()} for b in batches)
    if grid is not None:           # and its slab of their rows
        batches = (spatial.slab(b, grid) for b in batches)
    for batch in device_batches(batches, dev):
        out = eval_step(state, batch)
        psnr_v, ssim_v = gather(torch.stack([out["psnr"], out["ssim"]], 1
                                            ).cpu().numpy()).T
        take = min(len(psnr_v), total - len(per_psnr))
        # every rank gathers the images that rank 0's grids show
        vis = ({k: gather(v.cpu().numpy())
                for k, v in out["visuals"].items()} if save_dir else None)
        for i in range(take):
            p, s = float(psnr_v[i]), float(ssim_v[i])
            per_psnr.append(p)
            per_ssim.append(s)
            n = len(per_psnr)
            if vis is not None and rank == 0:
                imaging.save_grid(
                    [vis[k][i]
                     for k in ("real_A", "real_Ref", "fake_P", "fake_B")],
                    os.path.join(save_dir, f"Eval_({n}).jpg"), nrow=2)
            if verbose:
                print("%d. PSNR : %f, SSIM : %f" % (n, p, s))
    n = len(per_psnr)
    result = {"psnr": sum(per_psnr) / max(n, 1),
              "ssim": sum(per_ssim) / max(n, 1), "images": n}
    if return_per_image:
        result["psnr_per_image"] = per_psnr
        result["ssim_per_image"] = per_ssim
    if verbose:
        print("PSNR_average : %.2f, SSIM_average : %.3f"
              % (result["psnr"], result["ssim"]))
    return result
