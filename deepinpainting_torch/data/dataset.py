"""Host image dataset: (gt, mask, ref) triples (the port's own copy of
deepinpainting_tpu/data/dataset.py; numpy and PIL only).

Capability parity with util/data_load.py:7-35 (Data_load) and its
byte-identical validation twin util/ref_data_load.py (Ref_Data_load):
  * images/refs globbed as `*.jpg` (plus `*.png`, which the app.py serving
    path relies on for uploaded PNGs — app.py:126-140 reuses Data_load on
    upload dirs), masks as `*.png`
  * gt:  Resize(fineSize) + Normalize(0.5,0.5)
  * mask: an independently RANDOM mask file per item (data_load.py:27),
    resized, channel 0, float in [0,1] with 1 = hole
  * ref: RandomResizedCrop(scale 0.8-1.0, ratio 1:1) + ColorJitter(0.1 x4)
    + Normalize (train.ipynb cell 1 transform_ref)

Returns NHWC numpy — uint8 by default (normalized to [-1,1] on the device
by engine/inpaint.py::normalize_image; 4x cheaper host->device transport),
float32 host-normalized with transport="float32".  Device placement
happens in the iterator (data/iterator.py::device_batches).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np
from PIL import Image

from . import transforms as T


def _glob_images(root: str, patterns=("*.jpg", "*.png")):
    paths = []
    for p in patterns:
        paths.extend(glob.glob(os.path.join(root, p)))
    return sorted(paths)


# ---------------------------------------------------------------------------
# process-pool loading (the role of torch DataLoader num_workers)
#
# PIL decode and the numpy/PIL augmentations hold the GIL, so thread pools
# do not scale host loading (measured flat at ~116 img/s @256px); spawned
# worker processes do. Each worker reconstructs the dataset once from its
# constructor spec (cheap: it only globs paths) and serves fetch() calls;
# items return as plain numpy dicts. "spawn" (not fork) keeps workers clear
# of the parent's threads and CUDA context.  A worker imports this module,
# and with it the package's __init__: neither imports torch, so a worker
# never loads torch and never touches the card.
# ---------------------------------------------------------------------------

_WORKER_DS = None


def _pool_init(cls, args, kwargs):
    global _WORKER_DS
    _WORKER_DS = cls(*args, **kwargs)


def _pool_fetch_batch(indices, rngs):
    """Assemble one whole stacked batch in the worker — one IPC round-trip
    per batch (per-item tasks measured SLOWER than serial: the pickle +
    scheduling overhead is comparable to the ~8 ms item work)."""
    items = [_WORKER_DS.fetch(int(i), r) for i, r in zip(indices, rngs)]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class InpaintDataset:
    def __init__(self, img_root: str, mask_root: str, ref_root: str,
                 fine_size: int = 256, *, augment_ref: bool = True,
                 seed: int = 0, mask_per_index: bool = False,
                 transport: str = "uint8"):
        self._ctor = (type(self), (img_root, mask_root, ref_root, fine_size),
                      dict(augment_ref=augment_ref, seed=seed,
                           mask_per_index=mask_per_index,
                           transport=transport))
        self._pool = None
        self._pool_workers = 0
        self._atexit_registered = False
        self.paths = _glob_images(img_root)
        self.ref_paths = _glob_images(ref_root)
        self.mask_paths = _glob_images(mask_root, ("*.png", "*.jpg"))
        if not self.paths:
            raise FileNotFoundError(f"no images under {img_root}")
        if not self.mask_paths:
            raise FileNotFoundError(f"no masks under {mask_root}")
        if not self.ref_paths:
            raise FileNotFoundError(f"no refs under {ref_root}")
        self.fine_size = fine_size
        self.augment_ref = augment_ref
        # mask_per_index=True gives deterministic eval (mask i for image i);
        # False is reference behavior (random mask per fetch).
        self.mask_per_index = mask_per_index
        # 'uint8' (default) ships raw pixels + 0/1 masks and normalizes on
        # device — 4x fewer host->device bytes; 'float32' normalizes on the
        # host (to_normalized_array).  Both produce BIT-IDENTICAL training
        # tensors: the [-1,1] map is the same f32 arithmetic either side.
        if transport not in ("uint8", "float32"):
            raise ValueError(f"unknown transport {transport!r}")
        self.transport = transport
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def _load_rgb(self, path: str) -> Image.Image:
        return Image.open(path).convert("RGB")

    def fetch(self, index: int,
              rng: Optional[np.random.Generator] = None
              ) -> Dict[str, np.ndarray]:
        """Load one item using an explicit generator — thread-safe when
        every concurrent caller brings its own `rng` (BatchIterator spawns
        one child generator per item; np.random.Generator is NOT safe to
        share across threads)."""
        rng = rng if rng is not None else self.rng
        s = self.fine_size
        gt = self._load_rgb(self.paths[index]).resize((s, s), Image.BILINEAR)

        if self.mask_per_index:
            mpath = self.mask_paths[index % len(self.mask_paths)]
        else:
            mpath = self.mask_paths[
                int(rng.integers(0, len(self.mask_paths)))]
        mask_img = self._load_rgb(mpath).resize((s, s), Image.BILINEAR)
        # .bool() semantics of the reference training loop (train.ipynb cell 2:
        # `mask.bool()`): any nonzero pixel is fully hole, so fractional
        # bilinear edges binarize up rather than blending.
        mask = (np.asarray(mask_img, np.float32)[..., 0] > 0).astype(
            np.float32)

        ref = self._load_rgb(self.ref_paths[index % len(self.ref_paths)])
        if self.augment_ref:
            ref = T.random_resized_crop(rng, ref, s)
            ref = T.color_jitter(rng, ref)
        else:
            ref = ref.resize((s, s), Image.BILINEAR)

        if self.transport == "uint8":
            return {"image": T.to_uint8_array(gt),
                    "mask": mask.astype(np.uint8),
                    "ref": T.to_uint8_array(ref)}
        return {"image": T.to_normalized_array(gt),
                "mask": mask,
                "ref": T.to_normalized_array(ref)}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.fetch(index)

    def get_pool(self, workers: int):
        """Persistent spawn-based worker pool, lazily (re)built when
        `workers` changes. Lives on the dataset so it survives across
        epochs/iterators.

        Constraint: concurrent iterators over ONE dataset must use the same
        worker count — a rebuild retires the old executor (queued futures
        still run, but any iterator still submitting to it will raise
        'cannot schedule new futures after shutdown' mid-epoch).  The pool
        is released by close() (registered atexit) or interpreter exit.
        """
        if self._pool is None or self._pool_workers != workers:
            import atexit
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            self.close()
            cls, args, kwargs = self._ctor
            self._pool = ProcessPoolExecutor(
                max_workers=workers, mp_context=mp.get_context("spawn"),
                initializer=_pool_init, initargs=(cls, args, kwargs))
            self._pool_workers = workers
            if not self._atexit_registered:  # once per dataset, not per
                atexit.register(self.close)  # rebuild (duplicates pin self)
                self._atexit_registered = True
        return self._pool

    def close(self):
        """Shut down the worker pool (in-flight batches finish; no new
        submissions).  Safe to call repeatedly; re-fetching via get_pool()
        builds a fresh pool."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
            self._pool_workers = 0

    def __getstate__(self):
        # the executor must not travel into worker processes
        d = dict(self.__dict__)
        d["_pool"] = None
        d["_pool_workers"] = 0
        d["_atexit_registered"] = False  # the copy never registered
        return d


class SelfRefDataset(InpaintDataset):
    """Eval-mode dataset: ref = the image itself, no augmentation
    (test.ipynb cell 3: `model.set_input(image, mask, image)`)."""

    def __init__(self, img_root: str, mask_root: str, fine_size: int = 256,
                 *, seed: int = 0, mask_per_index: bool = True,
                 transport: str = "uint8"):
        super().__init__(img_root, mask_root, img_root, fine_size,
                         augment_ref=False, seed=seed,
                         mask_per_index=mask_per_index, transport=transport)
        # own ctor signature differs from the base — fix the pool spec
        self._ctor = (type(self), (img_root, mask_root, fine_size),
                      dict(seed=seed, mask_per_index=mask_per_index,
                           transport=transport))

    def fetch(self, index: int,
              rng: Optional[np.random.Generator] = None
              ) -> Dict[str, np.ndarray]:
        item = super().fetch(index, rng)
        item["ref"] = item["image"]
        return item
