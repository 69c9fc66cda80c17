"""In-memory inference session (counterpart of
deepinpainting_tpu/serve/app.py::InferenceSession).

Built from a Config and the networks held in memory (or fresh ones drawn
from cfg.seed); every request is one call of the uint8-in / uint8-out
serving function (engine/inpaint.py::make_serving_fn).  With max_batch > 1
concurrent single requests coalesce into one batched call
(serve/batcher.py).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..device import DeviceLike, resolve_device
from ..engine.inpaint import Models, init_params, make_serving_fn


class InferenceSession:
    """state: Models(G, P, vgg) on `device` in eval mode, as init_params
    returns them; None draws fresh weights from cfg.seed."""

    def __init__(self, cfg: Config, *, state: Optional[Models] = None,
                 max_batch: int = 1, batch_wait_ms: float = 2.0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg.replace(is_train=False, mask_type="random",
                               batch_size=1)
        if state is None:
            gen = torch.Generator().manual_seed(self.cfg.seed)
            state = init_params(self.cfg, gen, self.device)
        self.state = state
        self._infer = make_serving_fn(self.cfg, self.device)
        self._lock = threading.Lock()   # device calls serialize
        self.calls = 0                  # batched serving calls made
        self._batcher = None
        if max_batch > 1:
            from .batcher import MicroBatcher
            self._batcher = MicroBatcher(
                lambda s: self._call(s["image"], s["mask"], s["ref"]),
                max_batch, batch_wait_ms)

    def _call(self, image, mask, ref) -> np.ndarray:
        with self._lock:
            u8 = self._infer(self.state.G, self.state.P, self.state.vgg,
                             image, mask, ref)
            self.calls += 1
            return u8.cpu().numpy()

    def warmup(self) -> None:
        s = self.cfg.fine_size
        z = np.zeros((1, s, s, 3), np.uint8)
        self.run(z, np.zeros((1, s, s), np.uint8), z)

    def run(self, image: np.ndarray, mask: np.ndarray, ref: np.ndarray
            ) -> np.ndarray:
        """image/ref: [1,H,W,3] uint8 (or [-1,1] f32); mask: [1,H,W] uint8
        0/1 (or f32).  Returns the inpainted uint8 [1,H,W,3]."""
        if self._batcher is not None and image.shape[0] == 1:
            u8 = self._batcher.submit(
                {"image": image[0], "mask": mask[0], "ref": ref[0]})
            return u8[None]
        return self._call(image, mask, ref)

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
