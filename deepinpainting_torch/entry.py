"""entry(): the flagship forward of the port — full two-stage 256x256
inpainting inference — with example arguments (counterpart of the JAX
package's `__graft_entry__.py::entry`).

    fn, args = entry()          # on the card; entry(device="cpu") on the CPU
    fake_B = fn(*args)          # [1, 256, 256, 3] f32, NHWC
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Config
from .device import DeviceLike, resolve_device
from .engine import init_params, make_inference_fn


def example_batch(b: int, s: int, seed: int = 0):
    """(img, mask, ref): [-1,1] f32 images and the center-square mask."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    ref = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    mask = np.zeros((b, s, s), np.float32)
    q = s // 4
    mask[:, q + 4: 3 * q - 4, q + 4: 3 * q - 4] = 1.0
    return img, mask, ref


def entry(device: DeviceLike = None, cfg: Config = None):
    """(fn, example_args): fn(G, P, vgg, gt, mask, ref) -> fake_B."""
    dev = resolve_device(device)
    cfg = cfg or Config(fine_size=256, is_train=False, use_dropout=False)
    models = init_params(cfg, torch.Generator().manual_seed(cfg.seed), dev)
    infer = make_inference_fn(cfg, dev)
    gt, mask, ref = (torch.from_numpy(a).to(dev)
                     for a in example_batch(1, cfg.fine_size))

    def fn(G, P, vgg, gt, mask, ref):
        fake_B, _ = infer(G, P, vgg, gt, mask, ref)
        return fake_B

    return fn, (models.G, models.P, models.vgg, gt, mask, ref)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape), out.dtype)
