"""A stand-in program of another model family, in plain torch, for the
tests of the harness's family hook (test_portbench_families.py): a gated
conv generator `coarse` (ELU of one half of its channels times the sigmoid
of the other) and a one-conv critic `critic` whose kernel is divided by a
spectral-norm estimate, from a power iteration kept in its buffer `u`,
trained with a hinge loss.  It takes no reference image and launches no
kernel of its own; serving coalesces requests through the program's
MicroBatcher."""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class Config:
    fine_size: int
    batch_size: int
    width: int
    dtype: str = "float32"
    metrics_every: int = 2
    lr: float = 1e-3
    beta1: float = 0.5
    init_gain: float = 0.05
    l1_weight: float = 1.0
    gan_weight: float = 0.1


class Coarse(nn.Module):
    """[image with its hole zeroed, hole] -> an RGB image in [-1, 1]."""

    def __init__(self, width: int):
        super().__init__()
        self.gate = nn.Conv2d(4, 2 * width, 3, padding=1)
        self.out = nn.Conv2d(width, 3, 3, padding=1)

    def forward(self, x):
        a, g = self.gate(x).chunk(2, dim=1)
        return torch.tanh(self.out(F.elu(a) * torch.sigmoid(g)))


class Critic(nn.Module):
    """A 4x4 stride-2 conv over the kernel divided by its largest singular
    value, estimated as u . W v after `iterate`."""

    def __init__(self, width: int):
        super().__init__()
        self.conv = nn.Conv2d(3, width, 4, stride=2, padding=1)
        self.register_buffer("u", torch.empty(width))

    def iterate(self) -> torch.Tensor:
        """One power iteration: v = W^T u / |.|, u <- W v / |.|; returns v."""
        with torch.no_grad():
            w = self.conv.weight.flatten(1)
            v = F.normalize(w.t() @ self.u, dim=0)
            self.u.copy_(F.normalize(w @ v, dim=0))
        return v

    def forward(self, x, v):
        w = self.conv.weight
        sigma = self.u @ (w.flatten(1) @ v)
        return F.conv2d(x, w / sigma, self.conv.bias, stride=2, padding=1)


@dataclass
class State:
    coarse: Coarse
    critic: Critic
    opt_coarse: torch.optim.Adam
    opt_critic: torch.optim.Adam


def create_state(cfg: Config, coarse: Coarse, critic: Critic) -> State:
    def adam(net):
        return torch.optim.Adam(net.parameters(), lr=cfg.lr,
                                betas=(cfg.beta1, 0.999), eps=1e-8)
    return State(coarse, critic, adam(coarse), adam(critic))


def _inputs(image, mask, dev):
    """uint8 NHWC image, uint8 [B,H,W] hole -> ([-1,1] NCHW image, hole
    [B,1,H,W], the generator's input)."""
    img = torch.as_tensor(image, device=dev).float().permute(0, 3, 1, 2)
    img = img / 127.5 - 1.0
    m = (torch.as_tensor(mask, device=dev) > 0).float()[:, None]
    return img, m, torch.cat([img * (1 - m), m], dim=1)


def _step(opt, params, loss) -> None:
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    opt.step()


def make_train_step(cfg: Config, dev):
    """(state, batch {'image', 'mask'}) -> (state, {'L1', 'GAN', 'D'}): the
    critic steps on the detached fill, then the generator against the
    updated critic."""
    def step(state: State, batch):
        img, m, x = _inputs(batch["image"], batch["mask"], dev)
        out = state.coarse(x)
        fake = out * m + img * (1 - m)
        v = state.critic.iterate()
        d = (F.relu(1 - state.critic(img, v)).mean()
             + F.relu(1 + state.critic(fake.detach(), v)).mean())
        _step(state.opt_critic, list(state.critic.parameters()), d)
        l1 = (out - img).abs().mean()
        gan = -state.critic(fake, v).mean()
        _step(state.opt_coarse, list(state.coarse.parameters()),
              cfg.l1_weight * l1 + cfg.gan_weight * gan)
        return state, {"L1": l1.detach(), "GAN": gan.detach(),
                       "D": d.detach()}
    return step


def make_serving_fn(cfg: Config, dev):
    """(coarse, image, mask) -> the uint8 answers [B,H,W,3]."""
    @torch.no_grad()
    def serve(coarse, image, mask):
        img, m, x = _inputs(image, mask, dev)
        fake = coarse(x) * m + img * (1 - m)
        u8 = torch.floor(torch.clamp((fake + 1.0) * 127.5, 0.0, 255.0))
        return u8.to(torch.uint8).permute(0, 2, 3, 1)
    return serve


class Session:
    """run(image, mask): one request through the batcher, more at once
    directly; one device call at a time."""

    def __init__(self, cfg: Config, coarse: Coarse, max_batch: int,
                 batch_wait_ms: float, dev):
        from deepinpainting_torch.serve.batcher import MicroBatcher
        self.coarse = coarse
        self._serve = make_serving_fn(cfg, dev)
        self._lock = threading.Lock()
        self._batcher = MicroBatcher(
            lambda s: self._call(s["image"], s["mask"]), max_batch,
            batch_wait_ms)

    def _call(self, image, mask):
        with self._lock:
            return self._serve(self.coarse, image, mask).cpu().numpy()

    def run(self, image, mask):
        if image.shape[0] == 1:
            return self._batcher.submit({"image": image[0],
                                         "mask": mask[0]})[None]
        return self._call(image, mask)

    def close(self) -> None:
        self._batcher.close()
