"""The stand-in family's part of the benchmark (its program is
standin_program.py): the tests copy this file to families/standin.py of a
temporary benchmark folder, and the harness loads it by path as it loads
families/ipsr.py.  Its reference is plain functional torch over the weight
dicts, written apart from the program's modules."""

from __future__ import annotations

import math
import statistics
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

import standin_program as SP

LIMITS = {"train": {"loss.step1", "grad1.worst_leaf", "delta3.worst_leaf"},
          "serve": {"u8.mean_levels"}}


def check_cell(config: Dict, kind: str, limits: Dict) -> None:
    want = LIMITS["train" if kind == "train" else "serve"]
    if set(limits) != want:
        raise ValueError(f"standin {kind} cells limit {sorted(want)}")


def program_config(fields: Dict) -> SP.Config:
    names = set(SP.Config.__dataclass_fields__)
    return SP.Config(**{k: v for k, v in fields.items() if k in names})


def networks(cfg, train: bool) -> Dict:
    with torch.device("meta"):
        nets = {"coarse": SP.Coarse(cfg.width)}
        if train:
            nets["critic"] = SP.Critic(cfg.width)
    return nets


def leaf_std(cfg):
    """Kernels from N(0, init_gain); the power iteration's u from N(0, 1),
    since a u of zeros stays zero and leaves the critic's scale 0."""
    def std(net, key, shape):
        if len(shape) == 4:
            return cfg.init_gain
        return 1.0 if key == "u" else None
    return std


def train_state(cfg, nets):
    return SP.create_state(cfg, nets["coarse"], nets["critic"])


def train_step(cfg, dev):
    return SP.make_train_step(cfg, dev)


def trained(state) -> Dict:
    return {"coarse": (state.coarse, state.opt_coarse),
            "critic": (state.critic, state.opt_critic)}


def session(cfg, nets, traffic: Dict, dev):
    return SP.Session(cfg, nets["coarse"].eval(), traffic["max_batch"],
                      traffic["batch_wait_ms"], dev)


def inputs(pool: Dict, rows) -> Dict:
    return {"image": pool["image"][rows], "mask": pool["mask"][rows]}


def flops(kind: str, shapes: Dict, cfg) -> Dict[str, float]:
    """An image's conv operations, 2 * weight elements * output pixels a
    forward: the generator's at full size; in training its backward twice
    that, and the critic's (at half size) three forwards, two weight
    gradients (its own phase) and one input gradient (the generator's)."""
    s = cfg.fine_size
    gen = sum(2.0 * math.prod(v) * s * s
              for v in shapes["coarse"].values() if len(v) == 4)
    if kind == "serve":
        return {cfg.dtype: gen}
    critic = 2.0 * math.prod(shapes["critic"]["conv.weight"]) * (s // 2) ** 2
    return {cfg.dtype: 3 * gen + 6 * critic}


def launches() -> Dict[str, int]:
    return {}


def bounds(w, cfg, pool: Dict, dev) -> Dict[str, float]:
    return {}


def missing(w) -> float:
    return 0.0


# ---- the reference -----------------------------------------------------------

def _norm(batch, dev):
    img = torch.as_tensor(batch["image"], device=dev).float()
    img = img.permute(0, 3, 1, 2) / 127.5 - 1.0
    m = (torch.as_tensor(batch["mask"], device=dev) > 0).float()[:, None]
    return img, m


def _coarse(p, img, m):
    h = F.conv2d(torch.cat([img * (1 - m), m], dim=1), p["gate.weight"],
                 p["gate.bias"], padding=1)
    a, g = h.chunk(2, dim=1)
    return torch.tanh(F.conv2d(F.elu(a) * torch.sigmoid(g), p["out.weight"],
                               p["out.bias"], padding=1))


def _critic(p, u, v, x):
    w = p["conv.weight"]
    return F.conv2d(x, w / (u @ (w.flatten(1) @ v)), p["conv.bias"],
                    stride=2, padding=1)


def _adam_step(cfg, p, g, moments, t):
    """Bias-corrected Adam on the dict p, in place."""
    b1, b2 = cfg.beta1, 0.999
    with torch.no_grad():
        for k in p:
            m, v = moments.get(k, (0.0, 0.0))
            m = b1 * m + (1 - b1) * g[k]
            v = b2 * v + (1 - b2) * g[k] * g[k]
            moments[k] = (m, v)
            p[k] -= cfg.lr * (m / (1 - b1 ** t)) / (
                torch.sqrt(v / (1 - b2 ** t)) + 1e-8)


def _norms(tensors: Dict[str, Dict]) -> Dict[str, float]:
    return {f"{net}.{k}": float(torch.linalg.vector_norm(t.detach().double()))
            for net, sd in tensors.items() for k, t in sd.items()}


def train_reference(cfg, weights: Dict, batches, dev, prec=None) -> Dict:
    w = {net: {k: t.detach().clone().float().requires_grad_()
               for k, t in sd.items() if k != "u"}
         for net, sd in weights.items()}
    u = weights["critic"]["u"].clone().float()
    moments = {"coarse": {}, "critic": {}}
    losses, first = [], {}

    def update(net, loss, t):
        keys = list(w[net])
        g = dict(zip(keys, torch.autograd.grad(loss,
                                               [w[net][k] for k in keys])))
        first.setdefault(net, g)
        _adam_step(cfg, w[net], g, moments[net], t)

    for t, batch in enumerate(batches, 1):
        img, m = _norm(batch, dev)
        out = _coarse(w["coarse"], img, m)
        fake = out * m + img * (1 - m)
        with torch.no_grad():
            mat = w["critic"]["conv.weight"].flatten(1)
            v = F.normalize(mat.t() @ u, dim=0)
            u = F.normalize(mat @ v, dim=0)
        d = (F.relu(1 - _critic(w["critic"], u, v, img)).mean()
             + F.relu(1 + _critic(w["critic"], u, v, fake.detach())).mean())
        update("critic", d, t)
        l1 = (out - img).abs().mean()
        gan = -_critic(w["critic"], u, v, fake).mean()
        update("coarse", cfg.l1_weight * l1 + cfg.gan_weight * gan, t)
        losses.append({k: float(x.detach()) for k, x in
                       (("L1", l1), ("GAN", gan), ("D", d))})
    return {"losses": losses, "grad1": _norms(first),
            "delta3": _norms({net: {k: w[net][k] - weights[net][k]
                                    for k in w[net]} for net in w})}


@torch.no_grad()
def serve_reference(cfg, weights: Dict, batch: Dict, dev, prec=None):
    img, m = _norm(batch, dev)
    fake = _coarse(weights["coarse"], img, m) * m + img * (1 - m)
    u8 = torch.floor(torch.clamp((fake + 1.0) * 127.5, 0.0, 255.0))
    return u8.to(torch.uint8).permute(0, 2, 3, 1)


# ---- the numbers -------------------------------------------------------------

def _worst_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    median = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in ref)


def train_numbers(program: Dict, reference: Dict, cfg) -> Dict[str, float]:
    def objective(s):
        return cfg.l1_weight * s["L1"] + cfg.gan_weight * s["GAN"]
    p, r = program["losses"][0], reference["losses"][0]
    return {"loss.step1": abs(objective(p) - objective(r)) / abs(objective(r)),
            "grad1.worst_leaf": _worst_gap(program["grad1"],
                                           reference["grad1"]),
            "delta3.worst_leaf": _worst_gap(program["delta3"],
                                            reference["delta3"])}


def serve_numbers(answers: Dict, reference: Dict) -> Dict[str, float]:
    gaps = [np.abs(a.astype(np.int16) - reference[i].astype(np.int16)).mean()
            for i, got in answers.items() for a in got]
    return {"u8.mean_levels": float(np.mean(gaps)) if gaps else math.nan}


def train_note(program: Dict, reference: Dict) -> str:
    return f"step 1 losses {program['losses'][0]} / {reference['losses'][0]}"


def serve_note(answers: Dict) -> str:
    return f"{sum(len(v) for v in answers.values())} answers checked"
