"""Training state: the four trainable networks, the frozen VGG, their four
Adam optimisers and the step count (counterpart of
deepinpainting_tpu/engine/state.py).

The JAX package's TrainState is an immutable pytree that every step
replaces; here the networks and optimisers are the usual stateful PyTorch
objects, and a train step updates them in place and returns the same
TrainState.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import Config
from ..models.discriminators import NLayerDiscriminator, PFDiscriminator
from ..models.unet import UnetGenerator
from ..models.unet_ipsr import UnetGeneratorIPSR
from ..models.vgg16 import Vgg16


def make_optimizer(cfg: Config, net: torch.nn.Module) -> torch.optim.Adam:
    """Adam(lr, betas=(beta1, 0.999), eps=1e-8) over `net`'s parameters.

    torch's Adam and optax's `adam` (eps_root=0) put eps in the same place,
    m_hat / (sqrt(v_hat) + eps) with both moments bias-corrected first, so
    the two take the same step from the same gradients.  The learning rate
    lives in the param group, where set_learning_rate changes it between
    epochs without rebuilding the optimiser.
    """
    return torch.optim.Adam(net.parameters(), lr=cfg.lr,
                            betas=(cfg.beta1, 0.999), eps=1e-8)


TRAINED = ("G", "P", "D", "F")          # the networks the optimisers step
NETWORKS = TRAINED + ("vgg",)


@dataclass
class TrainState:
    step: int
    G: UnetGeneratorIPSR
    P: UnetGenerator
    D: NLayerDiscriminator
    F: PFDiscriminator
    vgg: Vgg16                  # frozen feature extractor
    opt_G: torch.optim.Adam
    opt_P: torch.optim.Adam
    opt_D: torch.optim.Adam
    opt_F: torch.optim.Adam

    @property
    def optimizers(self):
        return (self.opt_G, self.opt_P, self.opt_D, self.opt_F)

    def state_dict(self) -> dict:
        """Everything a resume needs: the step, the five networks'
        state_dicts (VGG included, as the JAX package's state holds it)
        and the four optimisers' (moments, step counts and learning
        rate).  The tensors are the live ones, not copies."""
        out = {"step": self.step}
        out.update((n, getattr(self, n).state_dict()) for n in NETWORKS)
        out.update((f"opt_{n}", getattr(self, f"opt_{n}").state_dict())
                   for n in TRAINED)
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Load what state_dict returned, in place; every network must
        match it exactly (strict)."""
        for n in NETWORKS:
            getattr(self, n).load_state_dict(sd[n], strict=True)
        for n in TRAINED:
            opt = getattr(self, f"opt_{n}")
            opt.load_state_dict(sd[f"opt_{n}"])
            # torch's Adam keeps a loaded `step` where the file was mapped
            # to; without capturable/fused it counts on the host (a step
            # count on the card costs a sync a parameter every step)
            for st in opt.state.values():
                st["step"] = st["step"].cpu()
        self.step = int(sd["step"])


def create_train_state(cfg: Config, G, P, D, F, vgg) -> TrainState:
    """Fresh optimiser state around networks that are already initialised
    and on their device."""
    return TrainState(step=0, G=G, P=P, D=D, F=F, vgg=vgg,
                      opt_G=make_optimizer(cfg, G),
                      opt_P=make_optimizer(cfg, P),
                      opt_D=make_optimizer(cfg, D),
                      opt_F=make_optimizer(cfg, F))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of all four optimisers (the schedules of
    engine/schedules.py step them together)."""
    for opt in state.optimizers:
        for group in opt.param_groups:
            group["lr"] = float(lr)
    return state


def current_learning_rate(state: TrainState) -> float:
    return float(state.opt_G.param_groups[0]["lr"])
