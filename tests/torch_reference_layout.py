"""Reference-layout stand-ins for the importer tests (tests/test_torch_*).

The reference's networks (its models/networks.py) and torchvision's VGG16
are absent here, so the importers are held against stand-ins in their key
and module layout.  The builders are chip_smoke.py's own (its phase 13
drives them at full width on the card), so the tests check the very
stand-ins the card run imports; this module builds them at the tiny test
widths and runs the JAX package's importer on them, bridged into the
port's layout.
"""

from __future__ import annotations

import torch

from chip_smoke import (REFERENCE_PARAMS, VGG16_CONVS,  # noqa: F401
                        fill_reference_, reference_nets,
                        reference_param_counts, reference_vgg_state_dict,
                        torchvision_relu4_3)
from deepinpainting_tpu.convert.net_import import torch_module_to_variables
from deepinpainting_torch.convert.jax_bridge import bridge_state_dict
from deepinpainting_torch.engine import inpaint as TI

from torch_port_helpers import TINY, flat_of

NETS = ("G", "P", "D", "F")


def standins(norm: str = "instance", seed: int = 0, ngf: int = TINY["ngf"]):
    """The four stand-ins at the tiny widths (64 px, so 6 levels), weights
    drawn from `seed`, in eval mode on the CPU."""
    scale = TINY["vgg_width_scale"]
    nets = reference_nets(ngf=ngf, ndf=TINY["ndf"], norm=norm, num_downs=6,
                          feat_in=int(256 * scale),
                          feat_width=int(512 * scale))
    gen = torch.Generator().manual_seed(seed)
    return {n: fill_reference_(net, gen).eval() for n, net in nets.items()}


def port_nets(tcfg):
    """The port's G, P, D and F for `tcfg`, as its factories build them."""
    models, discs = TI.build_models(tcfg), TI.build_discriminators(tcfg)
    return {"G": models.G, "P": models.P, "D": discs.D, "F": discs.F}


def jax_import(standin, template, port_net):
    """The JAX package's import of `standin` onto its `template` (a params
    tree, or the variables dict with norm='batch'), as the port's
    state_dict through the weight bridge."""
    return bridge_state_dict(
        flat_of(torch_module_to_variables(standin, template)), port_net)
