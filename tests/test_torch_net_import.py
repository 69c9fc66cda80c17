"""Port vs JAX: the reference checkpoint importer (convert/net_import.py).

The same reference-layout stand-in goes through the JAX package's
torch_module_to_params / torch_module_to_variables (bridged into the
port's layout) and through the port's importer: the two state_dicts must
be equal bit for bit, for G, P, D and F under both norms.  The runnable
stand-ins' forwards (P, D, F) must match the imported port nets within
1e-5; each of the importer's refusals is raised; a port net whose children
were registered in another order imports the same.
"""

import pytest
import torch
import torch.nn as nn

from deepinpainting_torch.convert import (load_torch_module,
                                          torch_module_to_state_dict,
                                          torch_state_dict_to_module)
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops.convs import Dropout

from torch_port_helpers import configs, jax_params
from torch_reference_layout import (NETS, REFERENCE_PARAMS, jax_import,
                                    port_nets, reference_param_counts,
                                    standins)

FWD_TOL = 1e-5
NORMS = ("instance", "batch")


@pytest.fixture(scope="module", params=NORMS)
def world(request):
    """(norm, the JAX templates, the stand-ins, the port config)."""
    jcfg, tcfg = configs(norm=request.param)
    return request.param, jax_params(jcfg), standins(request.param), tcfg


@pytest.mark.parametrize("net", NETS)
def test_import_equals_jax_import(world, net):
    norm, templates, nets, tcfg = world
    port = port_nets(tcfg)[net]
    got = torch_module_to_state_dict(nets[net], port)
    want = jax_import(nets[net], templates[net], port)
    assert set(got) == set(want) == set(port.state_dict())
    for key, t in got.items():
        if key.endswith("num_batches_tracked"):
            # JAX has no counterpart: the bridge keeps the port's 0, the
            # importer copies the stand-in's
            assert t.item() == 3 and t.dtype == torch.int64
            continue
        assert t.dtype == want[key].dtype == torch.float32, key
        assert torch.equal(t, want[key]), key
    assert any(k.endswith("running_var") for k in got) == (
        norm == "batch" and net != "F")


@pytest.mark.parametrize("net", ("P", "D", "F"))
def test_forward_matches_standin(world, net):
    nets, tcfg = world[2], world[3]
    port = load_torch_module(port_nets(tcfg)[net], nets[net]).eval()
    size = 64 if net != "F" else 16
    channels = 3 if net != "F" else nets["F"].model[0].in_channels
    x = torch.randn((2, channels, size, size),
                    generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want, got = nets[net](x), port(x)
    assert got.shape == want.shape
    assert want.abs().max().item() > 1e-2     # not a vanishing output
    assert (got - want).abs().max().item() <= FWD_TOL


def _reverse_children(module):
    """Re-register every module's children in the reverse order."""
    for child in module.children():
        _reverse_children(child)
    items = list(module._modules.items())[::-1]
    module._modules.clear()
    module._modules.update(items)


@pytest.mark.parametrize("net", NETS)
def test_shuffled_registration_order_imports_the_same(world, net):
    nets, tcfg = world[2], world[3]
    want = torch_module_to_state_dict(nets[net], port_nets(tcfg)[net])
    shuffled = port_nets(tcfg)[net]
    order = [n for n, _ in shuffled.named_modules()]
    _reverse_children(shuffled)
    assert [n for n, _ in shuffled.named_modules()] != order
    got = load_torch_module(shuffled, nets[net]).state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_layer_count_mismatch_raises():
    nets = standins()
    _, tcfg = configs()
    with pytest.raises(ValueError, match="layer count mismatch"):
        torch_module_to_state_dict(nets["D"], port_nets(tcfg)["P"])


def test_kind_mismatch_raises():
    """A torch Conv2d landing on a port ConvTranspose2d of the same
    weight shape: the JAX importer sees two 'conv-any' slots."""
    nets = standins()
    _, tcfg = configs()
    up = nets["P"].model.model[3]             # the outermost ConvTranspose2d
    assert isinstance(up, nn.ConvTranspose2d)
    conv = nn.Conv2d(up.in_channels, up.out_channels, 4)
    conv.weight = nn.Parameter(up.weight.detach().clone())  # [I, O, 4, 4]
    conv.bias = up.bias
    nets["P"].model.model[3] = conv
    with pytest.raises(ValueError, match="kind mismatch at model.up_conv"):
        torch_module_to_state_dict(nets["P"], port_nets(tcfg)["P"])


@pytest.mark.parametrize("case", ["width", "bias"])
def test_shape_mismatch_raises(case):
    _, tcfg = configs()
    if case == "width":         # the same ladder at twice the width
        torch_net = standins(ngf=16)["P"]
        port = port_nets(tcfg)["P"]
    else:                       # netD under BatchNorm: no bias on conv1-3
        torch_net = standins("batch")["D"]
        port = port_nets(tcfg)["D"]
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_module_to_state_dict(torch_net, port)


@pytest.mark.parametrize("torch_norm,port_norm", [("instance", "batch"),
                                                  ("batch", "instance")])
def test_batchnorm_count_mismatch_raises(torch_norm, port_norm):
    torch_net = standins(torch_norm)["G"]
    _, tcfg = configs(norm=port_norm)
    with pytest.raises(ValueError, match="BatchNorm count mismatch"):
        torch_module_to_state_dict(torch_net, port_nets(tcfg)["G"])


def test_parameterless_children_skipped_unknown_ones_refused():
    """Dropout holds nothing and is skipped; a child with parameters and
    no execution-order entry is refused by name."""
    nets = standins()
    _, tcfg = configs(use_dropout=True)
    port = TI.build_models(tcfg).G
    assert any(isinstance(m, Dropout) for m in port.modules())
    load_torch_module(port, nets["G"])
    port.model.extra = nn.Conv2d(2, 2, 1)
    with pytest.raises(ValueError, match="'extra' has no execution-order"):
        torch_module_to_state_dict(nets["G"], port)


def test_state_dict_file_route(tmp_path):
    """torch_state_dict_to_module: a saved `{epoch}_net_P.pt` state_dict,
    a builder of the reference module, the port net."""
    nets = standins()
    _, tcfg = configs()
    path = tmp_path / "1_net_P.pt"
    torch.save(nets["P"].state_dict(), path)
    port = torch_state_dict_to_module(
        torch.load(path, weights_only=True), lambda: standins(seed=9)["P"],
        port_nets(tcfg)["P"])
    want = torch_module_to_state_dict(nets["P"], port_nets(tcfg)["P"])
    assert all(torch.equal(port.state_dict()[k], v) for k, v in want.items())


def test_full_width_parameter_counts():
    """The stand-ins at full width hold the reference's parameter counts
    (SURVEY.md §2.2), as do the port's networks; built on the meta
    device."""
    assert reference_param_counts() == REFERENCE_PARAMS
    c = REFERENCE_PARAMS
    assert c["G"] + c["P"] + c["vgg"] == 139_747_014
    from deepinpainting_torch.config import Config
    with torch.device("meta"):
        port = port_nets(Config())
    assert {n: sum(p.numel() for p in net.parameters())
            for n, net in port.items()} == {n: c[n] for n in NETS}

