"""The pieces of the port's spatial partitioning on 2 and 4 gloo ranks on
the CPU, each rank holding its slab of rows (H) of the same inputs,
against the same layer on the whole tensor in one process: every conv
geometry of the two U-Nets with its halo (netP's k4 s2 p1, netG's dilated
k4 s2 p3 d2, k3 s1 p1, the k3 s1 p1 and k4 s2 p1 transposed convs), the
gather and the slice with their gradients, InstanceNorm and a train-mode
BatchNorm, a checkpointed conv whose recompute runs in another thread,
the dropout's draw, and the refusals.

Each rank's objective is sum(y * w) over its rows, so the ranks' sum is
the whole tensor's: the input gradient of a rank is its rows of the whole
gradient, and the parameter gradients summed over the ranks are the whole
one (the sum-of-losses rule of parallel/spatial.py).  Inputs [2, 4, 16,
10]: slabs of 8 and 4 rows, W not H so that W's padding shows.  Tolerance
1e-6 (f32 sums split over slabs, in another order).
"""

import copy

import numpy as np
import pytest
import torch

import torch_dp_workers as W
from deepinpainting_torch.ops import convs

TOL = dict(rtol=1e-6, atol=1e-6)
WORLDS = (2, 4)
LAYERS = ("conv_k4s2p1", "conv_k4s2p3d2", "conv_k3s1p1", "convT_k3s1p1",
          "convT_k4s2p1", "instance_norm", "batch_norm")


def _layers(g):
    def filled(layer):
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(0.5 * torch.randn(p.shape, generator=g))
        return layer

    out = {"conv_k4s2p1": filled(convs.Conv2d(4, 3, 4, 2, 1)),
           "conv_k4s2p3d2": filled(convs.Conv2d(4, 4, 4, 2, 3, dilation=2)),
           "conv_k3s1p1": filled(convs.Conv2d(4, 3, 3, 1, 1)),
           "convT_k3s1p1": filled(convs.ConvTranspose2d(4, 3, 3, 1, 1)),
           "convT_k4s2p1": filled(convs.ConvTranspose2d(4, 3, 4, 2, 1)),
           "instance_norm": filled(convs.InstanceNorm(4)),
           "batch_norm": filled(convs.BatchNorm(4)).train()}
    with torch.no_grad():
        out["batch_norm"].running_var.uniform_(0.5, 1.5, generator=g)
    return out


def _whole(layer, x, w):
    """The layer on the whole tensor in one process: (y, x.grad, the
    parameters' gradients, its state after)."""
    x = x.clone().requires_grad_(True)
    y = layer(x)
    (y * w).sum().backward()
    return (y.detach(), x.grad,
            {k: p.grad for k, p in layer.named_parameters()},
            dict(layer.state_dict()))


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    g = torch.Generator().manual_seed(0)
    x = 1.0 + torch.randn(2, 4, 16, 10, generator=g)
    inputs = {"x": x, "w": torch.randn(2, 4, 16, 10, generator=g),
              "layers": {}}
    want = {}
    for name, layer in _layers(g).items():
        with torch.no_grad():
            wy = torch.randn(copy.deepcopy(layer)(x).shape, generator=g)
        inputs["layers"][name] = (layer, x, wy)
        want[name] = _whole(copy.deepcopy(layer), x, wy)
    runs = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"parts{world}")
        inputs["gather_w"] = torch.randn(world, *x.shape, generator=g)
        torch.save(inputs, tmp / "inputs.pt")
        W.run_ranks(W.sp_parts, world, tmp)
        runs[world] = (dict(inputs), [
            torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)])
    return want, runs


@pytest.mark.parametrize("name", LAYERS)
@pytest.mark.parametrize("world", WORLDS)
def test_layer_on_slabs_equals_the_whole_tensor(parts, world, name):
    want, runs = parts
    _, ranks = runs[world]
    wy, wgrad, wparams, wstate = want[name]
    got = [r[name] for r in ranks]
    np.testing.assert_allclose(torch.cat([g[0] for g in got], 2), wy, **TOL)
    np.testing.assert_allclose(torch.cat([g[1] for g in got], 2), wgrad,
                               **TOL)
    for k, v in wparams.items():
        np.testing.assert_allclose(sum(g[2][k] for g in got), v,
                                   rtol=1e-6, atol=1e-6 * float(
                                       v.abs().max()), err_msg=k)
    # the running statistics move by the whole tensor's moments, the same
    # on every rank (BatchNorm's; the other layers have none)
    for g in got:
        assert set(g[3]) == set(wstate)
        for k, v in wstate.items():
            np.testing.assert_allclose(g[3][k], v, **TOL, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_rows_and_its_gradient(parts, world):
    """Every rank reads the whole tensor; a rank's gradient is its rows of
    the sum of every rank's upstream gradient."""
    inputs, ranks = parts[1][world]
    total = inputs["gather_w"].sum(0)
    h = 16 // world
    for r, res in enumerate(ranks):
        y, gx = res["gather"]
        assert torch.equal(y, inputs["x"])
        np.testing.assert_allclose(gx, total[:, :, r * h:(r + 1) * h], **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_slice_rows_and_its_gradient(parts, world):
    """A rank's slab of a tensor every rank holds; its gradient is its
    rows' upstream gradient and zeros elsewhere, so the ranks' sum is the
    whole upstream gradient."""
    inputs, ranks = parts[1][world]
    h = 16 // world
    for r, res in enumerate(ranks):
        y, gx = res["slice"]
        assert torch.equal(y, inputs["x"][:, :, r * h:(r + 1) * h])
        assert not gx[:, :, :r * h].any() and not gx[:, :, (r + 1) * h:].any()
    assert torch.equal(sum(res["slice"][1] for res in ranks), inputs["w"])


@pytest.mark.parametrize("world", WORLDS)
def test_recompute_in_another_thread_keeps_the_spatial_context(parts,
                                                               world):
    want, runs = parts
    _, ranks = runs[world]
    wy, wgrad, _, _ = want["conv_k3s1p1"]
    assert all(r["remat"][2] == [True, True] for r in ranks)
    np.testing.assert_allclose(torch.cat([r["remat"][0] for r in ranks], 2),
                               wy, **TOL)
    np.testing.assert_allclose(torch.cat([r["remat"][1] for r in ranks], 2),
                               wgrad, **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_dropout_rows_are_the_one_process_draw(parts, world):
    inputs, ranks = parts[1][world]
    drop = convs.Dropout(0.5).train()
    want = drop(torch.ones_like(inputs["x"]),
                torch.Generator().manual_seed(11))
    assert torch.equal(torch.cat([r["dropout"] for r in ranks], 2), want)


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_name_their_cause(parts, world):
    """A slab too small for its halo and a stride-2 conv on an odd slab are
    refused, by name; the conv modes run on slabs: an int8 conv gives the
    whole tensor's rows bit for bit, a packed one within 1e-6."""
    ranks = parts[1][world][1]
    for res in ranks:
        got = res["refusals"]
        assert "cannot lend a halo of 3 row(s) above" in got["halo"]
        assert "k4 s2 p1 d1 conv cannot run on a slab of 3 rows" in got["odd"]
    for name, (modes, layer, x) in W.modes_convs().items():
        with torch.no_grad(), convs.use_modes(modes):
            want = layer(x)
        got = torch.cat([r[name] for r in ranks], 2)
        if name == "int8":
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL)
