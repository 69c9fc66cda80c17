"""Spatially partitioned inference (parallel/spatial.py::
make_sp_inference_fn) on 2 and 4 gloo ranks on the CPU, each rank holding
its slab of rows of one request, against the port's one-process forward
and against the JAX package's make_sp_inference_fn on the 8 virtual CPU
devices of tests/conftest.py, on the same bridged weights (seed 3) and
numpy inputs.

Tolerance 2e-4, that of the JAX package's
test_sp_inference_matches_single_device: the convs sum their slabs (and
the norms their sums) in another order, and the port's one-process
forward is within 1e-4 of JAX's (tests/test_torch_serving.py).  Requests:
a batch of 1 (the latency path) and a batch of 2 with two hole shapes,
each with the input masks ('random') and the fixed center hole
('center').  The bf16 compute dtype runs too, against the port's
one-process bf16 forward within 1e-2 (2.5 bf16 ulps at 1.0: the slabs'
convs round their sums to bf16 in another order).
"""

import jax
import numpy as np
import pytest
import torch

import torch_dp_workers as W
from deepinpainting_tpu import parallel as PP
from deepinpainting_torch.engine import inpaint as TI

from torch_port_helpers import configs, flat_dicts, jax_params, torch_models

TOL = dict(rtol=2e-4, atol=2e-4)
S = 64
WORLDS = (2, 4)
MASK_TYPES = ("random", "center")
BF16 = len(MASK_TYPES)          # the index of the bf16 config


def _request(b, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, S, S), np.uint8)
    mask[0, 16:48, 20:44] = 1
    if b > 1:
        mask[1, 40:52, 8:30] = 1
        mask[1, 6:14, 6:14] = 1
    return {"image": rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8),
            "mask": mask,
            "ref": rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfgs = [configs(mask_type=m) for m in MASK_TYPES] + [
        configs(mask_type="random", dtype="bfloat16")]
    params = jax_params(cfgs[0][0], seed=3)
    models = torch_models(cfgs[0][1], flat_dicts(
        params, tmp_path_factory.mktemp("w")))
    requests = [_request(1, 11), _request(2, 12)]
    one = [[TI.make_inference_fn(tcfg, "cpu")(
        *models, r["image"], r["mask"], r["ref"]) for r in requests]
        for _, tcfg in cfgs]
    mesh = PP.make_sp_mesh()
    assert mesh.devices.size == 8
    jax_sp = []
    for jcfg, _ in cfgs[:BF16]:
        fn = PP.make_sp_inference_fn(jcfg, mesh)
        outs = []
        for r in requests:
            placed = PP.place_spatial(
                {k: jax.numpy.asarray(v) for k, v in r.items()}, mesh)
            outs.append(tuple(np.asarray(o) for o in fn(
                params["G"], params["P"], params["vgg"], placed["image"],
                placed["mask"], placed["ref"])))
        jax_sp.append(outs)
    ranks = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"infer{world}")
        torch.save({"models": [net.state_dict() for net in models],
                    "requests": requests}, tmp / "inputs.pt")
        W.run_ranks(W.sp_infer, world, tmp, [tcfg for _, tcfg in cfgs])
        ranks[world] = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                        for r in range(world)]
    return requests, one, jax_sp, ranks


def _whole(ranks, ci, ri):
    """fake_B and fake_P of request ri under config ci, the ranks' slabs
    concatenated in rank order (NHWC: rows are axis 1)."""
    return tuple(torch.cat([r["outs"][ci][ri][k] for r in ranks], 1).numpy()
                 for k in (0, 1))


@pytest.mark.parametrize("mask_type", MASK_TYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_sp_inference_matches_one_process(runs, world, mask_type):
    requests, one, _, ranks = runs
    ci = MASK_TYPES.index(mask_type)
    for ri in range(len(requests)):
        got_B, got_P = _whole(ranks[world], ci, ri)
        want_B, want_P = one[ci][ri]
        np.testing.assert_allclose(got_P, want_P.numpy(), **TOL)
        np.testing.assert_allclose(got_B, want_B.numpy(), **TOL)


@pytest.mark.parametrize("mask_type", MASK_TYPES)
@pytest.mark.parametrize("world", WORLDS)
def test_sp_inference_matches_jax_sp(runs, world, mask_type):
    requests, _, jax_sp, ranks = runs
    ci = MASK_TYPES.index(mask_type)
    for ri in range(len(requests)):
        got_B, got_P = _whole(ranks[world], ci, ri)
        want_B, want_P = jax_sp[ci][ri]
        np.testing.assert_allclose(got_P, want_P, **TOL)
        np.testing.assert_allclose(got_B, want_B, **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sp_bf16_inference_matches_one_process(runs, world):
    requests, one, _, ranks = runs
    for ri in range(len(requests)):
        for got, want in zip(_whole(ranks[world], BF16, ri), one[BF16][ri]):
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-2,
                                       atol=1e-2)


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_slab(runs, world):
    """The outputs stay H-sharded, as the JAX package's out_shardings
    keep them: rank s holds rows [s*H/n, (s+1)*H/n), and the grid is the
    1 x n one of make_sp_group."""
    requests, _, _, ranks = runs
    for s, r in enumerate(ranks[world]):
        assert r["grid"] == (1, world, 0, s)
        for ri, req in enumerate(requests):
            for out in r["outs"][0][ri]:
                assert out.shape == (len(req["image"]), S // world, S, 3)
