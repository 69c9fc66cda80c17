"""int8 under data parallelism: each int8 conv's activation scale is the
maximum over the global batch, on every rank (ops/quant.py through
parallel/collectives.py::all_reduce_max), as the JAX package's
one-device program on the global batch takes it.

Two gloo ranks on the CPU evaluate 8 images at global batch 4 (the tiny
config, int8, bridged weights from a numpy seed): evaluate()'s per-image
PSNR / SSIM and the data-parallel eval step's fake_B equal one process's
evaluation of the same global batches within 1e-6.  In every batch the
two ranks' halves differ in contrast (rank 1's rows are pulled to mid
grey), so their activations' maxima differ: each rank's rows evaluated
alone in one process, which is what a rank computed when it scaled by
its own rows' maximum, move fake_B by far more than that (the check
bites).  The MAX all-reduce itself is exact and the same on every rank.

The same bridged weights and batches go through the JAX package's
data-parallel int8 eval step (make_dp_eval_step on a data mesh of 2 of
the 8 virtual CPU devices), whose scale is the global batch's by GSPMD:
the two ranks' fake_B is held against it by
tests/test_torch_quant.py::test_int8_entry_points_match_jax_int8's rule
(mean |d| <= 0.25 x JAX's own int8-vs-f32 gap), and each rank's rows
evaluated alone fail that rule.  An int8 input that lands on a rounding
tie in one package lands an ulp away in the other (their f32 sums differ
by ~1e-6), and the flipped level moves the whole batch: in the second
batch the port's fake_B is 0.139 from JAX's (JAX's own int8-vs-f32 gap
0.145) and, with the images one ulp (2^-23) larger or smaller, 3.2e-7
from it.  So the rule holds for the ranks' answer at the images or at
the images one ulp away (the ranks compute all three), and each rank's
rows alone fail it at all three.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_dp_workers as W
from deepinpainting_tpu.engine import state as JST
from deepinpainting_tpu.parallel import mesh as JM
from deepinpainting_torch.data import SelfRefDataset
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.engine.evaluator import evaluate
from deepinpainting_torch.parallel import mesh

from torch_port_helpers import configs, flat_dicts, jax_params, torch_models

S = 64
B = 4                   # the global batch: 2 rows a rank
TOL = 1e-6
ULP = 2.0 ** -23        # the images' relative nudges, one ulp of 1.0
JAX_GAP_SHARE = 0.25    # of JAX's own int8-vs-f32 gap (test_torch_quant.py)


def _images(seed, n):
    """n uint8 images; those in the second half of each global batch of B
    pulled towards mid grey (a quarter of the contrast)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
    low = (np.arange(n) % B) >= B // 2
    img[low] = (128 + (img[low].astype(np.int16) - 128) // 4).astype(
        np.uint8)
    return img


def _masks(n):
    mask = np.zeros((n, S, S), np.uint8)
    mask[0::2, 10:30, 34:50] = 1
    mask[1::2, 24:52, 8:30] = 1
    return mask


def _nudged(batch):
    """The batch with its images one ulp larger and one ulp smaller, as
    floats in [-1, 1]."""
    x = batch["image"].astype(np.float32) / 127.5 - 1.0
    return [dict(batch, image=x * np.float32(1.0 + e)) for e in (ULP, -ULP)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, tcfg = configs(batch_size=B, quant="int8", mask_type="random",
                      is_train=False, data_workers=0)
    jcfg, _ = configs()
    params = jax_params(jcfg, seed=4)
    models = torch_models(tcfg, flat_dicts(params,
                                           tmp_path_factory.mktemp("w")))
    root = tmp_path_factory.mktemp("data")
    dirs = {"val": str(root / "val"), "mask": str(root / "mask")}
    os.makedirs(dirs["val"])
    os.makedirs(dirs["mask"])
    for i, (im, m) in enumerate(zip(_images(1, 8), _masks(8))):
        Image.fromarray(im).save(os.path.join(dirs["val"], f"x{i}.png"))
        Image.fromarray(np.repeat(m[..., None] * 255, 3, -1)).save(
            os.path.join(dirs["mask"], f"m{i}.png"))
    batches = []
    for seed in (2, 3):
        img = _images(seed, B)
        batches.append({"image": img, "ref": img[::-1].copy(),
                        "mask": _masks(B)})
    g = torch.Generator().manual_seed(0)
    max_in = [torch.randn(3, 5, generator=g) for _ in range(2)]
    tmp = tmp_path_factory.mktemp("ranks")
    torch.save({"models": [net.state_dict() for net in models],
                "batches": batches + [n for b in batches for n in _nudged(b)],
                "max_in": max_in}, tmp / "inputs.pt")
    W.run_ranks(W.dp_int8, 2, tmp, tcfg, dirs)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return tcfg, models, dirs, batches, max_in, ranks, params


def test_two_rank_evaluate_equals_one_process(runs):
    cfg, models, dirs, _, _, ranks, _ = runs
    want = evaluate(cfg, models, SelfRefDataset(dirs["val"], dirs["mask"],
                                                S),
                    device="cpu", verbose=False, return_per_image=True)
    assert ranks[0]["evaluate"] == ranks[1]["evaluate"]
    got = ranks[0]["evaluate"]
    assert got["images"] == want["images"] == 8
    for k in ("psnr_per_image", "ssim_per_image"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=k)


def test_two_rank_fake_B_equals_the_global_batch_not_the_halves(runs):
    """fake_B of the ranks' rows is one process's on the global batch; a
    rank's rows alone (scaled by their own maximum) are not."""
    cfg, models, _, batches, _, ranks, _ = runs
    step = TI.make_eval_step(cfg, "cpu")
    for i, batch in enumerate(batches):
        got = torch.cat([r["fake_B"][i] for r in ranks])
        want = step(models, batch)["fake_B"]
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        halves = torch.cat([step(models, mesh.shard_batch(batch, r, 2))
                            ["fake_B"] for r in range(2)])
        assert float((halves - want).abs().max()) > 1e3 * TOL


def test_all_reduce_max_is_exact_on_every_rank(runs):
    *_, max_in, ranks, _ = runs
    want = torch.maximum(*max_in)
    for r, res in enumerate(ranks):
        assert torch.equal(res["max"], want)
        assert torch.equal(res["max_in_after"], max_in[r])   # not in place


def test_two_rank_fake_B_matches_jax_data_parallel_int8(runs):
    """The ranks' fake_B at the images or one ulp away against the JAX
    package's int8 eval step on a 2-device data mesh, by
    test_torch_quant.py's rule; the rows of each rank evaluated alone
    (their own maximum as the scale) fail it at all three."""
    cfg, models, _, batches, _, ranks, params = runs
    data_mesh = JM.make_mesh(jax.devices()[:2])
    step = TI.make_eval_step(cfg, "cpu")
    jax_out = {}
    for quant in ("none", "int8"):
        jcfg, _ = configs(batch_size=B, quant=quant, mask_type="random",
                          is_train=False)
        state = JM.replicate_state(JST.create_train_state(jcfg, params),
                                   data_mesh)
        dp = JM.make_dp_eval_step(jcfg, data_mesh)
        jax_out[quant] = [np.asarray(dp(state, JM.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}, data_mesh))["fake_B"],
            np.float64) for b in batches]
    n = len(batches)
    for i, batch in enumerate(batches):
        want, f32 = jax_out["int8"][i], jax_out["none"][i]
        own = np.abs(want - f32).mean()
        assert own > 0, "JAX's int8 path must differ from its f32 one"
        # the ranks' answers at the images and one ulp up and down
        got = [torch.cat([r["fake_B"][j] for r in ranks]).numpy()
               for j in (i, n + 2 * i, n + 2 * i + 1)]
        assert all(g.shape == want.shape and np.isfinite(g).all()
                   for g in got)
        d = [np.abs(g - want).mean() for g in got]
        assert min(d) <= JAX_GAP_SHARE * own, (d, own)
        halves = [torch.cat([step(models, mesh.shard_batch(b, r, 2))
                             ["fake_B"] for r in range(2)]).numpy()
                  for b in [batch] + _nudged(batch)]
        d_halves = [np.abs(h - want).mean() for h in halves]
        assert min(d_halves) > JAX_GAP_SHARE * own, (d_halves, own)
