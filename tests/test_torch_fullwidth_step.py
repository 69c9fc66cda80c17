"""The port's first train step at the full width of the `f32` protocol
(deepinpainting_torch/demo.py: 128 px, ngf = ndf = 64, VGG at full
width), held to the JAX package's on the CPU, and the package's first
step tied to its TPU records.

  * test_step1_equals_jax: both packages' make_train_step once from the
    same weights (torch_trajectory.draw at seed 0, bridged) on one batch
    of synthetic scenes (data/synth.py) at batch 2; JAX with attention
    'lax', the port with its plain twins.  D, F, G_L1 and cosis within
    1e-5 relative; G_GAN, taken after D's and F's first Adam step,
    within G_GAN_RTOL; fake_P and VGG's relu4_3 of the reference within
    1e-5 of their largest entry, fake_B within 2e-5 (TENSOR_RTOL).
  * test_round2_record_departs_from_current_code: the step-1 rows of the
    seed-0 128 px TPU records (reads CSVs only).  The round-2 record
    (artifacts/train_demo/metrics.csv) departs in D and cosis from every
    record of the current code on the same first batch.
  * test_inner_cos_mean_is_f32_exact: the one step-1 figure outside
    JAX's one-ulp envelope at full width is cosis (6.1e-06 relative,
    artifacts/jax_cpu_f32/fullwidth_s0/README.md): JAX's f32 mean over
    the taps' 1M elements departs by that much from the f64 value of its
    own inputs, the port's by 2e-8.  The port's mean at that shape stays
    within 1e-6 of f64.
  * test_jax_init_step1_ties_to_round5_record (slow): JAX's own
    init_params at seed 0 and the first batch its trainer draws from the
    protocol's data, at the protocol's batch 8: JAX's step-1 losses within
    RECORD_RTOL of the round-5 record and outside it for round 2 in D
    and cosis, and the port, from the same weights and the batch its own
    loader draws, equal to JAX within step 1's limits.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_trajectory as TT
from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.engine import state as JST
from deepinpainting_tpu.models.vgg16 import apply_vgg16

from deepinpainting_torch import demo
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.losses import inner_cos_loss

from torch_port_helpers import configs, flat_of, torch_state

REPO = Path(__file__).resolve().parent.parent
PROTOCOL = demo.train_config(list(demo.COMMON))
FIELDS = dict(fine_size=PROTOCOL.fine_size, ngf=PROTOCOL.ngf,
              ndf=PROTOCOL.ndf, vgg_width_scale=PROTOCOL.vgg_width_scale,
              mask_type=PROTOCOL.mask_type, attention_impl="lax")
EXACT = ("D", "F", "G_L1", "cosis")
LOSS_RTOL = 1e-5
# G_GAN follows D's and F's first Adam step, lr * g / (|g| + eps) on
# every weight, whose sign a gradient near zero takes from its last bits.
# On this test's inputs eight one-ulp nudges of JAX's starting weights
# move JAX's own G_GAN by 2.0e-07 to 1.12e-04 relative; the limit is 8x
# the largest (the trajectory tests' factor), rounded up.  The port
# departs by 2.7e-04.
G_GAN_RTOL = 1e-3
# of the largest entry; fake_B's is measured: netG's ~100 f32 layers and
# the attention put two correct f32 implementations ~1e-5 apart (the
# port's CPU convolutions through oneDNN 1.30e-05; through ATen's own
# kernels 0.89e-05 to 1.08e-05 with the thread count)
TENSOR_RTOL = {"relu4_3": 1e-5, "fake_P": 1e-5, "fake_B": 2e-5}
RECORD_RTOL = 0.015     # the TPU's one-pass bf16 products move a loss <= 1%
RECORDS = {             # the seed-0 128 px TPU records of the current code
    "round5": "artifacts/kr_ablation/metrics_faithful.csv",
    "bf16": "artifacts/train_demo_bf16/metrics.csv",
    "corrected": "artifacts/train_demo_corrected/metrics_corrected.csv",
    "trunc": "artifacts/train_demo_corrected/metrics_trunc.csv",
    "cosis": "artifacts/train_demo_corrected/metrics_cosis.csv",
}
ROUND2 = "artifacts/train_demo/metrics.csv"


def step1_row(path: str) -> dict:
    with open(REPO / path) as f:
        row = next(csv.DictReader(f))
    assert int(row["step"]) == PROTOCOL.batch_size       # the first step
    return {k: float(row[k]) for k in TT.LOSSES}


def rel(a, b) -> float:
    return abs(a - b) / abs(b)


def jax_forward_and_step(jcfg, params, batch) -> tuple:
    """JAX's train-mode forward of the step (relu4_3 of the reference,
    fake_P and fake_B) and its first train step's losses, in one jitted
    program: (tensors, losses)."""
    models = JI.build_models(jcfg)
    step = JI.make_train_step(jcfg)
    rng = jax.random.PRNGKey(0)

    def both(st, batch):
        _, m = step(st, batch, rng)
        b = JI.normalize_batch(batch)
        mask = JI.resolve_mask(jcfg, b["mask"])
        _, flag = JI.prepare_masks(jcfg, mask)
        ref_feat = apply_vgg16(st.vgg, b["ref"],
                               jcfg.vgg_width_scale).relu4_3
        out = JI.two_stage_forward(models, st.params_G, st.params_P,
                                   b["image"], mask, ref_feat, flag,
                                   train=True, rng=rng)
        return ({"relu4_3": ref_feat, "fake_P": out.fake_P,
                 "fake_B": out.fake_B}, {k: m[k] for k in TT.LOSSES})
    tensors, losses = jax.jit(both)(
        JST.create_train_state(jcfg, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return ({k: np.asarray(v) for k, v in tensors.items()},
            {k: float(v) for k, v in losses.items()})


def port_forward_and_step(tcfg, params, batch) -> tuple:
    """The port's forward of the step (NHWC, as JAX's) from the bridged
    weights, then its train step from the same state: (tensors,
    losses)."""
    state = torch_state(tcfg, {n: flat_of(params[n]) for n in params})
    gt = TI.normalize_image(torch.from_numpy(batch["image"])
                            ).permute(0, 3, 1, 2)
    ref = TI.normalize_image(torch.from_numpy(batch["ref"])
                             ).permute(0, 3, 1, 2)
    mask = TI.resolve_mask(tcfg, TI.normalize_mask(
        torch.from_numpy(batch["mask"])))
    _, flag = TI.prepare_masks(tcfg, mask)
    with torch.no_grad():
        ref_feat = state.vgg(ref).relu4_3
        out = TI.two_stage_forward(state.G, state.P, gt, mask, ref_feat,
                                   flag)
    nhwc = lambda t: t.detach().numpy().transpose(0, 2, 3, 1)
    tensors = {"relu4_3": nhwc(ref_feat), "fake_P": nhwc(out.fake_P),
               "fake_B": nhwc(out.fake_B)}
    _, m = TI.make_train_step(tcfg, "cpu")(state, batch)
    return tensors, {k: float(m[k]) for k in TT.LOSSES}


def assert_step1_equal(port: dict, ref: dict) -> None:
    for k in EXACT:
        assert rel(port[k], ref[k]) <= LOSS_RTOL, (k, port[k], ref[k])
    assert rel(port["G_GAN"], ref["G_GAN"]) <= G_GAN_RTOL, (
        port["G_GAN"], ref["G_GAN"])


def test_step1_equals_jax():
    fields = dict(FIELDS, batch_size=2)
    jcfg, tcfg = configs(**fields)
    params = TT.draw(jcfg, 0)
    batch = TT.synth_batches(1, 2, jcfg.fine_size, 0)[0]
    want, ref = jax_forward_and_step(jcfg, params, batch)
    got, losses = port_forward_and_step(tcfg, params, batch)
    assert_step1_equal(losses, ref)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        err = float(np.abs(got[k] - v).max() / np.abs(v).max())
        assert err <= TENSOR_RTOL[k], (k, err)


def test_round2_record_departs_from_current_code():
    rows = {name: step1_row(path) for name, path in RECORDS.items()}
    old = step1_row(ROUND2)
    for name, row in rows.items():
        for k in ("D", "cosis"):
            assert rel(old[k], row[k]) > 0.04, (name, k, old[k], row[k])
    for k, tol in (("D", 0.01), ("cosis", 0.003)):
        vals = [row[k] for row in rows.values()]
        assert (max(vals) - min(vals)) / min(vals) <= tol, (k, vals)
    g_l1 = [row["G_L1"] for row in rows.values()] + [old["G_L1"]]
    assert (max(g_l1) - min(g_l1)) / min(g_l1) <= 3e-4, g_l1


def test_inner_cos_mean_is_f32_exact():
    rng = np.random.default_rng(0)
    shape = (PROTOCOL.batch_size, 8 * PROTOCOL.ngf,
             PROTOCOL.fine_size // 8, PROTOCOL.fine_size // 8)
    feat = rng.standard_normal(shape).astype(np.float32)
    target = np.abs(rng.standard_normal(shape)).astype(np.float32)
    fmask = (rng.random((shape[0],) + shape[2:]) < 0.25).astype(np.float32)
    exact = float(np.mean(np.square(
        feat.astype(np.float64) * fmask[:, None] * PROTOCOL.strength
        - target)))
    got = float(inner_cos_loss(torch.from_numpy(feat),
                               torch.from_numpy(fmask),
                               torch.from_numpy(target), PROTOCOL.strength))
    assert rel(got, exact) <= 1e-6, (got, exact)


@pytest.mark.slow
def test_jax_init_step1_ties_to_round5_record(tmp_path):
    from deepinpainting_torch.data import BatchIterator, InpaintDataset
    fields = dict(FIELDS, batch_size=PROTOCOL.batch_size)
    jcfg, tcfg = configs(**fields)
    data, _ = demo.make_data(tmp_path, demo.DATA["synth"])
    batch = TT.trainer_batches(data, jcfg.fine_size, jcfg.batch_size, 1)[0]
    own = next(iter(BatchIterator(InpaintDataset(
        f"{data}/img", f"{data}/mask", f"{data}/img", tcfg.fine_size,
        seed=tcfg.seed), tcfg.batch_size, seed=tcfg.seed + 1)))
    for k, v in batch.items():
        np.testing.assert_array_equal(own[k], v)
    params = TT.draw(jcfg, 0, jax_init=True)
    _, ref = jax_forward_and_step(jcfg, params, batch)
    round5, round2 = step1_row(RECORDS["round5"]), step1_row(ROUND2)
    for k in TT.LOSSES:
        assert rel(ref[k], round5[k]) <= RECORD_RTOL, (k, ref[k], round5[k])
    for k in ("D", "cosis"):
        assert rel(ref[k], round2[k]) > RECORD_RTOL, (k, ref[k], round2[k])
    _, losses = port_forward_and_step(tcfg, params, own)
    assert_step1_equal(losses, ref)
