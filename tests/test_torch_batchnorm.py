"""Port vs JAX: norm='batch'.

The JAX package's TorchBatchNorm reproduces torch.nn.BatchNorm2d (train:
biased batch variance over (N, H, W), running statistics updated with the
unbiased one at momentum 0.1; eval: the running statistics); the port uses
nn.BatchNorm2d itself.  Held here: the layer, the bridge of `batch_stats`,
the init, eval-mode inference, netD's chained running statistics, and one
train step with all its running statistics.

Tolerances: layers 1e-5 and networks 1e-4, as in the instance-norm tests.
The train step runs at batch 4 with the untruncated attention backward
(`trunc` is discontinuous and has its own preconditioned tests in
test_torch_attention_grad.py and test_torch_train_step.py): metrics 1e-4
relative, gradients as in test_torch_train_step.py, running statistics
after the first step 1e-5.
"""

import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.ops import convs as JC
from deepinpainting_torch.convert.jax_bridge import bridge_state_dict
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import convs as TC

from torch_port_helpers import (TRAINED, configs, flat_dicts, flat_of,
                                jax_params, nchw, nhwc, run_both, tiny_batch,
                                torch_discriminators, torch_models)

TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = dict(norm="batch", batch_size=4, use_dropout=False,
              mask_type="random", faithful_backward_truncation=False)
METRICS = ("G_GAN", "G_L1", "D", "F", "cosis", "loss")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg, _ = configs(**FIELDS)
    params = jax_params(jcfg, seed=9)
    return params, flat_dicts(params, tmp_path_factory.mktemp("w"))


def test_layer_matches_in_train_and_eval_mode():
    rng = np.random.default_rng(0)
    c = 6
    x = (2.0 + 3.0 * rng.standard_normal((4, 5, 5, c))).astype(np.float32)
    variables = {
        "params": {"scale": (1 + 0.1 * rng.standard_normal(c)
                             ).astype(np.float32),
                   "offset": rng.standard_normal(c).astype(np.float32)},
        "batch_stats": {"mean": rng.standard_normal(c).astype(np.float32),
                        "var": (0.5 + rng.random(c)).astype(np.float32)}}
    layer = TC.make_norm("batch", c)
    assert isinstance(layer, torch.nn.BatchNorm2d)
    assert layer.eps == 1e-5 and layer.momentum == 0.1
    holder = torch.nn.Module()
    holder.norm = layer
    holder.load_state_dict(bridge_state_dict(
        flat_of({"params": {"norm": variables["params"]},
                 "batch_stats": {"norm": variables["batch_stats"]}}), holder))
    jbn = JC.TorchBatchNorm()
    want_eval = jbn.apply(variables, jnp.asarray(x), False)
    want_train, mutated = jbn.apply(variables, jnp.asarray(x), True,
                                    mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = layer.eval()(nchw(x))
        got_train = layer.train()(nchw(x))
    np.testing.assert_allclose(nhwc(got_eval), np.asarray(want_eval), **TOL)
    np.testing.assert_allclose(nhwc(got_train), np.asarray(want_train), **TOL)
    np.testing.assert_allclose(layer.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]),
                               **TOL)
    np.testing.assert_allclose(layer.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]),
                               **TOL)
    with pytest.raises(NotImplementedError, match="group"):
        TC.make_norm("group", c)


@pytest.mark.parametrize("net", ["G", "P", "D"])
def test_every_leaf_and_statistic_bridged(weights, net):
    _, flats = weights
    _, tcfg = configs(**FIELDS)
    module = (getattr(TI.build_models(tcfg), net) if net != "D"
              else TI.build_discriminators(tcfg).D)
    assert any(k.startswith("batch_stats/") for k in flats[net])
    sd = bridge_state_dict(flats[net], module)
    counters = [k for k in sd if k.endswith("num_batches_tracked")]
    assert counters and len(sd) == len(flats[net]) + len(counters)
    module.load_state_dict(sd, strict=True)
    incomplete = {k: v for k, v in flats[net].items()
                  if not k.endswith("/var")}
    with pytest.raises(KeyError, match="running_var"):
        bridge_state_dict(incomplete, module)


def test_netD_middle_convs_have_no_bias_under_batch_norm():
    _, tcfg = configs(**FIELDS)
    D = TI.build_discriminators(tcfg).D
    assert D.conv0.bias is not None and D.head.bias is not None
    assert all(getattr(D, f"conv{n}").bias is None for n in (1, 2, 3))
    D_in = TI.build_discriminators(tcfg.replace(norm="instance")).D
    assert all(getattr(D_in, f"conv{n}").bias is not None for n in (1, 2, 3))


def test_init_draws_the_scale_around_one():
    _, tcfg = configs(**FIELDS)
    m = TI.init_params(tcfg.replace(ngf=32, vgg_width_scale=0.5),
                       torch.Generator().manual_seed(0), "cpu")
    scales = torch.cat([mod.weight.detach().flatten() for mod in m.G.modules()
                        if isinstance(mod, torch.nn.BatchNorm2d)])
    assert scales.numel() > 1000
    assert abs(scales.mean().item() - 1.0) < 0.005
    assert abs(scales.std().item() / tcfg.init_gain - 1.0) < 0.1
    bn = m.P.model.submodule.down_norm
    assert (bn.bias == 0).all() and (bn.running_mean == 0).all()
    assert (bn.running_var == 1).all()


def test_inference_uses_the_running_statistics(weights):
    params, flats = weights
    jcfg, tcfg = configs(**FIELDS)
    tm = torch_models(tcfg, flats)
    b = tiny_batch(3, 2)
    want_B, want_P = JI.make_inference_fn(jcfg)(
        params["G"], params["P"], params["vgg"], b["image"], b["mask"],
        b["ref"])
    got_B, got_P = TI.make_inference_fn(tcfg, "cpu")(
        *tm, b["image"], b["mask"], b["ref"])
    np.testing.assert_allclose(got_P.numpy(), np.asarray(want_P), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_B.numpy(), np.asarray(want_B), rtol=1e-4,
                               atol=1e-4)


def test_netD_chains_its_running_statistics(weights):
    """Two train-mode forwards, fake then real, as a train step's D phase
    runs them: outputs and the statistics after both."""
    params, flats = weights
    jcfg, tcfg = configs(**FIELDS)
    rng = np.random.default_rng(4)
    fake = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    jD = JI.build_models(jcfg).D
    variables = dict(params["D"])
    want_fake, mut = jD.apply(variables, jnp.asarray(fake), True,
                              mutable=["batch_stats"])
    want_real, mut = jD.apply({**variables, **mut}, jnp.asarray(real), True,
                              mutable=["batch_stats"])
    D = torch_discriminators(tcfg, flats).D
    with torch.no_grad():
        got_fake, got_real = D(nchw(fake)), D(nchw(real))
    np.testing.assert_allclose(nhwc(got_fake), np.asarray(want_fake), **TOL)
    np.testing.assert_allclose(nhwc(got_real), np.asarray(want_real), **TOL)
    stats = flax.traverse_util.flatten_dict(
        flax.core.unfreeze(mut["batch_stats"]), sep="/")
    for key, value in stats.items():
        layer, leaf = key.rsplit("/", 1)
        got = getattr(getattr(D, layer), {"mean": "running_mean",
                                          "var": "running_var"}[leaf])
        np.testing.assert_allclose(got.numpy(), np.asarray(value), **TOL)


@pytest.fixture(scope="module")
def ran(weights):
    return run_both(FIELDS, *weights, seeds=(1, 2))


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("name", METRICS)
def test_train_step_metric_matches(ran, name, step):
    got = float(ran[f"tm{step}"][name])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(ran[f"jm{step}"][name]), rtol=1e-4)


@pytest.mark.parametrize("net", TRAINED)
def test_train_step_gradients_match(ran, net):
    got, want = ran["tgrads"][net], ran["jgrads"][net]
    assert set(got) == set(want)
    for k in got:
        atol = 1e-4
        if net == "G":
            atol += 1e-3 * float(want[k].abs().max())
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=atol, err_msg=f"{net}.{k}")


@pytest.mark.parametrize("net", ["G", "P", "D"])
def test_train_step_running_statistics_match(ran, net):
    """G's and P's move once a step, D's four times (fake then real, in the
    D phase and again in the G phase)."""
    names = [k for k in ran["jafter"][net] if "running_" in k]
    assert names
    for k in names:
        assert not torch.equal(ran["after"][net][k], ran["before"][net][k])
        np.testing.assert_allclose(ran["after"][net][k].numpy(),
                                   ran["jafter"][net][k].numpy(), **TOL,
                                   err_msg=f"{net}.{k}")
    counter = next(k for k in ran["after"][net]
                   if k.endswith("num_batches_tracked"))
    assert int(ran["after"][net][counter]) == (4 if net == "D" else 1)
