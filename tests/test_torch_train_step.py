"""Port vs JAX: the GAN train step at the tiny config, its optimiser state
and its schedules.

Both packages start from the same bridged G, P, D, F and VGG weights (numpy
seed), fresh Adam state and the same uint8 batch, with use_dropout=False
(the two frameworks' generators cannot give the same dropout mask; dropout
has its own tests below).  The JAX step runs as its own tests run it on the
CPU: jitted, with the Pallas kernels in interpret mode
(attention_impl='pallas', the default).

Tolerances, and why:
  * the six metrics: 1e-4 relative (f32 sums in another order through two
    U-Nets and three discriminator passes);
  * gradients of P, D and F: 1e-4 absolute.  The JAX gradients are read
    back from Adam's first moment after the first step,
    g = mu / (1 - beta1), which is exact for beta1 = 0.5;
  * gradients of G: 1e-4 absolute plus 1e-3 of the leaf's largest entry.
    lambda_A = 100 scales them to O(10), so an absolute limit alone would
    ask for more than f32 sums through two U-Nets give; on this batch the
    two packages differ by 1e-4 of a leaf's largest entry.  The batch is
    screened for the one discontinuity on the path, see
    test_inputs_are_safe_to_truncate;
  * parameter deltas: a first Adam step moves a weight by
    lr * g / (|g| + eps), so where |g| is near eps = 1e-8 (conv biases
    that feed an instance norm have an analytically zero gradient) the
    delta is rounding noise of any sign.  Deltas are compared only on
    elements with |g| > 1e-5, to 2% of lr;
  * a second step: metrics only, 3e-4 relative (the first Adam step has
    moved every weight whose gradient is rounding noise by lr with a sign
    of its own in each package);
  * gan_type='vanilla' (BCE on a clipped relativistic difference): the
    first step's metrics only, 1e-4 relative.  Its gradients carry 1/p of
    differences p that reach down to the 1e-7 clip, so rounding noise in p
    comes back multiplied by up to 1e7 and the two packages' G gradients
    differ by 1% of a leaf's largest entry; no shipped configuration trains
    with it.
"""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepinpainting_tpu.engine import schedules as JS
from deepinpainting_tpu.engine import state as JST
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.engine import schedules as TS
from deepinpainting_torch.engine import state as TST
from deepinpainting_torch.losses import ra_gan_loss
from deepinpainting_torch.ops.convs import Dropout

from torch_port_helpers import (TRAINED as NETS, configs, flat_dicts,
                                jax_params, run_both, state_grads as _grads,
                                state_tensors as _params, tiny_batch as _batch,
                                torch_state)

S = 64
METRICS = ("G_GAN", "G_L1", "D", "F", "cosis", "loss")
FIELDS = dict(batch_size=2, use_dropout=False, mask_type="random")
# Configurations the whole step is held against JAX in: the shipped
# defaults, and every reference quirk corrected, through the lax attention.
VARIANTS = {
    "faithful": {},
    "corrected": dict(faithful_backward_truncation=False,
                      faithful_detached_cosis=False,
                      faithful_known_replacement=False,
                      attention_impl="lax"),
}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg, _ = configs(**FIELDS)
    params = jax_params(jcfg, seed=7)
    return params, flat_dicts(params, tmp_path_factory.mktemp("w"))


# Batch seeds on which the first step's kbar has no entry next to a
# non-zero integer (asserted below): `trunc` in the faithful backward is
# discontinuous there, and the two packages then disagree by O(1).
SEEDS = (13, 113)


@pytest.fixture(scope="module", params=list(VARIANTS))
def ran(request, weights):
    """Two steps in both packages; everything the tests compare."""
    return run_both(dict(FIELDS, **VARIANTS[request.param]), *weights,
                    seeds=SEEDS)


def test_inputs_are_safe_to_truncate(ran):
    """The precondition of the gradient tests.  Entries near 1 are common
    (two neighbouring masked positions that pick the same best patch give
    a*1 + b*1 with a + b ~ 1), and 0.99999994 against 1.0 is 0 against 1
    after `trunc`; of 24 batch seeds tried (tests/torch_seed_scan.py 1 25),
    the 6 without such an entry all agree and 13 of the other 18 differ by
    10 to 1400 times the limit."""
    assert ran["risky"] == 0
    assert ran["kbar_max"] < 4        # no near-cancelling at + vmax either


@pytest.mark.parametrize("name", METRICS)
def test_first_step_metric_matches(ran, name):
    got, want = float(ran["tm1"][name]), float(ran["jm1"][name])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("net", NETS)
def test_gradients_match(ran, net):
    got, want = ran["tgrads"][net], ran["jgrads"][net]
    assert set(got) == set(want)
    total = 0.0
    for k in got:
        atol = 1e-4
        if net == "G":
            atol += 1e-3 * float(want[k].abs().max())
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=atol, err_msg=f"{net}.{k}")
        total += float(want[k].abs().sum())
    assert total > 0


@pytest.mark.parametrize("net", NETS)
def test_parameter_deltas_match(ran, net):
    lr = ran["tcfg"].lr
    compared = elements = 0
    for k, new in ran["jafter"][net].items():
        want = new - ran["before"][net][k]   # both start from these numbers
        got = ran["after"][net][k] - ran["before"][net][k]
        clear = ran["jgrads"][net][k].abs() > 1e-5
        compared += int(clear.sum())
        elements += clear.numel()
        np.testing.assert_allclose(got[clear].numpy(), want[clear].numpy(),
                                   rtol=0, atol=0.02 * lr,
                                   err_msg=f"{net}.{k}")
        # a first Adam step moves such a weight by almost exactly lr
        assert (got[clear].abs() > 0.9 * lr).all()
    assert compared > 0.5 * elements


@pytest.mark.parametrize("name", METRICS)
def test_second_step_metric_matches(ran, name):
    np.testing.assert_allclose(float(ran["tm2"][name]),
                               float(ran["jm2"][name]), rtol=3e-4)


def test_step_counts_and_what_moved(ran):
    assert ran["tstate"].step == 2 == int(ran["j2"].step)
    for net in NETS:
        moved = sum(float((ran["after"][net][k] - v).abs().sum())
                    for k, v in ran["before"][net].items())
        assert moved > 0, net
    for k, v in ran["before"]["vgg"].items():   # the extractor is frozen
        assert torch.equal(v, ran["after"]["vgg"][k])
    assert all(p.grad is None for p in ran["tstate"].vgg.parameters())
    assert set(ran["tm1"]) == set(METRICS)
    assert torch.equal(ran["tm1"]["loss"], ran["tm1"]["G_L1"])


@pytest.fixture(scope="module")
def ran_vanilla(weights):
    return run_both(dict(FIELDS, gan_type="vanilla"), *weights)


@pytest.mark.parametrize("name", METRICS)
def test_vanilla_first_step_metric_matches(ran_vanilla, name):
    got = float(ran_vanilla["tm1"][name])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(ran_vanilla["jm1"][name]),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# semantics of the step, in the port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fresh(weights):
    _, flats = weights

    def make(**kw):
        _, tcfg = configs(**dict(FIELDS, **kw))
        return tcfg, torch_state(tcfg, flats)

    return make


def _one_step(fresh, **kw):
    tcfg, state = fresh(**kw)
    _, metrics = TI.make_train_step(tcfg, "cpu")(state, _batch(1))
    return state, metrics


def test_discriminators_are_stepped_before_g_sees_them(fresh):
    """G_GAN is scored by the updated D and F on the pre-update fake_B."""
    tcfg, state = fresh()
    old = copy.deepcopy(state)
    _, metrics = TI.make_train_step(tcfg, "cpu")(state, _batch(1))
    batch = _batch(1)
    with torch.no_grad():
        gt = TI.normalize_image(torch.from_numpy(batch["image"])
                                ).permute(0, 3, 1, 2)
        ref = TI.normalize_image(torch.from_numpy(batch["ref"])
                                 ).permute(0, 3, 1, 2)
        mask = TI.normalize_mask(torch.from_numpy(batch["mask"]))
        _, flag = TI.prepare_masks(tcfg, mask)
        fake_B = TI.two_stage_forward(old.G, old.P, gt, mask,
                                      old.vgg(ref).relu4_3, flag).fake_B
        feats = (old.vgg(fake_B, upto=3).relu3_3, old.vgg(gt).relu3_3)

    def g_gan(s):
        with torch.no_grad():
            return float(ra_gan_loss(s.D(fake_B), s.D(gt), False)
                         + ra_gan_loss(s.F(feats[0]), s.F(feats[1]), False))

    np.testing.assert_allclose(float(metrics["G_GAN"]), g_gan(state),
                               rtol=1e-5)
    assert abs(g_gan(old) - g_gan(state)) > 1e-3


def test_faithful_cosis_is_a_value_only_and_corrected_has_a_gradient(fresh):
    on, m_on = _one_step(fresh)
    off, m_off = _one_step(fresh, cosis=0)
    corrected, m_corr = _one_step(fresh, faithful_detached_cosis=False)
    assert float(m_on["cosis"]) > 0 and float(m_off["cosis"]) == 0
    assert torch.equal(m_on["cosis"], m_corr["cosis"])
    g_on, g_off, g_corr = (_grads(s, "G") for s in (on, off, corrected))
    assert all(torch.equal(g_on[k], g_off[k]) for k in g_on)
    assert any(not torch.equal(g_on[k], g_corr[k]) for k in g_on)
    # the taps sit inside netG: netP sees none of it either way
    p_on, p_corr = _grads(on, "P"), _grads(corrected, "P")
    assert all(torch.equal(p_on[k], p_corr[k]) for k in p_on)


def test_skip_drops_the_cosis_losses(fresh):
    skipped, m = _one_step(fresh, skip=1, faithful_detached_cosis=False)
    off, _ = _one_step(fresh, cosis=0)
    assert float(m["cosis"]) == 0
    g_skip, g_off = _grads(skipped, "G"), _grads(off, "G")
    assert all(torch.equal(g_skip[k], g_off[k]) for k in g_skip)


def test_netP_gets_no_gan_gradient(fresh):
    """The compose step detaches fake_P, so with lambda_A = 0 netP's only
    loss term vanishes and it must not move; netG still does."""
    tcfg, state = fresh(lambda_A=0.0)
    before = {n: _params(state, n) for n in ("G", "P")}
    TI.make_train_step(tcfg, "cpu")(state, _batch(1))
    assert all(torch.equal(v, state.P.state_dict()[k])
               for k, v in before["P"].items())
    assert any(not torch.equal(v, state.G.state_dict()[k])
               for k, v in before["G"].items())


def test_the_g_loss_leaves_no_gradient_on_the_discriminators(fresh):
    """D's and F's .grad after a step are the D-phase gradients alone:
    stepping with gan_weight = 0 (no G loss through D) gives the same."""
    a, _ = _one_step(fresh)
    b, _ = _one_step(fresh, gan_weight=0.0)
    for net in ("D", "F"):
        ga, gb = _grads(a, net), _grads(b, net)
        assert all(torch.equal(ga[k], gb[k]) for k in ga)


@pytest.mark.parametrize("gan_type", ["wgan_gp", "vanilla"])
def test_other_gan_types_step(fresh, gan_type):
    state, metrics = _one_step(fresh, gan_type=gan_type)
    assert state.D.use_sigmoid == (gan_type == "vanilla")
    assert all(np.isfinite(float(v)) for v in metrics.values())


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def test_dropout_draws_from_its_generator():
    drop = Dropout(0.5).train()
    x = torch.ones(4, 8, 16, 16)
    a = drop(x, torch.Generator().manual_seed(3))
    b = drop(x, torch.Generator().manual_seed(3))
    c = drop(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}      # kept values scale 2x
    assert abs((a > 0).float().mean().item() - 0.5) < 0.02
    assert torch.equal(drop.eval()(x, torch.Generator().manual_seed(3)), x)
    with pytest.raises(ValueError):
        Dropout(1.0)


def test_train_step_with_dropout_repeats_from_a_seed(fresh):
    def run(seed):
        tcfg, state = fresh(use_dropout=True)
        step = TI.make_train_step(tcfg, "cpu")
        _, m = step(state, _batch(1), torch.Generator().manual_seed(seed))
        return float(m["G_L1"])

    assert run(5) == run(5) != run(6)
    # in eval mode the same networks ignore the generator
    tcfg, state = fresh(use_dropout=True)
    x = torch.zeros(1, 3, S, S)
    state.P.eval()
    with torch.no_grad():
        assert torch.equal(state.P(x, torch.Generator().manual_seed(1)),
                           state.P(x, torch.Generator().manual_seed(2)))


# ---------------------------------------------------------------------------
# optimiser state and schedules
# ---------------------------------------------------------------------------

def test_adam_puts_eps_where_optax_does():
    """Gradients from far above eps = 1e-8 to far below it, three steps:
    m_hat / (sqrt(v_hat) + eps) on both sides."""
    _, tcfg = configs()
    g = np.array([1.0, -1e-3, 1e-6, -1e-7, 1e-8, -1e-9, 3e-10, 0.0],
                 np.float32)
    w0 = np.linspace(-1, 1, g.size).astype(np.float32)
    tx = JST.make_optimizer(tcfg)
    jw, jopt = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    holder = torch.nn.Module()
    holder.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = TST.make_optimizer(tcfg, holder)
    for k in range(3):
        gk = g * (1.0 + 0.5 * k)
        upd, jopt = tx.update(jnp.asarray(gk), jopt, jw)
        jw = optax.apply_updates(jw, upd)
        holder.w.grad = torch.from_numpy(gk.copy())
        opt.step()
    np.testing.assert_allclose(holder.w.detach().numpy() - w0,
                               np.asarray(jw) - w0, rtol=1e-4, atol=1e-9)
    assert opt.defaults["eps"] == 1e-8
    assert opt.defaults["betas"] == (tcfg.beta1, 0.999)


@pytest.mark.parametrize("policy", ["lambda", "step", "cosine"])
def test_lr_for_epoch_matches(policy):
    jcfg, tcfg = configs(lr_policy=policy, niter=3, niter_decay=5,
                         lr_decay_iters=2)
    for epoch in range(10):
        assert TS.lr_for_epoch(tcfg, epoch) == JS.lr_for_epoch(jcfg, epoch)


def test_stateful_schedules_match():
    jcfg, tcfg = configs(lr_policy="plateau")
    with pytest.raises(ValueError):
        TS.lr_for_epoch(tcfg, 0)
    with pytest.raises(NotImplementedError):
        TS.lr_for_epoch(tcfg.replace(lr_policy="exp"), 0)
    losses = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.8, 0.81, 0.81,
              0.81, 0.81, 0.81, 0.81]
    jp, tp = JS.PlateauScheduler(lr=2e-4), TS.PlateauScheduler(lr=2e-4)
    je, te = JS.EarlyStopping(patience=4), TS.EarlyStopping(patience=4)
    for x in losses:
        assert tp.step(x) == jp.step(x)
        assert te(x) == je(x)
    assert tp.lr < 2e-4 and te.early_stop


def test_set_learning_rate_matches(weights, fresh):
    params, _ = weights
    jcfg, _ = configs(**FIELDS)
    tcfg, state = fresh()
    jstate = JST.create_train_state(jcfg, params)
    assert TST.current_learning_rate(state) == pytest.approx(
        JST.current_learning_rate(jstate))
    lr = TS.lr_for_epoch(tcfg.replace(niter=1, niter_decay=3), 2)
    jstate = JST.set_learning_rate(jstate, lr)
    assert TST.set_learning_rate(state, lr) is state
    assert TST.current_learning_rate(state) == pytest.approx(
        JST.current_learning_rate(jstate))
    assert all(g["lr"] == lr for opt in state.optimizers
               for g in opt.param_groups)
    before = _params(state, "G")
    TI.make_train_step(tcfg, "cpu")(state, _batch(1))
    step = max(float((state.G.state_dict()[k] - v).abs().max())
               for k, v in before.items())
    assert 0.5 * lr < step <= 1.001 * lr        # the new rate is what steps


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_create_state_draws_serving_and_training_alike():
    _, tcfg = configs(**FIELDS)
    state = TI.create_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    served = TI.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for net in ("G", "P", "vgg"):
        a, b = getattr(state, net).state_dict(), getattr(
            served, net).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert state.step == 0
    assert all(n.training for n in (state.G, state.P, state.D, state.F))
    assert not any(p.requires_grad for p in state.vgg.parameters())
    assert not state.opt_G.state          # fresh optimiser state


def test_training_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs(**FIELDS)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: TI.make_train_step(tcfg),
                 lambda: TI.create_state(tcfg, gen),
                 lambda: TI.init_discriminators(tcfg, gen)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    TI.make_train_step(tcfg, "cpu")


@pytest.mark.parametrize("kw", [
    dict(quant="int4"), dict(dtype="float16"),
    dict(dtype="float64"), dict(quant="int8"),
    dict(norm="group")])
def test_options_left_for_later_are_refused_by_name(kw):
    """What the train step does not run is refused by name: int8 is
    inference only (as in the JAX package), the rest is not implemented.
    The pack modes train (tests/test_torch_pack.py)."""
    _, tcfg = configs(**dict(FIELDS, **kw))
    name = next(iter(kw))
    for make in (lambda: TI.make_train_step(tcfg, "cpu"),
                 lambda: TI.create_state(
                     tcfg, torch.Generator().manual_seed(0), "cpu")):
        with pytest.raises(NotImplementedError, match=name):
            make()


def test_debug_nan_builds():
    """debug_nan is the trainer's NaN guard (engine/trainer.py); the step
    ignores it, as the JAX package's does."""
    _, tcfg = configs(**dict(FIELDS, debug_nan=True))
    TI.make_train_step(tcfg, "cpu")
    state = TI.create_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert state.step == 0


def test_unknown_gan_type_is_refused():
    _, tcfg = configs(**dict(FIELDS, gan_type="hinge"))
    with pytest.raises(ValueError, match="hinge"):
        TI.make_train_step(tcfg, "cpu")
