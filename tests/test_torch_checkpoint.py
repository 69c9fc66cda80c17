"""Checkpoints of the port's training state, and its interop with the JAX
package: network .npz files both ways and optax Adam state -> torch Adam.

Save and restore must be exact (torch.equal on every tensor of every
network and optimiser, and the step counts).  Tolerances against JAX:
  * the weight files: exact (a transpose each way);
  * a JAX forward of weights that the port exported against the port's
    forward: 1e-4 absolute, as the two-stage forward's parity tests;
  * a train step after a JAX step's whole state was bridged into the port:
    its metrics 1e-4 relative, and the step's parameter deltas of P, D and
    F within 2% of lr on the elements whose gradient is clear of rounding
    noise in both steps (|g| > 1e-5; Adam moves a weight whose gradient is
    noise by up to lr with a sign of its own).  The run uses
    faithful_backward_truncation=False, whose backward has no jump.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.engine import state as JST
from deepinpainting_tpu.engine.checkpoint import (
    export_network_npz as jexport, import_network_npz as jimport)
from deepinpainting_torch.convert.jax_bridge import (bridge_adam_state,
                                                     flat_dict, load_flat)
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.engine.checkpoint import (CheckpointManager,
                                                    export_network_npz,
                                                    import_network_npz)

from torch_port_helpers import (TRAINED, configs, flat_dicts, flat_of,
                                jax_params, tiny_batch, torch_models,
                                torch_state)

FIELDS = dict(batch_size=2, use_dropout=False, mask_type="random")
NETWORKS = TRAINED + ("vgg",)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg, _ = configs(**FIELDS)
    params = jax_params(jcfg, seed=7)
    return params, flat_dicts(params, tmp_path_factory.mktemp("w"))


def _trained(weights, steps=2, **kw):
    """A port state after `steps` CPU train steps (Adam state non-empty)."""
    _, tcfg = configs(**dict(FIELDS, **kw))
    state = torch_state(tcfg, weights[1])
    step = TI.make_train_step(tcfg, "cpu")
    for i in range(steps):
        step(state, tiny_batch(40 + i))
    return tcfg, state


def _snapshot(state):
    """Every tensor and number of a TrainState, copied."""
    def copy(obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().clone()
        if isinstance(obj, dict):
            return {k: copy(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(copy(v) for v in obj)
        return obj
    return copy(state.state_dict())


def _assert_same(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_save_then_restore_is_bit_for_bit(weights, tmp_path):
    tcfg, state = _trained(weights, checkpoints_dir=str(tmp_path))
    want = _snapshot(state)
    assert state.step == 2 and want["opt_G"]["state"]
    mgr = CheckpointManager(tcfg)
    mgr.save(2, state)
    assert mgr.all_epochs() == [2] and mgr.latest_epoch() == 2
    assert os.path.exists(os.path.join(mgr.directory, "config.json"))
    assert mgr.last_save["bytes"] > 0
    fresh = TI.create_state(tcfg, torch.Generator().manual_seed(9), "cpu")
    assert fresh.step == 0 and not fresh.opt_G.state
    got = mgr.restore(2, fresh, "cpu")
    assert got is fresh and got.step == 2
    _assert_same(_snapshot(got), want)
    # every optimiser steps the restored parameters, not copies of them
    for n in TRAINED:
        params = list(getattr(got, n).parameters())
        opt = getattr(got, f"opt_{n}")
        assert all(p in opt.state for p in params)
    # a restored state trains on
    TI.make_train_step(tcfg, "cpu")(got, tiny_batch(50))
    assert got.step == 3


def test_missing_epoch_names_the_available_ones(weights, tmp_path):
    tcfg, state = _trained(weights, steps=0, checkpoints_dir=str(tmp_path))
    mgr = CheckpointManager(tcfg)
    for epoch in (1, 3):
        mgr.save(epoch, state)
    with pytest.raises(FileNotFoundError, match=r"available: \[1, 3\]"):
        mgr.restore(2, state, "cpu")


def test_restore_only_manager_never_writes_config(weights, tmp_path):
    tcfg, state = _trained(weights, steps=0, checkpoints_dir=str(tmp_path),
                           name="run")
    cfg_path = tmp_path / "run" / "config.json"
    trainer_mgr = CheckpointManager(tcfg)
    assert json.loads(cfg_path.read_text())["ngf"] == tcfg.ngf
    trainer_mgr.save(1, state)
    # a resume with other settings leaves the run's record alone ...
    resumer = CheckpointManager(tcfg.replace(lambda_A=1.0))
    assert json.loads(cfg_path.read_text())["lambda_A"] == tcfg.lambda_A
    # ... and a restore-only manager neither writes nor rewrites it
    os.remove(cfg_path)
    reader = CheckpointManager(tcfg.replace(is_train=False, lambda_A=2.0))
    reader.restore(1, state, "cpu")
    reader.save(2, state)
    reader.close()
    assert not cfg_path.exists()
    # a training manager writes it where there is none ...
    CheckpointManager(tcfg.replace(lambda_A=3.0))
    assert json.loads(cfg_path.read_text())["lambda_A"] == 3.0
    # ... and the resume's first save records what ran
    resumer.save(3, state)
    assert json.loads(cfg_path.read_text())["lambda_A"] == 1.0


def test_async_save_copies_before_returning(weights, tmp_path):
    """The next train step updates the state in place: what the async save
    writes is the state as it was when save() returned."""
    tcfg, state = _trained(weights, steps=1, checkpoints_dir=str(tmp_path))
    want = _snapshot(state)
    mgr = CheckpointManager(tcfg, async_save=True, max_to_keep=2)
    mgr.save(1, state)
    TI.make_train_step(tcfg, "cpu")(state, tiny_batch(60))   # in place
    assert state.step == 2
    fresh = TI.create_state(tcfg, torch.Generator().manual_seed(1), "cpu")
    _assert_same(_snapshot(mgr.restore(1, fresh, "cpu")), want)
    for epoch in (2, 3):
        mgr.save(epoch, state)
    mgr.close()
    assert mgr.all_epochs() == [2, 3]        # max_to_keep
    assert not [f for f in os.listdir(mgr.directory) if ".tmp" in f]


def test_a_failed_write_raises_in_the_caller(weights, tmp_path):
    tcfg, state = _trained(weights, steps=0, checkpoints_dir=str(tmp_path))
    mgr = CheckpointManager(tcfg, async_save=True)
    os.makedirs(mgr.path(4))                 # a directory where the file goes
    mgr.save(4, state)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                               # the error is raised once


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_flat_dict_is_the_jax_export_layout(norm, tmp_path):
    """Every network: JAX export -> port load -> port flat_dict gives the
    same keys and bits back."""
    jcfg, tcfg = configs(**dict(FIELDS, norm=norm))
    flats = flat_dicts(jax_params(jcfg, seed=2), tmp_path)
    nets = dict(zip(("G", "P", "vgg"), TI.build_models(tcfg)))
    nets.update(zip(("D", "F"), TI.build_discriminators(tcfg)))
    for name, net in nets.items():
        load_flat(net, flats[name])
        back = flat_dict(net)
        assert set(back) == set(flats[name]), name
        for k, v in flats[name].items():
            assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_exported_weights_run_in_jax(weights, tmp_path):
    """Port export_network_npz -> JAX import_network_npz -> the JAX forward
    equals the port's forward; and back through the port's import."""
    params, flats = weights
    jcfg, tcfg = configs(**FIELDS)
    models = torch_models(tcfg, flats)
    gen = torch.Generator().manual_seed(3)
    for net in models:           # move away from the bridged weights
        for p in net.parameters():
            p.data.add_(0.01 * torch.randn(p.shape, generator=gen))
    jnets = {}
    for name, net in zip(("G", "P", "vgg"), models):
        path = str(tmp_path / f"{name}.npz")
        export_network_npz(net, path)
        jnets[name] = jimport(params[name], path)
    batch = tiny_batch(31)
    jb, jp = jax.jit(JI.make_inference_fn(jcfg))(
        jnets["G"], jnets["P"], jnets["vgg"],
        *(jnp.asarray(batch[k]) for k in ("image", "mask", "ref")))
    tb, tp = TI.make_inference_fn(tcfg, "cpu")(
        *models, batch["image"], batch["mask"], batch["ref"])
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-4)
    # a JAX export loads back into a fresh port network unchanged
    jexport(jnets["G"], str(tmp_path / "back.npz"))
    fresh = import_network_npz(TI.build_models(tcfg).G,
                               str(tmp_path / "back.npz"))
    for k, v in models.G.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.fixture(scope="module")
def resumed(weights):
    """One JAX step, its whole state bridged into the port, then the second
    step on both sides from there."""
    params, flats = weights
    fields = dict(FIELDS, faithful_backward_truncation=False)
    jcfg, tcfg = configs(**fields)
    b1, b2 = tiny_batch(13), tiny_batch(113)
    jstep = jax.jit(JI.make_train_step(jcfg))
    key = jax.random.PRNGKey(0)
    j1, _ = jstep(JST.create_train_state(jcfg, params),
                  {k: jnp.asarray(v) for k, v in b1.items()}, key)
    j2, jm2 = jstep(j1, {k: jnp.asarray(v) for k, v in b2.items()}, key)

    state = torch_state(tcfg, flats)
    for n in TRAINED:
        module = getattr(state, n)
        load_flat(module, flat_of(getattr(j1, f"params_{n}")))
        opt = getattr(j1, f"opt_{n}")
        adam = opt.inner_state[0]
        bridge_adam_state(getattr(state, f"opt_{n}"), module,
                          int(adam.count), flat_of(adam.mu),
                          flat_of(adam.nu),
                          float(opt.hyperparams["learning_rate"]))
    state.step = int(j1.step)
    before = {n: {k: v.detach().clone()
                  for k, v in getattr(state, n).named_parameters()}
              for n in TRAINED}
    _, tm2 = TI.make_train_step(tcfg, "cpu")(state, b2)
    return dict(j1=j1, j2=j2, jm2=jm2, tm2=tm2, state=state, before=before,
                tcfg=tcfg, jcfg=jcfg)


@pytest.mark.parametrize("name", ["G_GAN", "G_L1", "D", "F", "cosis"])
def test_bridged_state_steps_like_jax(resumed, name):
    np.testing.assert_allclose(float(resumed["tm2"][name]),
                               float(resumed["jm2"][name]), rtol=1e-4)


@pytest.mark.parametrize("net", ["P", "D", "F"])
def test_bridged_adam_moves_weights_like_jax(resumed, net):
    from deepinpainting_torch.convert.jax_bridge import bridge_tensors
    state, j1, j2 = resumed["state"], resumed["j1"], resumed["j2"]
    module, lr = getattr(state, net), resumed["tcfg"].lr
    b1 = resumed["jcfg"].beta1
    conv = lambda tree: bridge_tensors(flat_of(tree), module)
    mu1 = conv(getattr(j1, f"opt_{net}").inner_state[0].mu)
    mu2 = conv(getattr(j2, f"opt_{net}").inner_state[0].mu)
    after = conv(getattr(j2, f"params_{net}"))
    assert state.step == 2 == int(j2.step)
    compared = elements = 0
    for k, p in module.named_parameters():
        g1 = mu1[k] / (1 - b1)                    # exact for beta1 = 0.5
        g2 = (mu2[k] - b1 * mu1[k]) / (1 - b1)
        clear = (g1.abs() > 1e-5) & (g2.abs() > 1e-5)
        want = after[k] - resumed["before"][net][k]
        got = p.detach() - resumed["before"][net][k]
        np.testing.assert_allclose(got[clear].numpy(), want[clear].numpy(),
                                   rtol=0, atol=0.02 * lr, err_msg=k)
        compared += int(clear.sum())
        elements += clear.numel()
    assert compared > 0.5 * elements
    # the bridged moments are what torch's Adam then stepped from
    opt = getattr(state, f"opt_{net}")
    assert all(float(opt.state[p]["step"]) == 2 for p in module.parameters())


def test_adam_bridge_refuses_a_mismatch(weights):
    _, tcfg = configs(**FIELDS)
    state = torch_state(tcfg, weights[1])
    mu = flat_dict(state.D)
    with pytest.raises(ValueError, match="exactly"):
        bridge_adam_state(state.opt_F, state.D, 1, mu, mu)
    del mu[next(iter(mu))]
    with pytest.raises(KeyError, match="cover"):
        bridge_adam_state(state.opt_D, state.D, 1, mu, flat_dict(state.D))
