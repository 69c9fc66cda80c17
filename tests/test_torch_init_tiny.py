"""The port's initial draw held to the JAX package's, leaf by leaf, for
the tiny test configuration at four seeds, under instance and batch norm
and under the init types whose spread depends on the fans (xavier,
kaiming), so that the transposed convs' fans are held (the checks of
tests/test_torch_init.py, which holds the full Config()); and
create_state's optimisers against JAX's."""

import jax
import numpy as np
import pytest

from deepinpainting_tpu.config import Config as JConfig
from deepinpainting_tpu.engine import inpaint as JI
from deepinpainting_tpu.engine import state as JST

from deepinpainting_torch.config import Config as TConfig

from test_torch_init import SEEDS, compare_draws, port_nets
from torch_port_helpers import TINY

_INITS = {}


def jax_init(jcfg):
    """JAX's init_params of `jcfg` under one jit, compiled once a
    configuration."""
    if jcfg not in _INITS:
        _INITS[jcfg] = jax.jit(lambda key: JI.init_params(jcfg, key))
    return _INITS[jcfg]


@pytest.mark.parametrize("kw", [
    {}, dict(norm="batch"), dict(init_type="xavier"),
    dict(init_type="kaiming")],
    ids=["normal", "batch", "xavier", "kaiming"])
def test_tiny_config_draw_matches_jax_leaf_by_leaf(kw):
    """The tiny test configuration, and the init types whose spread
    depends on the fans, so that the transposed convs' fans are held."""
    # the draw is the same under either attention; "lax" compiles faster
    kw = dict(kw, attention_impl="lax")
    jcfg, tcfg = JConfig(**TINY, **kw), TConfig(**TINY, **kw)
    res = compare_draws(jcfg, tcfg, SEEDS, jax_init(jcfg))
    for seed, (counted, problems) in res.items():
        assert counted > 100, (seed, counted)
        assert not problems, (seed, problems)


def test_create_state_optimisers_match_jax():
    """step 0; Adam(lr, (beta1, 0.999), eps 1e-8) over exactly the
    trained networks' parameters, moments empty (zero) as JAX's count-0
    state, with the same parameter counts; VGG frozen in both."""
    jcfg = JConfig(**TINY, attention_impl="lax")
    tcfg = TConfig(**TINY, attention_impl="lax")
    # JAX's create_state, on the init the "normal" case compiled
    js = JST.create_train_state(jcfg, jax_init(jcfg)(jax.random.PRNGKey(0)))
    ts, nets = port_nets(tcfg, 0)
    assert int(js.step) == ts.step == 0
    for net in ("G", "P", "D", "F"):
        jopt = getattr(js, f"opt_{net}")
        topt = getattr(ts, f"opt_{net}")
        hp = jopt.hyperparams
        g, = topt.param_groups
        assert g["lr"] == pytest.approx(float(hp["learning_rate"]))
        assert g["betas"] == (pytest.approx(float(hp["b1"])),
                              pytest.approx(float(hp["b2"])))
        assert g["eps"] == pytest.approx(float(hp["eps"]))
        adam = jopt.inner_state[0]
        assert int(adam.count) == 0
        assert all(not np.any(np.asarray(x))
                   for x in jax.tree_util.tree_leaves((adam.mu, adam.nu)))
        assert not topt.state                     # zero moments, lazily
        n_jax = sum(x.size for x in jax.tree_util.tree_leaves(adam.mu))
        assert n_jax == sum(p.numel() for p in g["params"])
        assert {id(p) for p in g["params"]} == {
            id(p) for p in nets[net].parameters()}
    assert not any(p.requires_grad for p in ts.vgg.parameters())
