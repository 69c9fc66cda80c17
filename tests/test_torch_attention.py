"""Port vs JAX: the IPSR attention primal and the coherence scan.

`scan_stream_reference` (the plain version of the CUDA kernel) is held
against the Pallas kernel `_scan_stream` run in interpret mode, and the
whole primal `ipsr_attention_batched` against both JAX paths: the
interpret-mode Pallas primal and the lax primal.

Tolerances, and why: `ind` must be exact (the scores differ in the last
ulps only, and these inputs have no near-ties).  On empty and partial masks
the chains are short: out to 1e-4 and (a, b) to 1e-5, the dot product's
summation order being the only difference.  On a full mask all N steps
chain, and the recurrence amplifies ~1.3x a step: rtol=2e-3, atol=1e-2, as
tests/test_attention_pallas.py holds the Pallas kernel against lax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu.ops import attention as JA
from deepinpainting_tpu.ops import attention_pallas as JAP
from deepinpainting_torch.ops import attention as TA
from deepinpainting_torch.ops import attention_cuda as TAC

H = W = 8
C = 16
N = H * W
B = 3

SHORT = dict(out=dict(rtol=1e-4, atol=1e-4), ab=dict(rtol=1e-5, atol=1e-5))
LONG = dict(out=dict(rtol=2e-3, atol=1e-2), ab=dict(rtol=2e-3, atol=1e-2))


def _flags(kind):
    f = np.zeros((B, N), np.float32)
    if kind == "full":
        f[:] = 1
    elif kind == "partial":
        f[0, 18:27] = 1           # a contiguous run mid-raster
        f[1, ::7] = 1             # scattered positions
        f[2, 50:53] = 1           # short chains: at most 10 masked steps
    return f


def _inputs(seed, kind):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ref = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return feat, ref, _flags(kind)


def _rows(x):
    return torch.from_numpy(x.reshape(B, N, C))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("known_replacement", [True, False])
@pytest.mark.parametrize("kind", ["empty", "partial", "full"])
def test_prep_matches_jax(kind, known_replacement):
    feat, ref, flag = _inputs(0, kind)
    jP, jPn, jind, jvmax, jknown = JAP._prep(
        jnp.asarray(feat), jnp.asarray(ref), jnp.asarray(flag),
        known_replacement)
    P, Pn, ind, vmax, known = TA.prep(_rows(feat), _rows(ref),
                                      torch.from_numpy(flag),
                                      known_replacement)
    np.testing.assert_array_equal(ind.numpy(), np.asarray(jind))
    np.testing.assert_array_equal(known.numpy(), np.asarray(jknown))
    np.testing.assert_allclose(Pn.numpy(), np.asarray(jPn), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(vmax.numpy(), np.asarray(jvmax), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("known_replacement", [True, False])
@pytest.mark.parametrize("kind", ["empty", "partial", "full"])
def test_plain_scan_matches_pallas_kernel(kind, known_replacement):
    """Same (flag, vmax, Pn, known) into both recurrences."""
    feat, ref, flag = _inputs(1, kind)
    _, Pn, _, vmax, known = TA.prep(_rows(feat), _rows(ref),
                                    torch.from_numpy(flag), known_replacement)
    k, q = JAP.plan_tiles(B, N, C)
    jout, ja, jb = JAP._scan_stream(
        jnp.asarray(flag), jnp.asarray(vmax.numpy()), jnp.asarray(Pn.numpy()),
        jnp.asarray(known.numpy()), k=k, q=q, interpret=True)
    out, a, b = TA.scan_stream_reference(torch.from_numpy(flag), vmax, Pn,
                                         known)
    tol = LONG if kind == "full" else SHORT
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol["out"])
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **tol["ab"])
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), **tol["ab"])
    # structure: unmasked rows emit `known` and (a, b) = (1, 0) exactly
    um = flag == 0
    np.testing.assert_array_equal(out.numpy()[um], known.numpy()[um])
    assert (a.numpy()[um] == 1).all() and (b.numpy()[um] == 0).all()
    # the first masked position of each sample copies its best patch
    for i in range(B):
        idx = np.flatnonzero(flag[i])
        if idx.size:
            assert a[i, idx[0]] == 0 and b[i, idx[0]] == 1


@pytest.mark.parametrize("known_replacement", [True, False])
@pytest.mark.parametrize("kind", ["empty", "partial", "full"])
def test_primal_matches_both_jax_paths(kind, known_replacement):
    feat, ref, flag = _inputs(2, kind)
    jf, jr, jm = jnp.asarray(feat), jnp.asarray(ref), jnp.asarray(flag)
    want_pallas = JAP.attention_primal_pallas_batched(
        jf, jr, jm, interpret=True, known_replacement=known_replacement)
    want_lax = jax.vmap(lambda f, r, m: JA._attention_core_primal(
        f, r, m, known_replacement))(jf, jr, jm)
    got = TA.ipsr_attention_batched(_nchw(feat), _nchw(ref),
                                    torch.from_numpy(flag),
                                    known_replacement=known_replacement)
    got = got.numpy().transpose(0, 2, 3, 1)
    tol = (LONG if kind == "full" else SHORT)["out"]
    np.testing.assert_allclose(got, np.asarray(want_pallas), **tol)
    np.testing.assert_allclose(got, np.asarray(want_lax), **tol)
    if not known_replacement:   # identity on known positions, exactly
        um = flag.reshape(B, H, W) == 0
        np.testing.assert_array_equal(got[um], feat[um])


def test_cpu_dispatch_uses_plain_version():
    feat, ref, flag = _inputs(3, "partial")
    before = TAC.launches
    for impl in (None, "cuda", "pallas", "torch", "lax"):
        out = TA.ipsr_attention_batched(_nchw(feat), _nchw(ref),
                                        torch.from_numpy(flag), impl=impl)
        assert out.shape == (B, C, H, W)
    assert TAC.launches == before


def test_kernel_wrapper_refuses_what_it_cannot_take():
    pn = torch.zeros(2, 4, 128)
    flag = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        TAC.scan_stream_cuda(flag, flag, pn, pn)
    with pytest.raises(ValueError):
        TAC.check_inputs(flag, flag, pn, torch.zeros(2, 4, 64))
    with pytest.raises(ValueError):
        TAC.check_inputs(flag, flag, torch.zeros(2, 4, 6), torch.zeros(2, 4, 6))
    with pytest.raises(ValueError):
        TAC.check_inputs(flag, torch.zeros(2, 5), pn, pn)
    with pytest.raises(ValueError):
        TA.check_impl("xla")
