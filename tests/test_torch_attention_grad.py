"""Port vs JAX: the attention matrix `kbar`, the training forward and the
attention's custom backward.

`kbar_build_reference` (the plain version of the CUDA kernel) is held
against the Pallas kernel `_kbar_build` run in interpret mode on the same
(flag, ind, a, b), and against the lax `attention_matrix`.  The
`torch.autograd.Function` behind `ipsr_attention_batched` is held against
`jax.vjp` of the JAX package's `ipsr_attention_batched`, through both of its
paths ('pallas' in interpret mode, and 'lax').

Tolerance 1e-5 (relative and absolute) throughout: every masked chain here
has at most 9 rows, so the recurrence amplifies the only difference (the
dot product's summation order; the port sums it in f64) by a few times
1e-7.  Structural facts are exact: unmasked rows and each sample's first
masked row are one-hot, bit for bit.

The faithful backward truncates kbar toward zero, which is discontinuous at
the integers: each truncating case first asserts, on the JAX result, that no
kbar entry outside the exactly one-hot rows lies within 1e-4 of a non-zero
integer, and then requires trunc(kbar) to be equal on both sides.
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
from torch_port_helpers import special_flags

H = W = 8
C = 16
N = H * W
B = 3
TOL = dict(rtol=1e-5, atol=1e-5)


def _flags(kind):
    f = np.zeros((B, N), np.float32)
    if kind == "partial":
        f[0, 18:27] = 1           # a contiguous run of 9
        f[1, ::8] = 1             # 8 scattered positions
        f[2, 50:53] = 1
    return f


def _inputs(seed, kind="partial"):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ref = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return feat, ref, _flags(kind)


def _rows(x):
    return torch.from_numpy(x.reshape(B, N, C))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _coefficients(feat, ref, flag, known_replacement):
    """(flag, ind, a, b) as the port's training forward makes them."""
    flag_t = torch.from_numpy(flag)
    _, Pn, ind, vmax, known = TA.prep(_rows(feat), _rows(ref), flag_t,
                                      known_replacement)
    _, a, b = TA.scan_stream_reference(flag_t, vmax, Pn, known)
    return flag_t, ind, a, b


def _one_hot_rows(flag):
    """[B, N] bool: rows that are one-hot by construction (unmasked rows
    and each sample's first masked row)."""
    exact = flag == 0
    for i in range(B):
        idx = np.flatnonzero(flag[i])
        if idx.size:
            exact[i, idx[0]] = True
    return exact


@pytest.mark.parametrize("known_replacement", [True, False])
@pytest.mark.parametrize("kind", ["empty", "partial"])
def test_plain_kbar_matches_pallas_kernel(kind, known_replacement):
    """The same (flag, ind, a, b) into both recurrences."""
    feat, ref, flag = _inputs(11, kind)
    flag_t, ind, a, b = _coefficients(feat, ref, flag, known_replacement)
    k, w = JAP.plan_kbar_tiles(B, N)
    want = JAP._kbar_build(jnp.asarray(flag), jnp.asarray(ind.numpy(),
                                                          jnp.int32),
                           jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                           k=k, w=w, interpret=True)
    got = TA.kbar_build_reference(flag_t, ind, a, b)
    assert got.shape == (B, N, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # int32 and int64 indices give the same bits
    assert torch.equal(got, TA.kbar_build_reference(flag_t, ind.int(), a, b))


@pytest.mark.parametrize("known_replacement", [True, False])
def test_kbar_structure_is_exact(known_replacement):
    feat, ref, flag = _inputs(12)
    flag_t, ind, a, b = _coefficients(feat, ref, flag, known_replacement)
    kbar = TA.kbar_build_reference(flag_t, ind, a, b).numpy()
    onehot = np.eye(N, dtype=np.float32)[ind.numpy()]
    exact = _one_hot_rows(flag)
    np.testing.assert_array_equal(kbar[exact], onehot[exact])
    if not known_replacement:      # identity on known positions
        um = flag == 0
        np.testing.assert_array_equal(kbar[um], np.eye(N, dtype=np.float32)[
            np.nonzero(um)[1]])
    # a masked row after the first blends: a * previous row + b * one-hot
    q = 20
    np.testing.assert_array_equal(
        kbar[0, q], a[0, q].item() * kbar[0, q - 1] + b[0, q].item()
        * onehot[0, q])


@pytest.mark.parametrize("known_replacement", [True, False])
def test_core_matches_lax_attention_matrix(known_replacement):
    """The port's whole training forward against the lax formulation:
    kbar, and out = kbar @ P, which equals the scan's own `out` up to
    rounding."""
    feat, ref, flag = _inputs(13)
    want_k = jax.vmap(lambda f, r, m: JA.attention_matrix(
        f, r, m, known_replacement))(jnp.asarray(feat), jnp.asarray(ref),
                                     jnp.asarray(flag))
    want_out, _ = jax.vmap(lambda f, r, m: JA._attention_core(
        f, r, m, known_replacement))(jnp.asarray(feat), jnp.asarray(ref),
                                     jnp.asarray(flag))
    out, kbar = TA.attention_core_batched(
        _nchw(feat), _nchw(ref), torch.from_numpy(flag),
        known_replacement=known_replacement)
    np.testing.assert_allclose(kbar.numpy(), np.asarray(want_k), **TOL)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want_out), **TOL)
    primal = TA.ipsr_attention_batched(
        _nchw(feat), _nchw(ref), torch.from_numpy(flag),
        known_replacement=known_replacement)
    np.testing.assert_allclose(out.numpy(), primal.numpy(), **TOL)


def _assert_safe_to_truncate(feat, ref, flag, known_replacement):
    kbar = np.asarray(jax.vmap(lambda f, r, m: JA.attention_matrix(
        f, r, m, known_replacement))(jnp.asarray(feat), jnp.asarray(ref),
                                     jnp.asarray(flag)))
    blended = kbar[~_one_hot_rows(flag)]
    nearest = np.rint(blended)
    risky = (np.abs(blended - nearest) < 1e-4) & (nearest != 0)
    assert not risky.any(), "inputs put a kbar entry next to an integer"
    return kbar


@pytest.mark.parametrize("known_replacement", [True, False])
@pytest.mark.parametrize("truncate_backward", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "lax"])
def test_function_matches_jax_vjp(impl, truncate_backward,
                                  known_replacement):
    feat, ref, flag = _inputs(14)
    g = np.random.default_rng(15).standard_normal(feat.shape
                                                  ).astype(np.float32)
    tw = 0.7
    if truncate_backward:
        jk = _assert_safe_to_truncate(feat, ref, flag, known_replacement)
        _, kbar = TA.attention_core_batched(
            _nchw(feat), _nchw(ref), torch.from_numpy(flag),
            known_replacement=known_replacement)
        np.testing.assert_array_equal(np.trunc(kbar.numpy()), np.trunc(jk))
    want_out, vjp = jax.vjp(
        lambda f: JA.ipsr_attention_batched(
            f, jnp.asarray(ref), jnp.asarray(flag), tw, truncate_backward,
            impl, known_replacement), jnp.asarray(feat))
    want_grad, = vjp(jnp.asarray(g))

    x = _nchw(feat).requires_grad_(True)
    out = TA.ipsr_attention_batched(
        x, _nchw(ref), torch.from_numpy(flag), triple_weight=tw,
        truncate_backward=truncate_backward,
        known_replacement=known_replacement, impl=impl)
    out.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(out), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(_nhwc(x.grad), np.asarray(want_grad), **TOL)


def test_truncated_backward_keeps_only_integer_weights():
    """With truncation, K^T g moves gradient along the one-hot rows only:
    on an empty mask every row is one-hot and the two modes coincide; on a
    masked chain they differ."""
    g = _nchw(np.random.default_rng(16).standard_normal(
        (B, H, W, C)).astype(np.float32))

    def grad(kind, truncate_backward):
        feat, ref, flag = _inputs(17, kind)
        x = _nchw(feat).requires_grad_(True)
        TA.ipsr_attention_batched(
            x, _nchw(ref), torch.from_numpy(flag),
            truncate_backward=truncate_backward).backward(g)
        return x.grad

    assert torch.equal(grad("empty", True), grad("empty", False))
    assert not torch.equal(grad("partial", True), grad("partial", False))


def test_ref_and_flag_get_no_gradient():
    feat, ref, flag = _inputs(18)
    x = _nchw(feat).requires_grad_(True)
    r = _nchw(ref).requires_grad_(True)
    m = torch.from_numpy(flag).requires_grad_(True)
    TA.ipsr_attention_batched(x, r, m).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert r.grad is None and m.grad is None


def test_kbar_is_built_only_when_a_gradient_is_wanted(monkeypatch):
    """Serving must not start building an [N, N] matrix a sample."""
    built = []
    plain = TA.kbar_build_reference
    monkeypatch.setattr(TA, "kbar_build",
                        lambda *a: built.append(1) or plain(*a))
    feat, ref, flag = _inputs(19)
    args = (_nchw(ref), torch.from_numpy(flag))
    TA.ipsr_attention_batched(_nchw(feat), *args)       # no grad required
    with torch.no_grad():
        TA.ipsr_attention_batched(_nchw(feat).requires_grad_(True), *args)
    with torch.inference_mode():
        TA.ipsr_attention_batched(_nchw(feat), *args)
    assert not built
    out = TA.ipsr_attention_batched(_nchw(feat).requires_grad_(True), *args)
    assert built == [1] and out.requires_grad


def test_cpu_training_forward_launches_no_kernel():
    feat, ref, flag = _inputs(20)
    before = (TAC.launches, TAC.kbar_launches)
    for impl in (None, "cuda", "pallas", "torch", "lax"):
        x = _nchw(feat).requires_grad_(True)
        TA.ipsr_attention_batched(x, _nchw(ref), torch.from_numpy(flag),
                                  impl=impl).sum().backward()
    assert (TAC.launches, TAC.kbar_launches) == before


def test_kbar_wrapper_refuses_what_it_cannot_take():
    flag = torch.zeros(2, 8)
    ind = torch.zeros(2, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        TAC.kbar_build_cuda(flag, ind, flag, flag)
    with pytest.raises(ValueError, match=r"\[2, 8\]"):
        TAC.check_kbar_inputs(flag, ind[:, :4], flag, flag)
    with pytest.raises(ValueError, match=r"\[B, N\]"):
        TAC.check_kbar_inputs(flag[0], ind[0], flag[0], flag[0])


# ---- the schedule of the CUDA kbar kernel, emulated in plain PyTorch -------
# csrc/kbar_build.cu compacts each sample's masked rows, runs the row
# recurrence over those alone (every column, every masked row), and fills
# the unmasked rows with their one-hot rows in parallel.  Held here bit for
# bit against the plain version, which walks every row.

def _kbar_over_masked_rows_only(flag, ind, a, b):
    bsz, n = flag.shape
    cols = torch.arange(n)
    kbar = (cols == ind[:, :, None]).to(torch.float32)    # the parallel fill
    for s in range(bsz):
        row = torch.zeros(n)
        for q in torch.nonzero(flag[s] > 0).flatten().tolist():   # in order
            row = a[s, q] * row + b[s, q] * kbar[s, q]
            kbar[s, q] = row
    return kbar


@pytest.mark.parametrize("known_replacement", [True, False])
@pytest.mark.parametrize("case,dtype", [
    ("no row", torch.int64), ("every row", torch.int32),
    ("first row", torch.int64), ("last row", torch.int32),
    ("hole per sample", torch.int64), ("ragged N", torch.int32)])
def test_chain_over_masked_rows_only_equals_plain_kbar(case, dtype,
                                                       known_replacement):
    n = 45 if case == "ragged N" else N       # 45: no multiple of 32
    rng = np.random.default_rng(12)
    feat = torch.from_numpy(rng.standard_normal((B, n, C)).astype(np.float32))
    ref = torch.from_numpy(rng.standard_normal((B, n, C)).astype(np.float32))
    flag = torch.from_numpy(special_flags(case, B, n))
    _, pn, ind, vmax, known = TA.prep(feat, ref, flag, known_replacement)
    _, a, b = TA.scan_stream_reference(flag, vmax, pn, known)
    ind = ind.to(dtype)
    want = TA.kbar_build_reference(flag, ind, a, b)
    got = _kbar_over_masked_rows_only(flag, ind, a, b)
    assert torch.equal(got, want)
    assert torch.equal(got.trunc(), want.trunc())


def test_masked_rows_only_carries_the_nan_of_an_infinite_coefficient():
    """0 * inf is NaN in every column that no index has selected yet, so the
    chain must run over every column of a masked row; an index outside
    [0, N) selects none."""
    flag = torch.zeros(1, 12)
    flag[0, [2, 3, 7, 9]] = 1
    ind = torch.tensor([[1, 4, 5, 5, 2, 0, 3, 40, 8, -3, 6, 11]])
    a = torch.ones(1, 12)
    b = torch.zeros(1, 12)
    a[0, [2, 3, 7, 9]] = torch.tensor([0.0, float("inf"), 0.5, -2.0])
    b[0, [2, 3, 7, 9]] = torch.tensor([1.0, 0.25, 0.5, 3.0])
    want = TA.kbar_build_reference(flag, ind, a, b)
    got = _kbar_over_masked_rows_only(flag, ind, a, b)
    assert bool(want[0, 3].isnan().sum() >= 10)           # the NaN is there
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


def test_masked_rows_only_differs_from_plain_in_the_sign_of_a_zero_only():
    """a and b both negative on a zero running value leave -0.  The plain
    version's step on the next unmasked row, 1*(-0) + 0*x, turns it into
    +0; a chain that skips that row keeps -0.  The scan never emits such
    coefficients (a + b = 1).  The two results compare equal and truncate
    alike; they differ in the sign bit of some zeros and nowhere else."""
    flag = torch.tensor([[1.0, 0.0, 1.0, 0.0]])
    ind = torch.tensor([[0, 1, 2, 3]])
    a = torch.tensor([[-0.5, 1.0, 0.5, 1.0]])
    b = torch.tensor([[-0.5, 0.0, -0.25, 0.0]])
    want = TA.kbar_build_reference(flag, ind, a, b)
    got = _kbar_over_masked_rows_only(flag, ind, a, b)
    assert torch.equal(got, want)
    assert torch.equal(got.trunc(), want.trunc())
    differs = torch.signbit(got) != torch.signbit(want)
    assert bool(differs.any())
    assert bool((got[differs] == 0).all()) and bool((want[differs] == 0).all())
