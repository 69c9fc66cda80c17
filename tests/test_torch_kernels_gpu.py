"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA card: it carries the `gpu` marker and skips
where none is present.  The file imports no JAX, so it also runs where JAX
is not installed; tests/conftest.py imports JAX, so run it as

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from deepinpainting_torch.config import Config
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import attention as TA
from deepinpainting_torch.ops import attention_cuda as TAC

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scan_inputs(b, n, c, starts, seed):
    rng = np.random.default_rng(seed)
    pn = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    pn = pn / pn.norm(dim=2, keepdim=True)
    known = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    vmax = torch.from_numpy(rng.random((b, n)).astype(np.float32) + 0.5)
    flag = torch.zeros(b, n)
    for s in starts:
        flag[:, s:s + 3] = 1
    return flag, vmax, pn, known


@pytest.mark.parametrize("c", [64, 128, 200, 512, 1024])
def test_kernel_matches_plain(cuda, c):
    """Short chains (9 masked positions), C from the tiny config's 64 to
    the kernel's limit: both round the f64 dot product once to f32, so
    they agree to far better than the short-chain limit of 2e-3."""
    args = [t.to(cuda).contiguous()
            for t in _scan_inputs(4, 1024, c, (100, 400, 900), seed=c)]
    before = TAC.launches
    got = TAC.scan_stream_cuda(*args)
    want = TA.scan_stream_reference(*args)
    torch.cuda.synchronize()
    assert TAC.launches == before + 1
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 2e-3
    um = args[0] == 0
    assert torch.equal(got[0][um], args[3][um])
    assert bool((got[1][um] == 1).all()) and bool((got[2][um] == 0).all())


def _benign_scan_inputs(b, n, c, flag, seed):
    """Non-negative pn and known: at > 0 and (a, b) in (0, 1), so a chain of
    any length stays a convex blend and the short-chain limit applies."""
    rng = np.random.default_rng(seed)
    pn = torch.from_numpy(np.abs(rng.standard_normal((b, n, c))
                                 ).astype(np.float32))
    pn = pn / pn.norm(dim=2, keepdim=True)
    known = torch.from_numpy(np.abs(rng.standard_normal((b, n, c))
                                    ).astype(np.float32))
    vmax = torch.from_numpy(rng.random((b, n)).astype(np.float32) + 0.5)
    return flag.float(), vmax, pn, known


def _special_flag(case, b, n):
    flag = torch.zeros(b, n)
    if case == "every row":
        flag[:] = 1
    elif case == "first row":
        flag[:, 0] = 1
        flag[:, n // 2:n // 2 + 5] = 1
    elif case == "last row":
        flag[:, n - 1] = 1
        flag[:, n // 3:n // 3 + 4] = 1
    elif case == "per sample":
        for i in range(b):                 # sample 0 has no masked row
            flag[i, (7 * i) % n:(7 * i) % n + 3 * i] = 1
    elif case == "scattered":
        flag = (torch.rand(b, n, generator=torch.Generator().manual_seed(n))
                < 0.2).float()
    else:
        assert case == "no row"
    return flag


# (case, B, N, C): the cases the chain-over-masked-rows design makes
# special.  N=48 is no multiple of 32, N=5000 needs two compaction tiles,
# C=64 leaves three consumer warps without a float4, C=1024 gives a thread
# two, B=200 is more samples than the card has SMs.
_SCAN_SPECIAL = [
    ("no row", 2, 1024, 512), ("every row", 2, 256, 512),
    ("first row", 2, 1024, 512), ("last row", 2, 1024, 512),
    ("per sample", 5, 1024, 512), ("scattered", 2, 48, 512),
    ("every row", 1, 48, 64), ("scattered", 2, 4096, 512),
    ("scattered", 1, 5000, 128), ("scattered", 3, 1024, 64),
    ("scattered", 2, 512, 1024), ("per sample", 200, 256, 128),
    ("no row", 1, 1, 4), ("every row", 1, 1, 4)]


@pytest.mark.parametrize("case,b,n,c", _SCAN_SPECIAL)
def test_scan_kernel_special_cases(cuda, case, b, n, c):
    args = [t.to(cuda).contiguous() for t in _benign_scan_inputs(
        b, n, c, _special_flag(case, b, n), seed=n + c)]
    got = TAC.scan_stream_cuda(*args)
    torch.cuda.synchronize()
    want = TA.scan_stream_reference(*args)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert (g - w).abs().max().item() <= 2e-3
    um = args[0] == 0
    assert torch.equal(got[0][um], args[3][um])
    assert bool((got[1][um] == 1).all()) and bool((got[2][um] == 0).all())
    torch.cuda.synchronize()


def test_kernel_refuses_bad_inputs(cuda):
    flag, vmax, pn, known = (t.to(cuda) for t in
                             _scan_inputs(2, 8, 128, (2,), seed=0))
    with pytest.raises(ValueError):
        TAC.scan_stream_cuda(flag, vmax, pn.double(), known)
    with pytest.raises(ValueError):
        TAC.scan_stream_cuda(flag, vmax, pn[:, :, :66].contiguous(),
                             known[:, :, :66].contiguous())
    with pytest.raises(ValueError):
        TAC.scan_stream_cuda(flag, vmax,
                             pn.transpose(1, 2).contiguous().transpose(1, 2),
                             known)


def _kbar_inputs(b, n, seed, dtype=torch.int64):
    """(flag, ind, a, b) with masked runs, repeated best patches (entries
    a*1 + b*1 next to 1) and coefficients outside [0, 1]."""
    g = torch.Generator().manual_seed(seed)
    flag = (torch.rand(b, n, generator=g) < 0.3).float()
    ind = torch.randint(0, n, (b, n), generator=g)
    ind[:, 1::2] = torch.where(torch.rand(b, n // 2, generator=g) < 0.5,
                               ind[:, 0:2 * (n // 2):2], ind[:, 1::2])
    a = torch.where(flag > 0, torch.rand(b, n, generator=g) * 1.4 - 0.2,
                    torch.ones(b, n))
    return flag, ind.to(dtype), a, torch.where(flag > 0, 1 - a,
                                               torch.zeros(b, n))


@pytest.mark.parametrize("b,n,dtype", [
    (8, 1024, torch.int64), (8, 1024, torch.int32), (1, 1024, torch.int64),
    (3, 100, torch.int64), (2, 1, torch.int32), (2, 4096, torch.int64)])
def test_kbar_kernel_equals_plain_bit_for_bit(cuda, b, n, dtype):
    """No reduction anywhere and no FMA contraction in the kernel: the two
    must agree exactly, also where N is no multiple of a chain block's
    256 columns (100, 1) and where it spans two compaction tiles (4096)."""
    args = [t.to(cuda) for t in _kbar_inputs(b, n, seed=n + b, dtype=dtype)]
    before = TAC.kbar_launches
    got = TAC.kbar_build_cuda(*args)
    want = TA.kbar_build_reference(*args)
    torch.cuda.synchronize()
    assert TAC.kbar_launches == before + 1
    assert got.shape == (b, n, n) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(got.trunc(), want.trunc())
    um = args[0] == 0
    onehot = torch.nn.functional.one_hot(args[1][um].long(), n).float()
    assert torch.equal(got[um], onehot)


# (case, B, N, dtype) as for the scan; "inf" puts an infinite and a
# negative coefficient on masked rows (0*inf is NaN in every column no
# index selects, and the kernel must carry it as the plain version does).
_KBAR_SPECIAL = [
    ("no row", 2, 1024, torch.int64), ("every row", 2, 256, torch.int32),
    ("first row", 2, 1024, torch.int64), ("last row", 2, 1024, torch.int32),
    ("per sample", 5, 1024, torch.int64), ("scattered", 2, 48, torch.int64),
    ("scattered", 1, 4096, torch.int64), ("scattered", 1, 5000, torch.int32),
    ("per sample", 200, 256, torch.int64), ("inf", 2, 96, torch.int64),
    ("every row", 1, 1, torch.int64), ("scattered", 2, 3, torch.int32)]


@pytest.mark.parametrize("case,b,n,dtype", _KBAR_SPECIAL)
def test_kbar_kernel_special_cases(cuda, case, b, n, dtype):
    _, ind, a, bb = _kbar_inputs(b, n, seed=n, dtype=dtype)
    flag = _special_flag("scattered" if case == "inf" else case, b, n)
    a = torch.where(flag > 0, a, torch.ones(b, n))
    bb = torch.where(flag > 0, 1 - a, torch.zeros(b, n))
    if case == "inf":
        rows = flag[0].nonzero().flatten()
        a[0, rows[1]] = float("inf")
        a[1, flag[1].nonzero().flatten()[0]] = -0.5
        ind[:, 0] = n + 7                  # outside [0, N): no column
    args = [t.to(cuda).contiguous() for t in (flag, ind, a, bb)]
    got = TAC.kbar_build_cuda(*args)
    torch.cuda.synchronize()
    want = TA.kbar_build_reference(*args)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    assert torch.equal(got.trunc().nan_to_num(7.0),
                       want.trunc().nan_to_num(7.0))
    torch.cuda.synchronize()


def test_kbar_kernel_refuses_bad_inputs(cuda):
    flag, ind, a, b = (t.to(cuda) for t in _kbar_inputs(2, 64, seed=0))
    with pytest.raises(ValueError):
        TAC.kbar_build_cuda(flag, ind.float(), a, b)
    with pytest.raises(ValueError):
        TAC.kbar_build_cuda(flag.double(), ind, a, b)
    with pytest.raises(ValueError):
        TAC.kbar_build_cuda(flag, ind, a[:, :32], b)
    with pytest.raises(ValueError):
        TAC.kbar_build_cuda(flag, ind, a.t().contiguous().t(), b)
    with pytest.raises(ValueError):
        TAC.kbar_build_cuda(flag, ind.cpu(), a, b)


@pytest.mark.parametrize("truncate_backward", [True, False])
def test_attention_function_on_card_matches_plain(cuda, truncate_backward):
    """The training forward and its backward through both kernels against
    the same Function through the plain versions, short chains."""
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.standard_normal((2, 64, 16, 16))
                            .astype(np.float32)).to(cuda)
    ref = torch.from_numpy(np.abs(rng.standard_normal((2, 64, 16, 16)))
                           .astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal((2, 64, 16, 16))
                         .astype(np.float32)).to(cuda)
    flag = torch.zeros(2, 256, device=cuda)
    flag[:, 40:43] = 1
    flag[:, 200:203] = 1
    res = {}
    before = (TAC.launches, TAC.kbar_launches)
    for impl in ("cuda", "torch"):
        x = feat.clone().requires_grad_(True)
        out = TA.ipsr_attention_batched(x, ref, flag, triple_weight=0.5,
                                        truncate_backward=truncate_backward,
                                        impl=impl)
        out.backward(g)
        res[impl] = (out.detach(), x.grad)
    assert (TAC.launches, TAC.kbar_launches) == (before[0] + 1, before[1] + 1)
    assert (res["cuda"][0] - res["torch"][0]).abs().max().item() <= 1e-5
    assert (res["cuda"][1] - res["torch"][1]).abs().max().item() <= 1e-5


def test_tiny_train_step_on_card(cuda):
    """Two steps at the tiny config through both kernels: finite losses,
    one launch of each kernel a step, and the first step's losses within
    1e-3 of the same step through the plain versions."""
    cfg = Config(fine_size=64, ngf=8, ndf=8, vgg_width_scale=1 / 8,
                 batch_size=2)
    rng = np.random.default_rng(2)
    batch = {"image": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
             "ref": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
             "mask": np.zeros((2, 64, 64), np.uint8)}
    batch["mask"][:, 16:28, 32:44] = 1
    losses = {}
    for impl in ("cuda", "torch"):
        icfg = cfg.replace(attention_impl=impl)
        state = TI.create_state(icfg, torch.Generator().manual_seed(0), cuda)
        step = TI.make_train_step(icfg, cuda)
        before = (TAC.launches, TAC.kbar_launches)
        _, m1 = step(state, batch)
        _, m2 = step(state, batch)
        n = 2 if impl == "cuda" else 0
        assert (TAC.launches, TAC.kbar_launches) == (before[0] + n,
                                                     before[1] + n)
        assert state.step == 2
        assert all(torch.isfinite(v) for v in m2.values())
        losses[impl] = {k: v.item() for k, v in m1.items()}
    for k, v in losses["torch"].items():
        assert abs(losses["cuda"][k] - v) <= 1e-3 * max(abs(v), 1e-12), k


def test_tiny_serving_on_card_matches_cpu(cuda):
    """The whole two-stage forward at a small config: on the card through
    the kernel, on the CPU through the plain version, same weights."""
    cfg = Config(fine_size=64, ngf=8, vgg_width_scale=1 / 8)
    cpu = TI.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = TI.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(1)
    gt = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    ref = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    mask = np.zeros((2, 64, 64), np.uint8)
    mask[:, 20:40, 24:40] = 1
    before = TAC.launches
    got, _ = TI.make_inference_fn(cfg, cuda)(*gpu, gt, mask, ref)
    want, _ = TI.make_inference_fn(cfg, "cpu")(*cpu, gt, mask, ref)
    assert TAC.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3)


def test_custom_ops_dispatch_to_the_kernels(cuda):
    """On CUDA tensors the ops `deepinpainting::scan_stream` and
    `deepinpainting::kbar_build` are the kernel wrappers: each call
    launches once and gives the wrapper's bits."""
    flag, vmax, pn, known = (t.to(cuda).contiguous() for t in
                             _scan_inputs(2, 1024, 512, (100, 600), seed=3))
    before = (TAC.launches, TAC.kbar_launches)
    out = torch.ops.deepinpainting.scan_stream(flag, vmax, pn, known)
    want = TAC.scan_stream_cuda(flag, vmax, pn, known)
    ind = torch.randint(0, 1024, (2, 1024), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    kbar = torch.ops.deepinpainting.kbar_build(flag, ind.int(), out[1],
                                               out[2])
    torch.cuda.synchronize()
    assert (TAC.launches, TAC.kbar_launches) == (before[0] + 2,
                                                 before[1] + 1)
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    assert torch.equal(kbar, TA.kbar_build_reference(flag, ind, out[1],
                                                     out[2]))


def test_exported_serving_on_card(cuda, tmp_path, monkeypatch):
    """The tiny config's artifact exported and loaded on the card: equal
    to the live serving function at B=1 and B=3, one scan launch a call.
    cuDNN's default transposed convolution sums with atomics (two live
    calls may differ by 1 in a uint8 pixel), so both run with its
    deterministic algorithms."""
    from deepinpainting_torch.engine import export_model as EM
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = Config(fine_size=64, ngf=8, vgg_width_scale=1 / 8)
    models = TI.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    EM.export_serving(cfg, models, str(tmp_path), device=cuda)
    loaded = EM.load_serving(str(tmp_path), cuda)
    live = TI.make_serving_fn(cfg, cuda)
    rng = np.random.default_rng(0)
    for b in (1, 3):
        img = rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
        mask = np.zeros((b, 64, 64), np.uint8)
        mask[:, 16:40, 20:44] = 1
        before = TAC.launches
        got = loaded.call(loaded.G, loaded.P, loaded.vgg, img, mask, img)
        torch.cuda.synchronize()
        assert TAC.launches == before + 1
        assert torch.equal(got, live(*models, img, mask, img))
    with pytest.raises(ValueError, match="'cuda'"):
        EM.load_serving(str(tmp_path), "cpu")


@pytest.mark.parametrize("geometry", [
    ("conv", 4, 2, 1, 1, 1, 32, 48, 8),     # 16 output rows: M padded
    ("conv", 4, 2, 3, 2, 8, 64, 20, 32),    # dilated, Cout 20
    ("conv", 3, 1, 1, 1, 2, 64, 64, 64),
    ("deconv", 4, 2, 1, 1, 1, 512, 512, 1),     # the 1x1 innermost level
    ("deconv", 3, 1, 1, 1, 2, 128, 64, 32)])
def test_int8_convs_on_card_match_cpu(cuda, geometry):
    """torch._int_mm on the card (cuBLASLt, with its M > 16 and multiple-
    of-8 K and N rules met by the padding) gives the CPU's int32 sums and
    its f64 plain version's, and the whole int8 conv equals the CPU's bit
    for bit (the quantisation is IEEE division and round-half-even on
    both)."""
    from deepinpainting_torch.ops import quant as TQ
    kind, k, s, p, d, b, cin, cout, h = geometry
    rng = np.random.default_rng(cin + h)
    x = torch.from_numpy(rng.normal(0, 0.5, (b, cin, h, h)).astype(np.float32))
    shape = (cout, cin, k, k) if kind == "conv" else (cin, cout, k, k)
    w = torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.01, cout).astype(np.float32))
    if kind == "conv":
        conv = lambda x, w, b: TQ.conv2d_int8(x, w, b, s, p, d)
        int32 = lambda x, w: TQ.conv2d_int32(x, w, s, p, d)
        plain = lambda x, w: TQ.conv2d_int32_reference(x, w, s, p, d)
    else:
        conv = lambda x, w, b: TQ.conv_transpose2d_int8(x, w, b, s, p)
        int32 = lambda x, w: TQ.conv_transpose2d_int32(x, w, s, p)
        plain = lambda x, w: TQ.conv_transpose2d_int32_reference(x, w, s, p)
    xq, _ = TQ.quantize_activation(x)
    wq, _ = TQ.quantize_weight(w, transposed=kind == "deconv")
    got = int32(xq.to(cuda), wq.to(cuda))
    assert torch.equal(got.cpu(), int32(xq, wq))
    assert torch.equal(got, plain(xq.to(cuda), wq.to(cuda)))
    assert torch.equal(conv(x.to(cuda), w.to(cuda), bias.to(cuda)).cpu(),
                       conv(x, w, bias))


@pytest.mark.parametrize("knobs", [dict(quant="int8"),
                                   dict(pack_small_cin=True, pack_out=True)])
def test_tiny_conv_knobs_on_card_match_cpu(cuda, knobs):
    """int8 and both pack modes through the whole two-stage forward at a
    small config: card against CPU, as test_tiny_serving_on_card_matches_
    cpu holds the default path."""
    cfg = Config(fine_size=64, ngf=8, vgg_width_scale=1 / 8, **knobs)
    cpu = TI.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = TI.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(1)
    gt = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    ref = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    mask = np.zeros((2, 64, 64), np.uint8)
    mask[:, 20:40, 24:40] = 1
    got, _ = TI.make_inference_fn(cfg, cuda)(*gpu, gt, mask, ref)
    want, _ = TI.make_inference_fn(cfg, "cpu")(*cpu, gt, mask, ref)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3)
