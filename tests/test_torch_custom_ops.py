"""The two kernels as custom ops, `deepinpainting::scan_stream` and
`deepinpainting::kbar_build` (ops/attention.py), on the CPU.

torch.library.opcheck checks each op's schema, its fake implementation and
its behaviour under tracing; each op must equal its plain version bit for
bit (on the CPU the op's implementation is the plain version); the fake
implementations must give the shapes and dtypes of the real ones.  The
ops' CUDA implementation (the kernel wrappers) is held against the plain
versions in tests/test_torch_kernels_gpu.py, on the card.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from deepinpainting_torch.ops import attention as TA
from deepinpainting_torch.ops import attention_cuda as TAC
from torch_port_helpers import special_flags

CASES = ["no row", "every row", "first row", "last row", "hole per sample",
         "ragged N"]


def _inputs(case, seed=0, b=3, c=8):
    n = 37 if case == "ragged N" else 32
    rng = np.random.default_rng(seed)
    pn = torch.from_numpy(np.abs(rng.standard_normal((b, n, c))
                                 ).astype(np.float32))
    pn = (pn / pn.norm(dim=2, keepdim=True)).contiguous()
    known = torch.from_numpy(np.abs(rng.standard_normal((b, n, c))
                                    ).astype(np.float32))
    vmax = torch.from_numpy(rng.random((b, n)).astype(np.float32) + 0.5)
    flag = torch.from_numpy(special_flags(case, b, n))
    ind = torch.from_numpy(rng.integers(0, n, (b, n)))
    return flag, vmax, pn, known, ind


def test_ops_are_registered_in_the_port_namespace():
    assert TA.OP_NAMESPACE == "deepinpainting"
    ns = getattr(torch.ops, TA.OP_NAMESPACE)
    assert "Tensor" in str(ns.scan_stream.default._schema)
    assert "Tensor" in str(ns.kbar_build.default._schema)
    # the module's names are the ops themselves
    assert TA.scan_stream._opoverload is ns.scan_stream.default
    assert TA.kbar_build._opoverload is ns.kbar_build.default


@pytest.mark.parametrize("case", CASES)
def test_opcheck_scan_stream(case):
    flag, vmax, pn, known, _ = _inputs(case)
    torch.library.opcheck(TA.scan_stream, (flag, vmax, pn, known))


@pytest.mark.parametrize("ind_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("case", CASES)
def test_opcheck_kbar_build(case, ind_dtype):
    flag, vmax, pn, known, ind = _inputs(case)
    _, a, b = TA.scan_stream_reference(flag, vmax, pn, known)
    torch.library.opcheck(TA.kbar_build, (flag, ind.to(ind_dtype), a, b))


@pytest.mark.parametrize("case", CASES)
def test_ops_equal_plain_versions(case):
    flag, vmax, pn, known, ind = _inputs(case, seed=1)
    before = (TAC.launches, TAC.kbar_launches)
    got = torch.ops.deepinpainting.scan_stream(flag, vmax, pn, known)
    want = TA.scan_stream_reference(flag, vmax, pn, known)
    assert len(got) == 3
    for g, w, x in zip(got, want, (known, vmax, vmax)):
        assert torch.equal(g, w)
        assert g.data_ptr() != x.data_ptr()        # a new tensor
    kbar = torch.ops.deepinpainting.kbar_build(flag, ind, got[1], got[2])
    assert torch.equal(kbar, TA.kbar_build_reference(flag, ind, got[1],
                                                     got[2]))
    assert torch.equal(kbar, TA.kbar_build(flag, ind.int(), got[1], got[2]))
    # the CPU implementation never reaches the kernel wrappers
    assert (TAC.launches, TAC.kbar_launches) == before


def test_fake_implementations_give_the_shapes():
    flag, vmax, pn, known, ind = _inputs("first row", b=2, c=12)
    bsz, n, c = pn.shape
    with FakeTensorMode() as mode:
        args = [mode.from_tensor(t) for t in (flag, vmax, pn, known, ind)]
        out, a, b = TA.scan_stream(*args[:4])
        kbar = TA.kbar_build(args[0], args[4], a, b)
    assert (tuple(out.shape), tuple(a.shape), tuple(b.shape)) == (
        (bsz, n, c), (bsz, n), (bsz, n))
    assert {out.dtype, a.dtype, b.dtype, kbar.dtype} == {torch.float32}
    assert tuple(kbar.shape) == (bsz, n, n)
    # the meta device takes the fake implementations too
    meta = [t.to("meta") for t in (flag, vmax, pn, known, ind)]
    out, a, b = TA.scan_stream(*meta[:4])
    kbar = TA.kbar_build(meta[0], meta[4].int(), a, b)
    assert out.device.type == "meta" and tuple(kbar.shape) == (bsz, n, n)


def test_the_attention_goes_through_the_ops(monkeypatch):
    """The kbar-free primal calls the scan op, the training forward both
    ops: the graph that torch.export sees names them."""
    flag, _, _, _, _ = _inputs("hole per sample", b=2)
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.standard_normal((2, 8, 4, 8)
                                                ).astype(np.float32))
    ref = torch.from_numpy(np.abs(rng.standard_normal((2, 8, 4, 8))
                                  ).astype(np.float32))
    seen = []
    for name in ("scan_stream", "kbar_build"):
        op = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _op=op, _n=name:
                            seen.append(_n) or _op(*a))
    with torch.no_grad():
        TA.ipsr_attention_batched(feat, ref, flag)
    assert seen == ["scan_stream"]
    TA.ipsr_attention_batched(feat.requires_grad_(True), ref, flag)
    assert seen == ["scan_stream", "scan_stream", "kbar_build"]
