"""IPSR coherent-semantic shift attention: the inference primal, and the
training forward with its custom backward (counterpart of
deepinpainting_tpu/ops/attention.py and the pre-stage of
ops/attention_pallas.py).

Given the decoder feature `feat` and the VGG relu4_3 feature of the
reference image `ref`, with per-position masked flags:

  1. view every spatial position of `feat` as a patch P[p] in R^C and
     L2-normalise a copy Pn;
  2. scores[p, q] = <Pn[p], ref[q]>, one batched matrix product;
  3. per position q: ind[q] = argmax_p scores (first index on ties) and
     vmax[q] = max_p scores; known[q] = P[ind[q]];
  4. the raster-order coherence recurrence over q (`scan_stream`):
       first masked q:  out = known_q                      (a, b) = (0, 1)
       later masked q:  at = <Pn_q, out_prev>
                        a = at/(at+vmax_q), b = vmax_q/(at+vmax_q)
                        out = a*out_prev + b*known_q       carry advances
       unmasked q:      out = known_q                      (a, b) = (1, 0)

Steps 1-3 (`prep`) are one large product plus reductions and stay plain
PyTorch, as the JAX package leaves them to XLA.  Step 4 is the sequential
part, the custom op `deepinpainting::scan_stream`: on a CUDA tensor the
hand-written kernel in ops/attention_cuda.py, on a CPU tensor
`scan_stream_reference` below.  attention_impl='torch' runs the plain
version on every device, in the primal as the op
`deepinpainting::scan_stream_plain`.

Inference needs nothing more: the scan's `out` is the result.  Under
differentiation the forward also materialises the attention matrix

  5. kbar[q, :] = a_q*row_prev + b_q*onehot(ind_q) on masked q (the row
     carry advances), onehot(ind_q) on unmasked q (the custom op
     `deepinpainting::kbar_build`: the second hand-written kernel on a CUDA
     tensor, `kbar_build_reference` on a CPU one), from the (a, b) the scan
     emitted;
  6. decodes out = kbar @ P (a batched matrix product, left to the library
     as the JAX package leaves it to XLA; it equals the scan's `out` up to
     rounding);

and the backward is the reference's: grad_feat = g + triple_weight * K^T g
with K = trunc(kbar) (the reference stores the float rows into an integer
tensor, so fractional weights mostly vanish) or K = kbar when
truncate_backward is off.  `ref` and `flag` get no gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import attention_cuda

_NORM_EPS = 1e-8

# The namespace of the port's custom ops: torch.ops.deepinpainting.*
OP_NAMESPACE = "deepinpainting"

# Config.attention_impl values -> the scan used on the card.  'pallas' and
# 'lax' are the JAX package's names for the same two choices.
_IMPLS = {"cuda": "cuda", "pallas": "cuda", "torch": "torch", "lax": "torch"}


def check_impl(impl: Optional[str]) -> str:
    """Normalise an attention_impl value to 'cuda' or 'torch'."""
    if impl is None:
        return "cuda"
    if impl not in _IMPLS:
        raise ValueError(f"attention_impl {impl!r} not recognized "
                         f"(one of {sorted(_IMPLS)})")
    return _IMPLS[impl]


def apply_known_replacement(ind: torch.Tensor, flag: torch.Tensor,
                            known_replacement: bool) -> torch.Tensor:
    """known_replacement=True is the reference quirk: unmasked positions
    also take their best-matching patch.  False is the corrected
    identity-on-known mode: ind[q] := q where flag[q] <= 0.5."""
    if known_replacement:
        return ind
    iota = torch.arange(ind.shape[-1], device=ind.device, dtype=ind.dtype)
    return torch.where(flag > 0.5, ind, iota.expand_as(ind))


def prep(feat: torch.Tensor, ref: torch.Tensor, flag: torch.Tensor,
         known_replacement: bool = True):
    """Pre-stage on [B, N, C] patch rows.  feat/ref: [B, N, C]; flag [B, N].
    Returns (P, Pn, ind [B,N] int64, vmax [B,N], known [B,N,C]), all f32."""
    P = feat.to(torch.float32)
    R = ref.to(torch.float32)
    norm = torch.linalg.vector_norm(P, dim=2, keepdim=True)
    Pn = P * (1.0 / (norm + _NORM_EPS))
    scores = torch.bmm(Pn, R.transpose(1, 2))          # [B, patch, pos]
    ind = torch.argmax(scores, dim=1)                  # first max on ties
    vmax = torch.amax(scores, dim=1)
    ind = apply_known_replacement(ind, flag, known_replacement)
    known = torch.gather(P, 1, ind[:, :, None].expand(-1, -1, P.shape[2]))
    return P, Pn, ind, vmax, known


def scan_stream_reference(flag: torch.Tensor, vmax: torch.Tensor,
                          pn: torch.Tensor, known: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch coherence recurrence, the scan kernel's plain version.

    flag/vmax: [B, N] f32; pn/known: [B, N, C] f32.  A Python loop over N,
    vectorised over B.  Returns (out [B,N,C], a [B,N], b [B,N]).

    The dot product <pn_q, out_prev> accumulates in f64 and rounds once to
    f32, as the kernel's does, so that the two agree bit for bit: the
    recurrence amplifies any rounding difference (see csrc/scan_stream.cu).
    Everything else is f32.
    """
    bsz, n, c = pn.shape
    out = torch.empty_like(known)
    a_all = torch.empty_like(vmax)
    b_all = torch.empty_like(vmax)
    carry = torch.zeros((bsz, c), dtype=pn.dtype, device=pn.device)
    seen = torch.zeros((bsz,), dtype=torch.bool, device=pn.device)
    zero = torch.zeros((), dtype=pn.dtype, device=pn.device)
    one = torch.ones((), dtype=pn.dtype, device=pn.device)
    for q in range(n):
        masked = flag[:, q] > 0
        first = masked & ~seen
        known_q = known[:, q]
        at = (pn[:, q].double() * carry.double()).sum(dim=1).float()
        denom = at + vmax[:, q]
        a = torch.where(first, zero, at / denom)
        b = torch.where(first, one, vmax[:, q] / denom)
        out_m = a[:, None] * carry + b[:, None] * known_q
        out[:, q] = torch.where(masked[:, None], out_m, known_q)
        a_all[:, q] = torch.where(masked, a, one)
        b_all[:, q] = torch.where(masked, b, zero)
        carry = torch.where(masked[:, None], out_m, carry)
        seen = seen | masked
    return out, a_all, b_all


@torch.library.custom_op(f"{OP_NAMESPACE}::scan_stream", mutates_args=(),
                         device_types="cpu")
def scan_stream(flag: torch.Tensor, vmax: torch.Tensor, pn: torch.Tensor,
                known: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence as the custom op `deepinpainting::scan_stream`,
    dispatched by the tensors' device: the CUDA kernel for CUDA tensors
    (which launches or raises), the plain version for CPU ones; any other
    device has no implementation.  Returns (out [B,N,C], a [B,N], b
    [B,N]), new tensors."""
    return scan_stream_reference(flag, vmax, pn, known)


scan_stream.register_kernel("cuda")(attention_cuda.scan_stream_cuda)


@scan_stream.register_fake
def _scan_stream_fake(flag, vmax, pn, known):
    return (torch.empty_like(known), torch.empty_like(vmax),
            torch.empty_like(vmax))


@torch.library.custom_op(f"{OP_NAMESPACE}::scan_stream_plain",
                         mutates_args=())
def scan_stream_plain(flag: torch.Tensor, vmax: torch.Tensor,
                      pn: torch.Tensor, known: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain recurrence as the custom op
    `deepinpainting::scan_stream_plain`, on every device:
    `scan_stream_reference`, which attention_impl='torch' runs.  An op of
    its own so that a traced graph (engine/export_model.py) holds it as
    one node, where tracing the reference would unroll its loop over N.
    Returns (out [B,N,C], a [B,N], b [B,N]), new tensors."""
    return scan_stream_reference(flag, vmax, pn, known)


scan_stream_plain.register_fake(_scan_stream_fake)


def kbar_build_reference(flag: torch.Tensor, ind: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch attention-matrix recurrence, the kbar kernel's plain
    version.

    flag/a/b: [B, N] f32; ind: [B, N] integer.  A Python loop over the N
    rows, vectorised over B and the N columns.  Returns kbar [B, N, N] f32.

    The step is three separately rounded f32 operations (two products, one
    sum), never a fused multiply-add, and the kernel does the same: with no
    reduction anywhere the two agree bit for bit, which `trunc` in the
    faithful backward needs (see csrc/kbar_build.cu).
    """
    bsz, n = flag.shape
    kbar = torch.empty((bsz, n, n), dtype=torch.float32, device=flag.device)
    cols = torch.arange(n, device=flag.device)
    row = torch.zeros((bsz, n), dtype=torch.float32, device=flag.device)
    for q in range(n):
        onehot = (cols == ind[:, q, None]).to(torch.float32)
        row = a[:, q, None] * row + b[:, q, None] * onehot
        kbar[:, q] = torch.where(flag[:, q, None] > 0, row, onehot)
    return kbar


@torch.library.custom_op(f"{OP_NAMESPACE}::kbar_build", mutates_args=(),
                         device_types="cpu")
def kbar_build(flag: torch.Tensor, ind: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The attention matrix as the custom op `deepinpainting::kbar_build`,
    dispatched by the tensors' device like `scan_stream`.  ind is int32 or
    int64.  Returns kbar [B,N,N] f32, a new tensor."""
    return kbar_build_reference(flag, ind, a, b)


kbar_build.register_kernel("cuda")(attention_cuda.kbar_build_cuda)


@kbar_build.register_fake
def _kbar_build_fake(flag, ind, a, b):
    bsz, n = flag.shape
    return flag.new_empty((bsz, n, n), dtype=torch.float32)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """NCHW [B, C, H, W] -> patch rows [B, N, C] (a view)."""
    return t.flatten(2).transpose(1, 2)


def attention_core_batched(feat: torch.Tensor, ref: torch.Tensor,
                           flag: torch.Tensor, *,
                           known_replacement: bool = True,
                           impl: Optional[str] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-path forward (counterpart of the JAX package's
    attention_core_pallas_batched).  feat/ref: NCHW [B, C, H, W]; flag
    [B, H*W].  Returns (out NCHW in feat's dtype, kbar [B, N, N] f32).

    prep -> scan for (a, b) -> kbar -> out = kbar @ P.  impl as in
    ipsr_attention_batched: 'cuda' takes both recurrences by the tensors'
    device, 'torch' forces both plain versions.
    """
    bsz, c, h, w = feat.shape
    flag = flag.to(torch.float32).contiguous()
    P, Pn, ind, vmax, known = prep(_rows(feat), _rows(ref), flag,
                                   known_replacement)
    kernels = check_impl(impl) == "cuda"
    scan = scan_stream if kernels else scan_stream_reference
    build = kbar_build if kernels else kbar_build_reference
    _, a, b = scan(flag, vmax.contiguous(), Pn.contiguous(),
                   known.contiguous())
    kbar = build(flag, ind.contiguous(), a, b)
    out = torch.bmm(kbar, P)                            # [B, pos, C]
    return out.transpose(1, 2).reshape(bsz, c, h, w).to(feat.dtype), kbar


class _IpsrAttention(torch.autograd.Function):
    """The training forward with the reference's backward (counterpart of
    the JAX package's custom_vjp rules _batched_pallas_fwd / _bwd)."""

    @staticmethod
    def forward(ctx, feat, ref, flag, triple_weight, truncate_backward,
                known_replacement, impl):
        out, kbar = attention_core_batched(
            feat, ref, flag, known_replacement=known_replacement, impl=impl)
        ctx.save_for_backward(torch.trunc(kbar) if truncate_backward
                              else kbar)
        ctx.triple_weight = triple_weight
        return out

    @staticmethod
    def backward(ctx, g):
        K, = ctx.saved_tensors                          # [B, pos q, patch p]
        # grad at patch p: g[p] + tw * sum_q K[q, p] * g[q]; on NCHW that is
        # [B, C, q] @ K[B, q, p], so no transpose is materialised.
        extra = torch.bmm(g.flatten(2).to(torch.float32), K)
        grad = g + ctx.triple_weight * extra.reshape(g.shape).to(g.dtype)
        return grad, None, None, None, None, None, None


def ipsr_attention_batched(feat: torch.Tensor, ref: torch.Tensor,
                           flag: torch.Tensor, *,
                           triple_weight: float = 1.0,
                           truncate_backward: bool = True,
                           known_replacement: bool = True,
                           impl: Optional[str] = None) -> torch.Tensor:
    """Batched IPSR attention.  feat/ref: NCHW [B, C, H, W]; flag
    [B, H*W] (1 = masked).  Returns NCHW [B, C, H, W] in feat's dtype.

    impl 'cuda' (default, also 'pallas') runs the recurrences on the
    tensors' device through `scan_stream` and `kbar_build`; 'torch' (also
    'lax') forces the plain versions, which lets the two be compared on the
    card.

    Where no gradient is wanted (grad mode off, or `feat` does not require
    one) this is the kbar-free primal: the scan's `out` is the result and
    no [N, N] matrix is built.  Otherwise the forward is
    `attention_core_batched` and the backward g + triple_weight * K^T g,
    K = trunc(kbar) if truncate_backward else kbar.
    """
    if torch.is_grad_enabled() and feat.requires_grad:
        return _IpsrAttention.apply(feat, ref, flag, triple_weight,
                                    truncate_backward, known_replacement,
                                    impl)
    bsz, c, h, w = feat.shape
    flag = flag.to(torch.float32)
    _, Pn, _, vmax, known = prep(_rows(feat), _rows(ref), flag,
                                 known_replacement)
    scan = (scan_stream if check_impl(impl) == "cuda"
            else scan_stream_plain)
    out, _, _ = scan(flag.contiguous(), vmax.contiguous(), Pn.contiguous(),
                     known.contiguous())
    return out.transpose(1, 2).reshape(bsz, c, h, w).to(feat.dtype)
