"""IPSR coherent-semantic shift attention, inference primal
(counterpart of deepinpainting_tpu/ops/attention.py and the pre-stage of
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
part: on a CUDA tensor it is the hand-written kernel in
ops/attention_cuda.py, on a CPU tensor `scan_stream_reference` below.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import attention_cuda

_NORM_EPS = 1e-8

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


def scan_stream(flag: torch.Tensor, vmax: torch.Tensor, pn: torch.Tensor,
                known: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence on the tensors' device: the CUDA kernel for CUDA
    tensors (which launches or raises), the plain version for CPU ones."""
    if pn.is_cuda:
        return attention_cuda.scan_stream_cuda(flag, vmax, pn, known)
    return scan_stream_reference(flag, vmax, pn, known)


def ipsr_attention_batched(feat: torch.Tensor, ref: torch.Tensor,
                           flag: torch.Tensor, *,
                           known_replacement: bool = True,
                           impl: Optional[str] = None) -> torch.Tensor:
    """Batched inference primal.  feat/ref: NCHW [B, C, H, W]; flag
    [B, H*W] (1 = masked).  Returns NCHW [B, C, H, W] in feat's dtype.

    impl 'cuda' (default, also 'pallas') runs the recurrence on the
    tensors' device through `scan_stream`; 'torch' (also 'lax') forces the
    plain version, which lets the two be compared on the card.
    """
    bsz, c, h, w = feat.shape
    rows = lambda t: t.flatten(2).transpose(1, 2)       # [B, N, C]
    flag = flag.to(torch.float32)
    _, Pn, _, vmax, known = prep(rows(feat), rows(ref), flag,
                                 known_replacement)
    scan = (scan_stream if check_impl(impl) == "cuda"
            else scan_stream_reference)
    out, _, _ = scan(flag.contiguous(), vmax.contiguous(), Pn.contiguous(),
                     known.contiguous())
    return out.transpose(1, 2).reshape(bsz, c, h, w).to(feat.dtype)
