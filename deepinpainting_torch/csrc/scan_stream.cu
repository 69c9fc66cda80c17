// IPSR coherence scan for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel
//   deepinpainting_tpu/ops/attention_pallas.py::_scan_stream_kernel
// (launched by _scan_stream).  Same function:
//   (flag [B,N], vmax [B,N], pn [B,N,C], known [B,N,C]) -> (out [B,N,C], a [B,N], b [B,N])
// For each sample, sequentially over q = 0..N-1, with carry out_prev = 0:
//   at = <pn_q, out_prev>, a = at/(at+vmax_q), b = vmax_q/(at+vmax_q)
//   first masked q:  (a, b) = (0, 1)
//   masked q:        out_q = a*out_prev + b*known_q, the carry advances
//   unmasked q:      out_q = known_q, (a, b) = (1, 0), the carry holds
//
// Design.  The TPU kernel walks N as a sequential grid axis with the carry
// in VMEM scratch; here the walk over N is a loop inside one block, and the
// batch is the only parallel axis: one warp per sample.  Each lane keeps
// its carry channels in registers as CH = ceil(C/128) float4s (lane l owns
// the float4s l, l+32, ... of the C/4 in a row; lanes past the row's end
// hold zeros), so each row is read and written with coalesced 16-byte
// accesses.  The dot product is a butterfly __shfl_xor_sync
// reduction, after which every lane holds the same sum (addition is
// commutative, so both partners of each exchange round identically) and
// computes (a, b) itself.  The next row's inputs do not depend on the
// carry, so they are loaded one step ahead into registers.
//
// Rounding.  The recurrence amplifies a rounding difference ~1.3x a masked
// step, and near-cancelling denominators (at + vmax ~ 0) amplify it far
// more, so an f32 dot product summed in another order than the plain
// version's drifts visibly within a few steps.  The dot product therefore
// accumulates in f64 (the f32 products are exact there) and rounds once to
// f32, as the plain version (ops/attention.py) does: both then get the
// same f32 `at` unless the exact sum lies within ~1e-16 relative of an f32
// rounding boundary.  The blend uses __fmul_rn/__fadd_rn so it is not
// contracted into an FMA and rounds like the plain version's separate
// multiplies and add; the divisions are IEEE (the build does not use
// --use_fast_math).  The Pallas kernel sums the dot product in f32, an
// ulp-level difference from both.
//
// What bounds it on an H100.  Bytes: each row moves pn_q and known_q in and
// out_q out, 12*C bytes plus 16 bytes of scalars, so 6.3 MB a sample at
// N=1024, C=512 (about 1.9 us at 3.35 TB/s; about 15 us at B=8).
// Operations are negligible (~5*C flops a masked row, the dot product's
// half of them in f64).  But the N steps of
// a sample form one dependent chain, each step a C-wide reduction plus two
// divisions, and a sample runs on one warp: the chain's latency, not the
// bytes, is expected to set the time.  Prefetching deeper with cp.async
// and skipping the dot product on unmasked rows are the next steps.

#include <cuda_runtime.h>

namespace {

template <int CH>
__global__ void __launch_bounds__(32)
scan_stream_kernel(const float* __restrict__ pn, const float* __restrict__ known,
                   const float* __restrict__ flag, const float* __restrict__ vmax,
                   float* __restrict__ out, float* __restrict__ a_out,
                   float* __restrict__ b_out, int n, int row4) {
  // row4 = C/4 float4s per row, 32*(CH-1) < row4 <= 32*CH
  const int lane = threadIdx.x;
  bool own[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) own[j] = j * 32 + lane < row4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t s = blockIdx.x;
  const float4* pn4 = reinterpret_cast<const float4*>(pn) + s * n * row4;
  const float4* kn4 = reinterpret_cast<const float4*>(known) + s * n * row4;
  float4* out4 = reinterpret_cast<float4*>(out) + s * n * row4;
  const float* fl = flag + s * n;
  const float* vm = vmax + s * n;
  float* ao = a_out + s * n;
  float* bo = b_out + s * n;

  float4 carry[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) carry[j] = zero4;
  bool seen = false;

  float4 p_nx[CH], k_nx[CH];
  float f_nx = 0.f, v_nx = 0.f;
  if (n > 0) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      p_nx[j] = own[j] ? pn4[j * 32 + lane] : zero4;
      k_nx[j] = own[j] ? kn4[j * 32 + lane] : zero4;
    }
    f_nx = fl[0];
    v_nx = vm[0];
  }

#pragma unroll 1
  for (int q = 0; q < n; ++q) {
    float4 p[CH], k[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      p[j] = p_nx[j];
      k[j] = k_nx[j];
    }
    const float f = f_nx, v = v_nx;
    if (q + 1 < n) {
      const size_t row = static_cast<size_t>(q + 1) * row4;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        p_nx[j] = own[j] ? pn4[row + j * 32 + lane] : zero4;
        k_nx[j] = own[j] ? kn4[row + j * 32 + lane] : zero4;
      }
      f_nx = fl[q + 1];
      v_nx = vm[q + 1];
    }

    // <pn_q, out_prev> in f64, rounded once to f32 (see the note above)
    double dot = 0.0;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      dot = fma(double(p[j].x), double(carry[j].x), dot);
      dot = fma(double(p[j].y), double(carry[j].y), dot);
      dot = fma(double(p[j].z), double(carry[j].z), dot);
      dot = fma(double(p[j].w), double(carry[j].w), dot);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float at = __double2float_rn(dot);

    const bool masked = f > 0.f;
    const bool first = masked && !seen;
    const float denom = at + v;
    const float a = first ? 0.f : at / denom;
    const float b = first ? 1.f : v / denom;

    float4* orow = out4 + static_cast<size_t>(q) * row4;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float4 o = k[j];
      if (masked) {
        o.x = __fadd_rn(__fmul_rn(a, carry[j].x), __fmul_rn(b, k[j].x));
        o.y = __fadd_rn(__fmul_rn(a, carry[j].y), __fmul_rn(b, k[j].y));
        o.z = __fadd_rn(__fmul_rn(a, carry[j].z), __fmul_rn(b, k[j].z));
        o.w = __fadd_rn(__fmul_rn(a, carry[j].w), __fmul_rn(b, k[j].w));
        carry[j] = o;
      }
      if (own[j]) orow[j * 32 + lane] = o;
    }
    if (lane == 0) {
      ao[q] = masked ? a : 1.f;
      bo[q] = masked ? b : 0.f;
    }
    seen = seen || masked;
  }
}

template <int CH>
void launch(const float* pn, const float* known, const float* flag,
            const float* vmax, float* out, float* a, float* b, int bsz, int n,
            int c, cudaStream_t stream) {
  scan_stream_kernel<CH><<<bsz, 32, 0, stream>>>(pn, known, flag, vmax, out,
                                                  a, b, n, c / 4);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), does not synchronise,
// allocates nothing.  C must be a multiple of 4 and at most 1024; all
// pointers 16-byte aligned and contiguous.  Returns cudaGetLastError().
extern "C" int scan_stream_f32(const float* pn, const float* known,
                               const float* flag, const float* vmax,
                               float* out, float* a, float* b, int bsz, int n,
                               int c, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bsz <= 0 || n < 0 || c <= 0 || c % 4 != 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch ((c + 127) / 128) {
    case 1: launch<1>(pn, known, flag, vmax, out, a, b, bsz, n, c, stream); break;
    case 2: launch<2>(pn, known, flag, vmax, out, a, b, bsz, n, c, stream); break;
    case 3: launch<3>(pn, known, flag, vmax, out, a, b, bsz, n, c, stream); break;
    case 4: launch<4>(pn, known, flag, vmax, out, a, b, bsz, n, c, stream); break;
    case 5: launch<5>(pn, known, flag, vmax, out, a, b, bsz, n, c, stream); break;
    case 6: launch<6>(pn, known, flag, vmax, out, a, b, bsz, n, c, stream); break;
    case 7: launch<7>(pn, known, flag, vmax, out, a, b, bsz, n, c, stream); break;
    case 8: launch<8>(pn, known, flag, vmax, out, a, b, bsz, n, c, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
