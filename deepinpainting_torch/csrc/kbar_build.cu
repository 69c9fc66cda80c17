// IPSR attention matrix (kbar) for Hopper (sm_90a), f32.  Training only.
//
// Replaces the Pallas TPU kernel
//   deepinpainting_tpu/ops/attention_pallas.py::_kbar_kernel
// (launched by _kbar_build).  Same function:
//   (flag [B,N] f32, ind [B,N] int32|int64, a [B,N] f32, b [B,N] f32) -> kbar [B,N,N] f32
// For each sample, sequentially over the rows q = 0..N-1, with row_prev = 0:
//   row_q = a_q*row_prev + b_q*onehot(ind_q)      (every q; (a,b) = (1,0) on
//                                                  unmasked q keeps row_prev)
//   kbar[q, :] = flag_q > 0 ? row_q : onehot(ind_q)
// (a, b) are the blend coefficients the scan kernel (scan_stream.cu) emits.
//
// Design.  The recurrence is linear and independent per column, so one
// thread owns one (sample, column) pair, keeps that column's running value
// in a register and walks the N rows in a loop inside the kernel; the grid
// covers columns x samples and nothing is carried between blocks.  In each
// step a warp stores 32 neighbouring columns of one kbar row, 128
// contiguous bytes.  The four per-row scalars are the same for every
// column: the block stages them through shared memory TILE rows at a time
// (each thread loads a few rows' scalars, coalesced), and every thread then
// reads the same shared word, a broadcast.  The Pallas kernel carries `ind`
// as f32 inside a packed [K,N,4] block, a Mosaic layout workaround; here
// `ind` is read in the integer type the caller has (int32 or int64).
//
// Rounding.  Each element is one chain of a*row + b*onehot with no
// reduction, so the kernel and the plain version
// (ops/attention.py::kbar_build_reference) agree bit for bit, provided the
// step is not contracted into an FMA: __fmul_rn/__fadd_rn keep the two
// products and the sum as three rounded f32 operations, as the plain
// version's separate tensor operations are.  That matters because the
// faithful backward truncates kbar toward zero: an entry that is 1.0 here
// and 0.99999994 there would become 1 against 0.
//
// What bounds it on an H100.  Bytes: B*N*N*4 written plus B*N*16 (int32
// ind) or B*N*20 (int64) read, 4.2 MB a sample at N=1024 (about 1.3 us at
// 3.35 TB/s, 10 us at B=8).  Operations are 3 flops an element, far below
// that.  Blocks of 64 columns give 128 blocks at B=8, N=1024, about one
// an SM.  Measured on an H100 (chip_smoke.py), the kernel takes about as
// long at B=1 as at B=8, several times the byte bound: each warp's N
// dependent steps (shared-memory reads, the multiply-add chain, one store)
// set the time at this size, not the bytes.  Several rows in flight per
// thread, or narrower column tiles, are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 64;    // columns (threads) a block
constexpr int TILE = 256;   // rows whose scalars are staged at once

template <typename IndexT>
__global__ void __launch_bounds__(COLS)
kbar_build_kernel(const float* __restrict__ flag, const IndexT* __restrict__ ind,
                  const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ kbar, int n) {
  __shared__ float s_flag[TILE];
  __shared__ int s_ind[TILE];
  __shared__ float s_a[TILE];
  __shared__ float s_b[TILE];

  const size_t s = blockIdx.y;
  const int col = blockIdx.x * COLS + threadIdx.x;
  const bool own = col < n;
  const float* fl = flag + s * n;
  const IndexT* in = ind + s * n;
  const float* aa = a + s * n;
  const float* bb = b + s * n;
  float* out = kbar + s * n * n + col;

  float row = 0.f;
  for (int q0 = 0; q0 < n; q0 += TILE) {
    const int rows = min(TILE, n - q0);
    __syncthreads();   // the previous tile has been read by every thread
    for (int i = threadIdx.x; i < rows; i += COLS) {
      s_flag[i] = fl[q0 + i];
      s_ind[i] = static_cast<int>(in[q0 + i]);   // 0 <= ind < n <= INT_MAX
      s_a[i] = aa[q0 + i];
      s_b[i] = bb[q0 + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const float onehot = (s_ind[i] == col) ? 1.f : 0.f;
      row = __fadd_rn(__fmul_rn(s_a[i], row), __fmul_rn(s_b[i], onehot));
      if (own)
        out[static_cast<size_t>(q0 + i) * n] = (s_flag[i] > 0.f) ? row : onehot;
    }
  }
}

template <typename IndexT>
int launch(const float* flag, const void* ind, const float* a, const float* b,
           float* kbar, int bsz, int n, cudaStream_t stream) {
  const dim3 grid((n + COLS - 1) / COLS, bsz);
  kbar_build_kernel<IndexT><<<grid, COLS, 0, stream>>>(
      flag, static_cast<const IndexT*>(ind), a, b, kbar, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), does not synchronise,
// allocates nothing.  `ind_bytes` is 4 (int32) or 8 (int64); all arrays
// contiguous.  bsz <= 65535 (it is the grid's y extent).  Returns
// cudaGetLastError().
extern "C" int kbar_build_f32(const float* flag, const void* ind, int ind_bytes,
                              const float* a, const float* b, float* kbar,
                              int bsz, int n, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bsz <= 0 || bsz > 65535 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (ind_bytes == 4)
    return launch<int32_t>(flag, ind, a, b, kbar, bsz, n, stream);
  if (ind_bytes == 8)
    return launch<int64_t>(flag, ind, a, b, kbar, bsz, n, stream);
  return cudaErrorInvalidValue;
}
