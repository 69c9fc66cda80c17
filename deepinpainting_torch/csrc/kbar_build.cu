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
// What bounds it on an H100.  Bytes: B*N*N*4 written plus B*N*16 (int32
// ind) or B*N*20 (int64) read, 4.2 MB a sample at N=1024 (about 1.3 us at
// 3.35 TB/s, 10 us at B=8).  Operations are 3 flops an element, far below
// that.  What stands between the kernel and that bound is the chain: a
// row depends on the row before it, and a walk over all N rows by one
// warp a column tile costs N dependent steps whatever B is.
//
// Design.  Only a masked row changes the running value: on an unmasked row
// (a, b) = (1, 0) gives row = 1*row + 0*onehot, and what is stored there is
// the one-hot row, which depends on nothing.  So, in one launch:
//   * chain blocks (the first B * ceil(N/COLS)) each take COLS neighbouring
//     columns of one sample.  The block compacts (q, ind_q, a_q, b_q) of the
//     masked rows, in order, into shared memory (ballot and popcount over
//     `flag`, TILE rows at a time so that any N fits).  A thread owns four
//     neighbouring columns, keeps their running values in registers and
//     walks the m masked rows: one 16-byte shared-memory read (the same
//     word for every thread, a broadcast), four independent multiply-add
//     chains, one float4 store a row, 512 contiguous bytes a warp.
//   * fill blocks (`fill_blocks` a sample) write the unmasked rows: zeros
//     with a 1 at ind_q, a warp a row with float4 stores.  They share
//     nothing with the chain blocks and run beside them.
// Every masked row goes through the step in every column, also the columns
// no index selects: 0*a is NaN where a is infinite, and the plain version
// carries that NaN.  The Pallas kernel carries `ind` as f32 inside a packed
// [K,N,4] block, a Mosaic layout workaround; here `ind` is read in the
// integer type the caller has, and a value outside [0, N) matches no
// column.
//
// Rounding.  Each element is one chain of a*row + b*onehot with no
// reduction, so the kernel and the plain version
// (ops/attention.py::kbar_build_reference) agree bit for bit, provided the
// step is not contracted into an FMA: __fmul_rn/__fadd_rn keep the two
// products and the sum as three rounded f32 operations, as the plain
// version's separate tensor operations are.  That matters because the
// faithful backward truncates kbar toward zero: an entry that is 1.0 here
// and 0.99999994 there would become 1 against 0.  Skipping the unmasked
// rows is exact but for the sign of a zero: 1*(-0) + 0*x is +0, so the
// plain version turns a running -0 into +0 on an unmasked row and this
// kernel does not.  A -0 needs a and b both negative on a zero running
// value, which the scan never emits (a + b = 1); the two zeros compare
// equal, truncate alike, and add alike in the backward's product.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WARPS = 2;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 4 * THREADS;   // columns a chain block: four a thread
constexpr int TILE = 2048;          // rows compacted at once (32 KB)

struct __align__(16) Step {   // one masked row
  int q;
  int ind;
  float a;
  float b;
};

// ind as an int column, -1 (no column) for a value outside [0, n)
template <typename IndexT>
__device__ __forceinline__ int column_of(IndexT v, int n) {
  return (v >= 0 && v < static_cast<IndexT>(n)) ? static_cast<int>(v) : -1;
}

// The four columns c0..c0+3 of one row.  `vec`: N is a multiple of 4, so
// every row is 16-byte aligned and c0 < n means all four are inside.
__device__ __forceinline__ void store4(float* row, int c0, int n, bool vec,
                                       float4 v) {
  if (vec) {
    *reinterpret_cast<float4*>(row + c0) = v;
  } else {
    if (c0 < n) row[c0] = v.x;
    if (c0 + 1 < n) row[c0 + 1] = v.y;
    if (c0 + 2 < n) row[c0 + 2] = v.z;
    if (c0 + 3 < n) row[c0 + 3] = v.w;
  }
}

__device__ __forceinline__ float4 onehot4(int ind, int c0) {
  return make_float4(ind == c0 ? 1.f : 0.f, ind == c0 + 1 ? 1.f : 0.f,
                     ind == c0 + 2 ? 1.f : 0.f, ind == c0 + 3 ? 1.f : 0.f);
}

template <typename IndexT>
__global__ void __launch_bounds__(THREADS)
kbar_build_kernel(const float* __restrict__ flag, const IndexT* __restrict__ ind,
                  const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ kbar, int n, int col_blocks,
                  int chain_blocks, int fill_blocks) {
  __shared__ Step s_step[TILE];   // masked rows of the tile, in order
  __shared__ int s_cnt[WARPS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool vec = (n & 3) == 0;
  const bool chain = blockIdx.x < static_cast<unsigned>(chain_blocks);
  const size_t s = chain ? blockIdx.x / col_blocks
                         : (blockIdx.x - chain_blocks) / fill_blocks;
  const float* fl = flag + s * n;
  const IndexT* in = ind + s * n;
  float* out = kbar + s * n * n;

  if (!chain) {
    // ---- the unmasked rows q = first, first+stride, ...: a warp a row
    const int j = (blockIdx.x - chain_blocks) % fill_blocks;
    const int stride = fill_blocks * WARPS;
    for (int q = j * WARPS + warp; q < n; q += stride) {
      if (fl[q] > 0.f) continue;
      const int iv = column_of(in[q], n);
      float* row = out + static_cast<size_t>(q) * n;
      for (int c0 = 4 * lane; c0 < n; c0 += 128)
        store4(row, c0, n, vec, onehot4(iv, c0));
    }
    return;
  }

  const float* aa = a + s * n;
  const float* bb = b + s * n;
  const int c0 = (blockIdx.x % col_blocks) * COLS + 4 * tid;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t0 = 0; t0 < n; t0 += TILE) {
    // ---- compact the tile's masked rows: warp w takes rows [lo, lo+seg)
    const int rows = min(TILE, n - t0);
    const int seg = ((rows + WARPS - 1) / WARPS + 31) & ~31;
    const int lo = warp * seg;
    int cnt = 0;
    for (int r0 = lo; r0 < min(rows, lo + seg); r0 += 32) {
      const int r = r0 + lane;
      const bool f = r < rows && fl[t0 + r] > 0.f;
      cnt += __popc(__ballot_sync(0xffffffffu, f));
    }
    if (lane == 0) s_cnt[warp] = cnt;
    __syncthreads();   // counts written; the previous tile's list is done
    int pos = 0, m = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) pos += s_cnt[w];
      m += s_cnt[w];
    }
    for (int r0 = lo; r0 < min(rows, lo + seg); r0 += 32) {
      const int r = r0 + lane;
      const bool f = r < rows && fl[t0 + r] > 0.f;
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) {
        Step st;
        st.q = t0 + r;
        st.ind = column_of(in[t0 + r], n);
        st.a = aa[t0 + r];
        st.b = bb[t0 + r];
        s_step[pos + __popc(bal & ((1u << lane) - 1u))] = st;
      }
      pos += __popc(bal);
    }
    __syncthreads();   // the list is ready

    // ---- the chain over the tile's masked rows
    if (c0 < n) {
#pragma unroll 4
      for (int i = 0; i < m; ++i) {
        const Step st = s_step[i];
        const float4 hot = onehot4(st.ind, c0);
        run.x = __fadd_rn(__fmul_rn(st.a, run.x), __fmul_rn(st.b, hot.x));
        run.y = __fadd_rn(__fmul_rn(st.a, run.y), __fmul_rn(st.b, hot.y));
        run.z = __fadd_rn(__fmul_rn(st.a, run.z), __fmul_rn(st.b, hot.z));
        run.w = __fadd_rn(__fmul_rn(st.a, run.w), __fmul_rn(st.b, hot.w));
        store4(out + static_cast<size_t>(st.q) * n, c0, n, vec, run);
      }
    }
  }
}

template <typename IndexT>
int launch(const float* flag, const void* ind, const float* a, const float* b,
           float* kbar, int bsz, int n, int fill_blocks, cudaStream_t stream) {
  const int col_blocks = (n + COLS - 1) / COLS;
  const long long blocks =
      static_cast<long long>(bsz) * (col_blocks + fill_blocks);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kbar_build_kernel<IndexT><<<static_cast<unsigned>(blocks), THREADS, 0,
                              stream>>>(
      flag, static_cast<const IndexT*>(ind), a, b, kbar, n, col_blocks,
      bsz * col_blocks, fill_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), does not synchronise,
// allocates nothing.  `ind_bytes` is 4 (int32) or 8 (int64); all arrays
// contiguous.  Returns the first CUDA error, cudaGetLastError() after the
// launch included.
extern "C" int kbar_build_f32(const float* flag, const void* ind, int ind_bytes,
                              const float* a, const float* b, float* kbar,
                              int bsz, int n, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bsz <= 0 || bsz > 65535 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // Fill blocks a sample: about eight blocks (sixteen warps) an SM over the
  // whole launch, and no more than there are pairs of rows.
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fill_blocks = std::max(
      1, std::min(std::min(256, (n + WARPS - 1) / WARPS),
                  (8 * sms + bsz - 1) / bsz));
  if (ind_bytes == 4)
    return launch<int32_t>(flag, ind, a, b, kbar, bsz, n, fill_blocks, stream);
  if (ind_bytes == 8)
    return launch<int64_t>(flag, ind, a, b, kbar, bsz, n, fill_blocks, stream);
  return cudaErrorInvalidValue;
}
