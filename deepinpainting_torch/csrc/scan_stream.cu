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
// What bounds it on an H100.  Bytes: every row moves known_q in and out_q
// out, a masked row pn_q too: 6.3 MB a sample at N=1024, C=512, about 2 us
// at 3.35 TB/s.  Operations are negligible (~5*C flops a masked row).  The
// time is neither: the masked rows of a sample form one dependent chain,
// each step a C-wide reduction, two divisions and a blend that the next
// step's reduction needs.  So the design makes the chain as short as the
// mathematics allows and a step as short as the card allows, and takes
// everything else off the chain.
//
// Design.  One launch, two kinds of block.
//   * Blocks 0..B-1, one a sample, run the chain, over the masked rows
//     only: an unmasked row leaves the carry alone, so it is no step.
//     The block first compacts the indices of its masked rows, in raster
//     order, with their vmax, into shared memory (ballot and popcount over
//     `flag`, TILE rows at a time so that any N fits).  Then four consumer
//     warps walk that list.  A thread owns one float4 of the row (two for
//     C > 512), keeps its part of the carry in registers, and computes its
//     part of <pn_q, carry>; a shuffle tree sums a warp, the four warps'
//     sums meet in shared memory behind one named barrier, and every
//     thread adds them in the same order, so all hold the same `at` and
//     compute (a, b) themselves.  The masked output row goes from the
//     registers to device memory with float4 stores.
//   * A fifth warp is the producer: one thread keeps the next masked
//     rows' pn and known in flight into a ring in shared memory (STAGES
//     stages of 16 KB, four rows each at C <= 512) with 1-D bulk copies
//     (cp.async.bulk, one a row, gathered by the compacted index), each
//     stage completing on an mbarrier; the consumers wait on a stage's
//     barrier once, read each row into registers one step ahead of its
//     use, and release the stage through a second barrier.  A step
//     therefore never waits for device memory, and its shared-memory read
//     is off the chain.
//   * Blocks B.., `copy_blocks` a sample, copy the unmasked rows: out_q =
//     known_q, (a, b) = (1, 0), a warp a row with 16-byte accesses.  They
//     write rows the chain never touches, so the two kinds of block share
//     nothing and the copy overlaps the chain.
//
// Rounding.  The recurrence amplifies a rounding difference ~1.3x a masked
// step, and near-cancelling denominators (at + vmax ~ 0) amplify it far
// more, so an f32 dot product summed in another order than the plain
// version's drifts visibly within a few steps.  The dot product therefore
// accumulates in f64 (the f32 products are exact there) and rounds once to
// f32, as the plain version (ops/attention.py) does: both then get the
// same f32 `at` unless the exact sum lies within ~1e-16 relative of an f32
// rounding boundary, whatever the order of the f64 sum.  The blend uses
// __fmul_rn/__fadd_rn so it is not contracted into an FMA and rounds like
// the plain version's separate multiplies and add; the divisions are IEEE
// (the build does not use --use_fast_math).  The Pallas kernel sums the
// dot product in f32, an ulp-level difference from both.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int CONSUMER_WARPS = 4;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;   // one float4 of 128 each
constexpr int WARPS = CONSUMER_WARPS + 1;        // and the producer's warp
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 4;     // ring depth, in stages
constexpr int STAGE_FLOAT4 = 1024;   // 16 KB a stage: 4 rows at C <= 512
constexpr int TILE = 4096;    // rows compacted at once (32 KB of lists)
constexpr uint32_t SPIN_LIMIT = 1u << 22;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier has left the phase of this parity.  A barrier
// that never completes would hang the card, so a wait that is still
// failing after SPIN_LIMIT polls (a tenth of a second at the least,
// against the microsecond a copy takes) traps instead: the launch then
// ends in an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spins == SPIN_LIMIT) __trap();
  }
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory to shared memory, counted on `bar` when it lands.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

// The unmasked rows q = first, first+stride, ... of one sample: a warp a
// row, all of a row's loads started before its stores.
template <int CH>
__device__ __forceinline__ void copy_unmasked(
    const float4* __restrict__ kn4, const float* __restrict__ fl,
    float4* __restrict__ out4, float* __restrict__ ao, float* __restrict__ bo,
    int n, int row4, int first, int stride, int lane) {
  for (int q = first; q < n; q += stride) {
    if (fl[q] > 0.f) continue;
    const float4* src = kn4 + static_cast<size_t>(q) * row4;
    float4* dst = out4 + static_cast<size_t>(q) * row4;
    float4 v[4 * CH];
#pragma unroll
    for (int j = 0; j < 4 * CH; ++j)
      if (j * 32 + lane < row4) v[j] = src[j * 32 + lane];
#pragma unroll
    for (int j = 0; j < 4 * CH; ++j)
      if (j * 32 + lane < row4) dst[j * 32 + lane] = v[j];
    if (lane == 0) {
      ao[q] = 1.f;
      bo[q] = 0.f;
    }
  }
}

// CH = ceil(C / 512): float4s of a row that a consumer thread owns.
template <int CH>
__global__ void __launch_bounds__(THREADS)
scan_stream_kernel(const float* __restrict__ pn, const float* __restrict__ known,
                   const float* __restrict__ flag, const float* __restrict__ vmax,
                   float* __restrict__ out, float* __restrict__ a_out,
                   float* __restrict__ b_out, int bsz, int n, int row4,
                   int copy_blocks) {
  // the ring: STAGES stages of ROWS masked rows, each row's pn_q at
  // 2*row4 float4s a row and its known_q after it
  extern __shared__ __align__(128) unsigned char ring_bytes[];
  __shared__ int s_idx[TILE];        // masked rows of the tile, in order
  __shared__ float s_vmax[TILE];     // and their vmax
  __shared__ __align__(8) uint64_t s_full[STAGES];
  __shared__ __align__(8) uint64_t s_empty[STAGES];
  __shared__ double s_part[2][CONSUMER_WARPS];
  __shared__ int s_cnt[WARPS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool chain = blockIdx.x < static_cast<unsigned>(bsz);
  const size_t s = chain ? blockIdx.x : (blockIdx.x - bsz) / copy_blocks;
  const float4* pn4 = reinterpret_cast<const float4*>(pn) + s * n * row4;
  const float4* kn4 = reinterpret_cast<const float4*>(known) + s * n * row4;
  float4* out4 = reinterpret_cast<float4*>(out) + s * n * row4;
  const float* fl = flag + s * n;
  const float* vm = vmax + s * n;
  float* ao = a_out + s * n;
  float* bo = b_out + s * n;

  if (!chain) {
    const int j = (blockIdx.x - bsz) % copy_blocks;
    copy_unmasked<CH>(kn4, fl, out4, ao, bo, n, row4, j * WARPS + warp,
                      copy_blocks * WARPS, lane);
    return;
  }

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(smem_u32(&s_full[i]), 1);                 // the producer
      mbar_init(smem_u32(&s_empty[i]), CONSUMER_WARPS);   // a lane a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  constexpr int ROWS = STAGE_FLOAT4 / (2 * CH * CONSUMERS);   // 4 or 2
  const uint32_t row_bytes = static_cast<uint32_t>(row4) * 16u;
  const float4* ring = reinterpret_cast<const float4*>(ring_bytes);
  const uint32_t ring_addr = smem_u32(ring_bytes);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  bool own[CH];
  float4 carry[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    own[j] = j * CONSUMERS + tid < row4;
    carry[j] = zero4;
  }
  bool seen = false;
  // Both roles walk the ring in step: `phase` is the parity of the round.
  int stage = 0;
  uint32_t phase = 0;
  uint32_t step = 0;   // masked rows so far: picks the s_part buffer

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
    __syncthreads();   // counts written; the previous tile's lists are done
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
        const int at_pos = pos + __popc(bal & ((1u << lane) - 1u));
        s_idx[at_pos] = t0 + r;
        s_vmax[at_pos] = vm[t0 + r];
      }
      pos += __popc(bal);
    }
    __syncthreads();   // lists (and, the first time, the barriers) ready

    if (warp == CONSUMER_WARPS) {
      // ---- producer: one thread keeps the ring full, ROWS rows a stage
      if (lane == 0) {
        for (int i0 = 0; i0 < m; i0 += ROWS) {
          const int take = min(ROWS, m - i0);   // the last stage may be short
          mbar_wait(smem_u32(&s_empty[stage]), phase ^ 1u);
          const uint32_t full = smem_u32(&s_full[stage]);
          mbar_arrive_expect_tx(full, take * 2u * row_bytes);
          for (int r = 0; r < take; ++r) {
            const uint32_t dst =
                ring_addr + (stage * ROWS + r) * 2u * row_bytes;
            const size_t row = static_cast<size_t>(s_idx[i0 + r]) * row4;
            bulk_load(dst, pn4 + row, row_bytes, full);
            bulk_load(dst + row_bytes, kn4 + row, row_bytes, full);
          }
          if (++stage == STAGES) { stage = 0; phase ^= 1u; }
        }
      }
      __syncwarp();
    } else if (m > 0) {
      // ---- consumers: the chain.  Row i+1 is read from the ring into
      // registers before the arithmetic of row i, so neither the wait for
      // a stage nor the shared-memory read sits between two steps.
      float4 p_nx[CH], k_nx[CH];
      auto read_row = [&](int r) {
        const float4* sp =
            ring + static_cast<size_t>(stage * ROWS + r) * 2 * row4;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          p_nx[j] = own[j] ? sp[j * CONSUMERS + tid] : zero4;
          k_nx[j] = own[j] ? sp[row4 + j * CONSUMERS + tid] : zero4;
        }
      };
      auto release_stage = [&]() {
        __syncwarp();   // every lane has read its part of the stage
        if (lane == 0) mbar_arrive(smem_u32(&s_empty[stage]));
        if (++stage == STAGES) { stage = 0; phase ^= 1u; }
      };
      mbar_wait(smem_u32(&s_full[stage]), phase);
      read_row(0);
      int q_nx = s_idx[0];
      float v_nx = s_vmax[0];
      int r = 0;
#pragma unroll 1
      for (int i = 0; i < m; ++i) {
        const int q = q_nx;
        const float v = v_nx;
        float4 p[CH], k[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          p[j] = p_nx[j];
          k[j] = k_nx[j];
        }
        if (i + 1 < m) {
          if (++r == ROWS) {
            r = 0;
            release_stage();
            mbar_wait(smem_u32(&s_full[stage]), phase);
          }
          read_row(r);
          q_nx = s_idx[i + 1];
          v_nx = s_vmax[i + 1];
        }

        // <pn_q, carry> in f64, rounded once to f32 (see the note above)
        double dot;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const double xy = fma(double(p[j].x), double(carry[j].x),
                                double(p[j].y) * double(carry[j].y));
          const double zw = fma(double(p[j].z), double(carry[j].z),
                                double(p[j].w) * double(carry[j].w));
          dot = j == 0 ? xy + zw : dot + (xy + zw);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        double* part = s_part[step & 1u];
        if (lane == 0) part[warp] = dot;
        // One barrier a step is enough with two buffers: this buffer is
        // written again two steps on, after the next step's barrier, which
        // no thread passes before it has read this step's sums.
        consumer_barrier();
        const float at = __double2float_rn((part[0] + part[1])
                                           + (part[2] + part[3]));
        ++step;

        const float denom = at + v;
        const float a = seen ? at / denom : 0.f;
        const float b = seen ? v / denom : 1.f;
        seen = true;

        float4* orow = out4 + static_cast<size_t>(q) * row4;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          float4 o;
          o.x = __fadd_rn(__fmul_rn(a, carry[j].x), __fmul_rn(b, k[j].x));
          o.y = __fadd_rn(__fmul_rn(a, carry[j].y), __fmul_rn(b, k[j].y));
          o.z = __fadd_rn(__fmul_rn(a, carry[j].z), __fmul_rn(b, k[j].z));
          o.w = __fadd_rn(__fmul_rn(a, carry[j].w), __fmul_rn(b, k[j].w));
          carry[j] = o;
          if (own[j]) orow[j * CONSUMERS + tid] = o;
        }
        // every thread holds (a, b): a whole warp stores each, one
        // transaction and no divergent branch
        if (warp == 1) ao[q] = a;
        if (warp == 2) bo[q] = b;
      }
      release_stage();   // the tile's last stage, full or not
    }
  }
}

template <int CH>
int launch(const float* pn, const float* known, const float* flag,
           const float* vmax, float* out, float* a, float* b, int bsz, int n,
           int c, int copy_blocks, cudaStream_t stream) {
  const int ring_bytes = STAGES * STAGE_FLOAT4 * 16;
  cudaError_t err = cudaFuncSetAttribute(
      scan_stream_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ring_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(bsz) * (1u + copy_blocks);
  scan_stream_kernel<CH><<<grid, THREADS, ring_bytes, stream>>>(
      pn, known, flag, vmax, out, a, b, bsz, n, c / 4, copy_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), does not synchronise,
// allocates nothing.  C must be a multiple of 4 and at most 1024; all
// pointers 16-byte aligned and contiguous.  Returns the first CUDA error,
// cudaGetLastError() after the launch included.
extern "C" int scan_stream_f32(const float* pn, const float* known,
                               const float* flag, const float* vmax,
                               float* out, float* a, float* b, int bsz, int n,
                               int c, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bsz <= 0 || n < 0 || c <= 0 || c % 4 != 0 || c > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // Copy blocks a sample: about two blocks an SM over the whole launch.
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int copy_blocks =
      std::max(1, std::min(128, (2 * sms + bsz - 1) / bsz));
  if (static_cast<long long>(bsz) * (1 + copy_blocks) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (c <= 512)
    return launch<1>(pn, known, flag, vmax, out, a, b, bsz, n, c, copy_blocks,
                     stream);
  return launch<2>(pn, known, flag, vmax, out, a, b, bsz, n, c, copy_blocks,
                   stream);
}
