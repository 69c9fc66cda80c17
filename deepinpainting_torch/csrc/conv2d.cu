// Direct f32 convolution for Hopper (sm_90a): an implicit GEMM on the CUDA
// cores.
//
// It replaces no TPU kernel: the JAX package leaves its convolutions to
// XLA.  It replaces cuDNN's f32 forward algorithms (implicit GEMM and FFT)
// on the convolutions that ops/convs.py routes to it: the forward of every
// kernel-4 Conv2d and the input gradient of every ConvTranspose2d, which is
// the plain convolution of the output gradient by the layer's own weight.
//
//   y[b, n, oh, ow] = bias[n] + sum over (c, kh, kw) of
//                     x[b, c, oh*s - p + kh*d, ow*s - p + kw*d] * w[n, c, kh, kw]
//
// NCHW in and out, zero padding, kernel KS = 3 or 4 (any stride, padding and
// dilation the wrapper passes: ops/conv_cuda.py checks them).
//
// What bounds it on an H100.  As a GEMM of M = B*Ho*Wo rows, N = Cout
// columns and depth K = C*KS*KS it does 2*M*N*K operations in f32.  With
// TF32 off the only f32 multiply-add is the CUDA cores' FFMA, 67 TFLOP/s at
// 700 W.  The layers it takes have K of 1,024 to 8,192 (the first and last
// layers excepted), so 2K operations a four-byte output is far above the
// 20 operations a byte the card needs to be bound by FFMA: the design is
// about issuing FFMA and little else.  On the card the FFMA loop alone
// (every load but the first left out) runs at ~78% of the peak, the whole
// kernel at 55-62% on the large shapes: the gathering copies cost the
// rest, by the instructions that start them and not by their latency
// (waiting on none of them gains nothing, nor do deeper rings).
//
// Design.  A block of 256 threads computes a BM x BN tile of the GEMM
// (256 x 128, 128 x 128, 128 x 64 or 64 x 64: ops/conv_cuda.py::plan),
// each thread a TM x TN = (BM/16) x (BN/16) grid of outputs in registers,
// in groups of four rows (columns) 64 apart, so that each of its reads of
// a step is a 16-byte vector; a warp is 8 x 4 threads.  Per step of depth
// BK = 8 a thread reads TM + TN values from shared memory, the next step's
// while it does this one's TM*TN FFMA (128 at 256 x 128).  The input tile
// (an im2col slice, gathered: each element its own address) and the
// weight tile are copied into a ring of STAGES tiles in shared memory with
// cp.async, four bytes an element, zero-filled outside the image, so that
// the next tiles' loads run under this one's FFMA.  A thread's row of the
// input tile is one output pixel, decoded once with a mask of which of its
// KS*KS taps fall inside the image; a tap's offset in a channel's plane
// comes from a table in shared memory, and with KS = 4 a step lies in one
// channel, so an element costs a bit test, an add and its copy.  The
// input tile lies k-major ([BK][BM], consecutive threads on consecutive
// output pixels), the weight tile transposed to [BK][BN+4] (a warp reads
// four weight rows' 32 bytes; the pad spreads the transposing stores over
// the banks).  Outputs go out as float4 where four rows of the GEMM are
// four neighbouring pixels of one image, else one by one.
//
// Where the tiles alone leave the card idle (small M*N, deep K: the inner
// U-Net levels), the depth splits into `splits` slices, a block each (grid
// z); each slice writes its partial sums to a workspace, and a second
// kernel adds them in slice order and adds the bias.
//
// Rounding.  Every output is one thread's FFMA chain over its slice of K
// in increasing k, then (split) the slices' sums added in order: a fixed
// order for each shape, no atomics, so a launch repeats bit for bit.  No
// TF32, no split-precision tensor-core products: f32 operands, f32
// accumulation, as cuDNN's f32 algorithms with TF32 off.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 8;
constexpr int STAGES = 3;

struct Geo {
  int c, h, w;        // input channels and size
  int n;              // output channels
  int ho, wo;         // output size
  int stride, pad, dil;
  int m;              // B*ho*wo
  int k;              // c*KS*KS
  int k_split;        // depth of one split, a multiple of BK
};

// A 4-byte copy from device memory to shared memory, or zeros where
// `valid` is false (the source is then not read).
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
#if defined(__CUDA_ARCH__)
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
#else
  *dst = valid ? *src : 0.f;
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most `PENDING` committed groups of this thread are in
// flight.
template <int PENDING>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
#endif
}

template <int KS, int TM, int TN>
__global__ void __launch_bounds__(THREADS, TM * TN > 64 ? 1 : 2)
conv2d_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ bias, float* __restrict__ y,
                  Geo g) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  constexpr int KK = KS * KS;
  constexpr int A_ROWS = THREADS / BM;        // k rows a load pass covers
  constexpr int A_PER = BK / A_ROWS;          // input elements a thread
  constexpr int B_PER = BN * BK / THREADS;    // weight elements a thread
  constexpr int B_ROWS = THREADS / BK;        // weight rows a load pass covers
  constexpr int BNP = BN + 4;
  __shared__ __align__(16) float as[STAGES][BK][BM];
  __shared__ __align__(16) float bs[STAGES][BK][BNP];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_lo = blockIdx.z * g.k_split;
  const int k_hi = min(g.k, k_lo + g.k_split);
  const int tiles = (k_hi - k_lo + BK - 1) / BK;

  // This thread's row of the input tile: one output pixel.  Bit r of
  // `inside` says that its tap r = kh*KS + kw falls inside the image; `pix`
  // indexes its tap (0, 0) in channel 0 (which may lie outside).
  __shared__ int tap[KK];   // offset of tap r in a channel's plane
  if (tid < KK) tap[tid] = (tid / KS) * g.dil * g.w + (tid % KS) * g.dil;
  const int a_m = tid % BM, a_k = tid / BM;
  const int am = m0 + a_m;
  const bool am_ok = am < g.m;
  const int hw = g.ho * g.wo;
  const int ab = am_ok ? am / hw : 0;
  const int ar = am - ab * hw;
  const int oh = ar / g.wo, ow = ar - (ar / g.wo) * g.wo;
  const int ih0 = oh * g.stride - g.pad, iw0 = ow * g.stride - g.pad;
  unsigned inside = 0;
#pragma unroll
  for (int r = 0; r < KK; ++r) {
    const int ih = ih0 + (r / KS) * g.dil, iw = iw0 + (r % KS) * g.dil;
    if (am_ok && static_cast<unsigned>(ih) < static_cast<unsigned>(g.h) &&
        static_cast<unsigned>(iw) < static_cast<unsigned>(g.w))
      inside |= 1u << r;
  }
  const long long plane = static_cast<long long>(g.h) * g.w;
  const long long pix = static_cast<long long>(ab) * g.c * plane +
                        static_cast<long long>(ih0) * g.w + iw0;
  // This thread's part of the weight tile: column b_k of rows b_n + j *
  // B_ROWS (a warp reads four rows' 32 bytes at a time), each row's
  // pointer clamped into the tensor (a row past n is zero-filled, never
  // read) and bit j of `rows_in` set for a row that exists.
  const int b_k = tid % BK, b_n = tid / BK;
  const float* wrow[B_PER];
  unsigned rows_in = 0;
#pragma unroll
  for (int j = 0; j < B_PER; ++j) {
    const int n = n0 + b_n + j * B_ROWS;
    if (n < g.n) rows_in |= 1u << j;
    wrow[j] = wt + static_cast<size_t>(min(n, g.n - 1)) * g.k + b_k;
  }
  __syncthreads();   // tap[] is written

  // With KS*KS a multiple of BK (kernel 4) a step lies in one channel and
  // inside its split (whose depth is a multiple of BK), so neither bound
  // needs a test per element.
  constexpr bool WHOLE = KK % BK == 0;
  auto load_tile = [&](int t, int st) {
    const int kb = k_lo + t * BK;
    // This thread's k of the step are kb + a_k + j*A_ROWS: channel ci,
    // taps r0 + j*A_ROWS, the channel advancing once past the last tap.
    const int ci = (kb + a_k) / KK;
    const int r0 = kb + a_k - ci * KK;
    const long long base = pix + ci * plane;
    const unsigned ins = inside >> r0;
    const int left = k_hi - kb;   // k of the step inside the split
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int kl = a_k + j * A_ROWS;
      int r = r0 + j * A_ROWS;
      long long chan = base;
      bool ok;
      if (WHOLE) {
        ok = (ins >> (j * A_ROWS)) & 1u;
      } else {
        if (r >= KK) {
          r -= KK;
          chan += plane;
        }
        ok = kl < left && ((inside >> r) & 1u);
      }
      copy4(&as[st][kl][a_m], ok ? x + (chan + tap[r]) : x, ok);
    }
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const bool ok = ((rows_in >> j) & 1u) && (WHOLE || b_k < left);
      copy4(&bs[st][b_k][b_n + j * B_ROWS], wrow[j] + kb, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load_tile(s, s);
    copy_commit();
  }

  // A thread's outputs: rows q*64 + tm*4 + 0..3 and columns q*64 + tn*4 +
  // 0..3 of the tile, for each group q of four; its reads of one k step
  // are TM/4 + TN/4 float4s.  A warp is 8 (tm) x 4 (tn) threads, so that
  // a read of one k step touches 8 and 4 float4s.
  const int warp = tid / 32, lane = tid % 32;
  const int tm = (warp % 2) * 8 + lane % 8, tn = (warp / 2) * 4 + lane / 8;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float a[2][TM], b[2][TN];
  auto load_frag = [&](int st, int kk, float* af, float* bf) {
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(&as[st][kk][q * 64 + tm * 4]);
      af[4 * q] = v.x; af[4 * q + 1] = v.y; af[4 * q + 2] = v.z;
      af[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(&bs[st][kk][q * 64 + tn * 4]);
      bf[4 * q] = v.x; bf[4 * q + 1] = v.y; bf[4 * q + 2] = v.z;
      bf[4 * q + 3] = v.w;
    }
  };

  for (int t = 0; t < tiles; ++t) {
    copy_wait<STAGES - 2>();
    __syncthreads();
    // The stage this refills was read in step t-1, which every thread has
    // finished at the barrier above.
    if (t + STAGES - 1 < tiles)
      load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    copy_commit();
    const int st = t % STAGES;
    // Each k step's shared-memory reads are issued one step ahead.
    load_frag(st, 0, a[0], b[0]);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk + 1 < BK) load_frag(st, kk + 1, a[(kk + 1) & 1], b[(kk + 1) & 1]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
    }
  }
  copy_wait<0>();

  // Split launches write raw partial sums into slice z of the workspace
  // (the bias is the summing kernel's); whole ones add the bias here.
  float* out = y + static_cast<size_t>(blockIdx.z) * g.m * g.n;
  const bool add_bias = bias != nullptr && gridDim.z == 1;
#pragma unroll
  for (int h = 0; h < TM / 4; ++h) {
    const int mb = m0 + h * 64 + tm * 4;   // four rows mb..mb+3
    if (mb >= g.m) continue;
    const int b = mb / hw;
    const int r = mb - b * hw;
    const bool vec = (hw % 4 == 0) && mb + 3 < g.m;   // one image, aligned
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * 64 + tn * 4 + (j % 4);
      if (n >= g.n) continue;
      const float bv = add_bias ? bias[n] : 0.f;
      if (vec) {
        float4 v;
        v.x = acc[4 * h][j] + bv;
        v.y = acc[4 * h + 1][j] + bv;
        v.z = acc[4 * h + 2][j] + bv;
        v.w = acc[4 * h + 3][j] + bv;
        *reinterpret_cast<float4*>(
            out + (static_cast<size_t>(b) * g.n + n) * hw + r) = v;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mi = mb + i;
          if (mi >= g.m) break;
          const int bi = mi / hw;
          out[(static_cast<size_t>(bi) * g.n + n) * hw + (mi - bi * hw)] =
              acc[4 * h + i][j] + bv;
        }
      }
    }
  }
}

// y = bias + the sum of the `splits` partial outputs, in slice order.
__global__ void conv2d_splitk_sum_kernel(const float* __restrict__ part,
                                         const float* __restrict__ bias,
                                         float* __restrict__ y, int splits,
                                         size_t total, int n, int hw) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s += part[z * total + i];
    if (bias != nullptr) s += bias[(i / hw) % n];
    y[i] = s;
  }
}

// ---- launcher ----

template <int KS, int TM, int TN>
int launch(const float* x, const float* w, const float* bias, float* y,
           float* part, const Geo& g, int splits, cudaStream_t stream) {
  dim3 grid((g.m + 16 * TM - 1) / (16 * TM), (g.n + 16 * TN - 1) / (16 * TN),
            splits);
  conv2d_f32_kernel<KS, TM, TN><<<grid, THREADS, 0, stream>>>(
      x, w, bias, splits > 1 ? part : y, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(g.m) * g.n;
  const int blocks = static_cast<int>((total + 1023) / 1024);
  conv2d_splitk_sum_kernel<<<blocks < 4096 ? blocks : 4096, 256, 0, stream>>>(
      part, bias, y, splits, total, g.n, g.ho * g.wo);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_tile(const float* x, const float* w, const float* bias, float* y,
                float* part, const Geo& g, int bm, int bn, int splits,
                cudaStream_t stream) {
  if (bm == 256 && bn == 128)
    return launch<KS, 16, 8>(x, w, bias, y, part, g, splits, stream);
  if (bm == 128 && bn == 128)
    return launch<KS, 8, 8>(x, w, bias, y, part, g, splits, stream);
  if (bm == 128 && bn == 64)
    return launch<KS, 8, 4>(x, w, bias, y, part, g, splits, stream);
  if (bm == 64 && bn == 64)
    return launch<KS, 4, 4>(x, w, bias, y, part, g, splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [bsz, c, h, w], w [n, c, ks, ks], bias [n] or null, y [bsz, n, ho, wo],
// all f32, contiguous, on `device`.  part: splits * bsz*n*ho*wo floats of
// workspace when splits > 1 (else unused).  The depth of one split,
// k_split, is a multiple of 8 that covers c*ks*ks in `splits` slices.
// Returns a cudaError_t (0: launched).
extern "C" int conv2d_f32(const float* x, const float* w, const float* bias,
                          float* y, float* part, int bsz, int c, int h,
                          int wd, int n, int ho, int wo, int ks, int stride,
                          int pad, int dil, int bm, int bn, int splits,
                          int k_split, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geo g;
  g.c = c; g.h = h; g.w = wd; g.n = n; g.ho = ho; g.wo = wo;
  g.stride = stride; g.pad = pad; g.dil = dil;
  g.m = bsz * ho * wo;
  g.k = c * ks * ks;
  g.k_split = k_split;
  if (bsz <= 0 || g.m <= 0 || n <= 0 || splits < 1 || k_split % BK != 0 ||
      static_cast<long long>(k_split) * splits < g.k ||
      static_cast<long long>(k_split) * (splits - 1) >= g.k ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (ks == 4)
    return launch_tile<4>(x, w, bias, y, part, g, bm, bn, splits, stream);
  if (ks == 3)
    return launch_tile<3>(x, w, bias, y, part, g, bm, bn, splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
