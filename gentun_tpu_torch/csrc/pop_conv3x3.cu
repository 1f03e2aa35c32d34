// Population-batched 3x3 SAME convolution for Hopper (sm_90a): forward and
// weight gradient, with a plain C interface (loaded with ctypes by
// gentun_tpu_torch/ops/_build.py, wrapped by gentun_tpu_torch/ops/pop_conv.py).
//
// What it replaces: the conv of the JAX package's MaskedGeneticCnn.__call__
// under vmap(pop), and its reverse under jax.value_and_grad, which XLA
// compiled for the TPU (there is no Pallas kernel behind them):
//
// replaces pop_conv3x3_fwd: gentun_tpu/models/cnn.py:131
// replaces pop_conv3x3_wgrad: gentun_tpu/models/cnn.py:267
//
// (the conv at cnn.py:131-160; the gradient at cnn.py:267,277).  On this card
// the port called cuDNN's grouped conv before, whose algorithm (and so its
// summation order) depends on the group count P, so a genome's gradient
// depended on the batch it trained in.
//
// The property these kernels exist for: the population slot is a grid axis
// (blockIdx.z, so at most 65,535 slots per call), and tile sizes, the split of every reduction and the order
// of every sum are fixed by (B, H, W, C, F, dtype) alone, never by the number
// of slots, the slot or the chunk.  So slot s's outputs are the same bits at
// any P.  No atomics anywhere: the weight gradient reduces over (b, h, w) in
// a fixed number of pixel splits (from B*H*W only) into a scratch buffer of
// partial sums, and a second pass adds the splits in order.
//
// Layouts (the port's, NCHW): activations (B, S*C, H, W); weights (S, F, C, 3, 3)
// contiguous, read as an (F, C*9) matrix per slot; bias (S, F).  A shared
// input (the stage-0 image batch, (B, C, H, W)) is read in place by every
// slot: its slot stride in XAddr is 0.
//
// What bounds them (NVIDIA H100 SXM data sheet, 700 W): at config #2 a node conv does
// 2*B*H*W*9*C*F flops on B*H*W*(C+F) activations, about 15 flops a byte in
// bf16 at stage 0 and 60 at stage 2, so against the card's 989 TFLOP/s and
// 3.35 TB/s (295 flops a byte) every layer is bound by memory when run
// perfectly.  These first kernels are far from either bound: they are
// implicit GEMMs with a tile in shared memory, no pipelining of the loads and
// WMMA (mma.sync) for bf16, so they are bound by the latency of their global
// loads and the im2col index arithmetic.  What the design does about the
// bound: each input tile is read once into shared memory per CTA and reused
// across BM output channels (forward) or BN weight columns (weight gradient),
// and activations stay NCHW, so no layout transposes run around the kernel.
// float32 (IEEE, no TF32) and float64 run as plain FMA loops.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

enum DType { kBF16 = 0, kF32 = 1, kF64 = 2 };

// Where the conv input of slot s, image b, channel c starts.
struct XAddr {
  long long sstride;  // between slots (0 for a shared input)
  long long bstride;  // between images
  __device__ __forceinline__ long long slot_base(int s) const { return (long long)s * sstride; }
};

template <typename T> struct AccOf { typedef float type; };
template <> struct AccOf<double> { typedef double type; };

template <typename T> __device__ __forceinline__ T zero_of() { return T(0); }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.0f); }

__device__ __forceinline__ bf16 from_acc(float v, bf16*) { return __float2bfloat16(v); }
__device__ __forceinline__ float from_acc(float v, float*) { return v; }
__device__ __forceinline__ double from_acc(double v, double*) { return v; }

// The conv result rounded to T, then the bias added in T: the two roundings
// of a conv followed by a bias add, as the reference computes it.
__device__ __forceinline__ bf16 epilogue(float acc, const bf16* bias, int i) {
  bf16 r = __float2bfloat16(acc);
  if (bias) r = __float2bfloat16(__bfloat162float(r) + __bfloat162float(bias[i]));
  return r;
}
__device__ __forceinline__ float epilogue(float acc, const float* bias, int i) {
  return bias ? __fadd_rn(acc, bias[i]) : acc;
}
__device__ __forceinline__ double epilogue(double acc, const double* bias, int i) {
  return bias ? __dadd_rn(acc, bias[i]) : acc;
}

// One im2col element: input (c, h + kh - 1, w + kw - 1) of one image, zero
// outside the image (SAME padding).  k = c*9 + kh*3 + kw, the weight's order.
template <typename T>
__device__ __forceinline__ T im2col(const T* __restrict__ ximg, int k, int h, int w,
                                    int H, int W, int HW) {
  const int c = k / 9, r = k - c * 9;
  const int kh = r / 3, kw = r - kh * 3;
  const int hh = h + kh - 1, ww = w + kw - 1;
  if ((unsigned)hh >= (unsigned)H || (unsigned)ww >= (unsigned)W) return zero_of<T>();
  return ximg[(long long)c * HW + hh * W + ww];
}

// ---------------------------------------------------------------------------
// Forward: y[b, s*F + o, h, w] = bias[s, o] + sum_k W[s, o, k] * im2col[k, (b, h, w)]
// An implicit GEMM per slot, M = F (output channels), N = B*H*W pixels,
// K = C*9, each CTA one BM x BN tile with the whole K loop in order.
// ---------------------------------------------------------------------------

namespace fwd_tc {  // bf16 on the tensor cores (WMMA 16x16x16, float accumulator)
constexpr int BM = 64, BN = 128, BK = 32, WM = 32, WN = 32;
constexpr int WARPS_N = BN / WN, NT = (BM / WM) * WARPS_N * 32;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2, SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
}  // namespace fwd_tc

__global__ void __launch_bounds__(fwd_tc::NT)
fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, bf16* __restrict__ y,
                int S, int B, int C, int F, int H, int W, XAddr xa) {
  using namespace fwd_tc;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16(*As)[LDA] = reinterpret_cast<bf16(*)[LDA]>(smem);
  bf16(*Bs)[LDB] = reinterpret_cast<bf16(*)[LDB]>(smem + BM * LDA * 2);
  float(*Cs)[LDC] = reinterpret_cast<float(*)[LDC]>(smem);

  const int tid = threadIdx.x, warp = tid / 32;
  const int s = blockIdx.z, m0 = blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const int HW = H * W, K = C * 9;
  const long long npix = (long long)B * HW;
  const bf16* ws = w + (long long)s * F * K;

  // Each thread loads (and later stores) one pixel column of the tile.
  const int bn = tid % BN, brow = tid / BN;
  const long long n = n0 + bn;
  const bool nvalid = n < npix;
  int pb = 0, ph = 0, pw = 0;
  if (nvalid) {
    pb = (int)(n / HW);
    const int r = (int)(n - (long long)pb * HW);
    ph = r / W;
    pw = r - ph * W;
  }
  const bf16* ximg = x + xa.slot_base(s) + (long long)pb * xa.bstride;
  const int ak = tid % BK, arow = tid / BK;

  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int m = arow + i * (NT / BK), k = k0 + ak;
      As[m][ak] = (m0 + m < F && k < K) ? ws[(long long)(m0 + m) * K + k] : zero_of<bf16>();
    }
#pragma unroll
    for (int i = 0; i < BK * BN / NT; ++i) {
      const int kl = brow + i * (NT / BN), k = k0 + kl;
      Bs[kl][bn] = (nvalid && k < K) ? im2col(ximg, k, ph, pw, H, W, HW) : zero_of<bf16>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[WN / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i) wmma::load_matrix_sync(a[i], &As[wm + 16 * i][kk], LDA);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) wmma::load_matrix_sync(b[j], &Bs[kk][wn + 16 * j], LDB);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  if (!nvalid) return;
  const bf16* bs = bias ? bias + (long long)s * F : nullptr;
  bf16* yimg = y + ((long long)pb * S * F + (long long)s * F) * HW + ph * W + pw;
  for (int m = brow; m < BM; m += NT / BN) {
    if (m0 + m < F) yimg[(long long)(m0 + m) * HW] = epilogue(Cs[m][bn], bs, m0 + m);
  }
}

namespace fwd_fma {  // float32 and float64: FMA loops, a 4x4 tile per thread
constexpr int BM = 64, BN = 64, BK = 16, NT = 256, TM = BM / 16, TN = BN / 16;
}

template <typename T>
__global__ void __launch_bounds__(fwd_fma::NT)
fwd_fma_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
               T* __restrict__ y, int S, int B, int C, int F, int H, int W, XAddr xa) {
  using namespace fwd_fma;
  typedef typename AccOf<T>::type A;
  __shared__ T As[BK][BM + 1];
  __shared__ T Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int s = blockIdx.z, m0 = blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const int HW = H * W, K = C * 9;
  const long long npix = (long long)B * HW;
  const T* ws = w + (long long)s * F * K;
  const T* xs = x + xa.slot_base(s);

  const int bn = tid % BN, brow = tid / BN;
  const long long n = n0 + bn;
  const bool nvalid = n < npix;
  int pb = 0, ph = 0, pw = 0;
  if (nvalid) {
    pb = (int)(n / HW);
    const int r = (int)(n - (long long)pb * HW);
    ph = r / W;
    pw = r - ph * W;
  }
  const T* ximg = xs + (long long)pb * xa.bstride;
  const int ak = tid % BK, arow = tid / BK;

  A acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = A(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int m = arow + i * (NT / BK), k = k0 + ak;
      As[ak][m] = (m0 + m < F && k < K) ? ws[(long long)(m0 + m) * K + k] : T(0);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / NT; ++i) {
      const int kl = brow + i * (NT / BN), k = k0 + kl;
      Bs[kl][bn] = (nvalid && k < K) ? im2col(ximg, k, ph, pw, H, W, HW) : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      A a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const T* bs = bias ? bias + (long long)s * F : nullptr;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const long long nj = n0 + tx + 16 * j;
    if (nj >= npix) continue;
    const int b = (int)(nj / HW), r = (int)(nj - (long long)b * HW);
    T* yp = y + ((long long)b * S * F + (long long)s * F) * HW + r;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < F) yp[(long long)m * HW] = epilogue(acc[i][j], bs, m);
    }
  }
}

// ---------------------------------------------------------------------------
// Weight gradient, pass 1: for pixel split sp of slot s,
//   part[s, sp, o, k] = sum over the split's pixels p, in order, of dY[o, p] * im2col[k, p]
//   dbpart[s, sp, o]  = sum over the split's pixels of dY[o, p]
// M = F, N = C*9, the reduction over pixels in chunks of BK.
// ---------------------------------------------------------------------------

namespace wg_tc {
constexpr int BM = 64, BN = 64, BK = 32, WM = 32, WN = 32;
constexpr int WARPS_N = BN / WN, NT = (BM / WM) * WARPS_N * 32;
constexpr int LDA = BK + 8, LDB = BK + 8, LDC = BN + 4;
constexpr int SMEM_AB = (BM * LDA + BN * LDB) * 2, SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
}  // namespace wg_tc

__global__ void __launch_bounds__(wg_tc::NT)
wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  float* __restrict__ part, float* __restrict__ dbpart,
                  int S, int B, int C, int F, int H, int W, int splits, int pix_per_split,
                  XAddr xa) {
  using namespace wg_tc;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16(*As)[LDA] = reinterpret_cast<bf16(*)[LDA]>(smem);               // dY: [o][pixel]
  bf16(*Bs)[LDB] = reinterpret_cast<bf16(*)[LDB]>(smem + BM * LDA * 2);  // im2col: [k][pixel]
  float(*Cs)[LDC] = reinterpret_cast<float(*)[LDC]>(smem);

  const int tid = threadIdx.x, warp = tid / 32;
  // blockIdx.x = split * (K tiles) + K tile, so the split count never
  // limits the slots.
  const int k_tiles = (C * 9 + BN - 1) / BN, sp = blockIdx.x / k_tiles, s = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = (blockIdx.x - sp * k_tiles) * BN;
  const int HW = H * W, K = C * 9;
  const long long npix = (long long)B * HW;
  const long long p_begin = (long long)sp * pix_per_split;
  const long long p_end = p_begin + pix_per_split < npix ? p_begin + pix_per_split : npix;
  const bf16* xs = x + xa.slot_base(s);
  const long long dy_b = (long long)S * F * HW;
  const bf16* dys = dy + (long long)s * F * HW;
  const int pl = tid % BK, row = tid / BK;
  const bool bias_tile = n0 == 0;

  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  float bsum = 0.0f;

  for (long long p0 = p_begin; p0 < p_end; p0 += BK) {
    const long long p = p0 + pl;
    const bool pvalid = p < p_end;
    int pb = 0, r = 0, ph = 0, pw = 0;
    if (pvalid) {
      pb = (int)(p / HW);
      r = (int)(p - (long long)pb * HW);
      ph = r / W;
      pw = r - ph * W;
    }
    const bf16* dyp = dys + (long long)pb * dy_b + r;
    const bf16* ximg = xs + (long long)pb * xa.bstride;
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int m = row + i * (NT / BK);
      As[m][pl] = (pvalid && m0 + m < F) ? dyp[(long long)(m0 + m) * HW] : zero_of<bf16>();
    }
#pragma unroll
    for (int i = 0; i < BN * BK / NT; ++i) {
      const int kl = row + i * (NT / BK), k = n0 + kl;
      Bs[kl][pl] = (pvalid && k < K) ? im2col(ximg, k, ph, pw, H, W, HW) : zero_of<bf16>();
    }
    __syncthreads();
    if (bias_tile && tid < BM) {
#pragma unroll
      for (int q = 0; q < BK; ++q) bsum += __bfloat162float(As[tid][q]);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[WN / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i) wmma::load_matrix_sync(a[i], &As[wm + 16 * i][kk], LDA);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) wmma::load_matrix_sync(b[j], &Bs[wn + 16 * j][kk], LDB);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  const long long split_row = (long long)s * splits + sp;
  float* out = part + split_row * F * K;
  const int kc = tid % BN;
  for (int m = tid / BN; m < BM; m += NT / BN) {
    if (m0 + m < F && n0 + kc < K) out[(long long)(m0 + m) * K + n0 + kc] = Cs[m][kc];
  }
  if (bias_tile && tid < BM && m0 + tid < F) dbpart[split_row * F + m0 + tid] = bsum;
}

namespace wg_fma {
constexpr int BM = 64, BN = 64, BK = 16, NT = 256, TM = BM / 16, TN = BN / 16;
}

template <typename T>
__global__ void __launch_bounds__(wg_fma::NT)
wgrad_fma_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 typename AccOf<T>::type* __restrict__ part,
                 typename AccOf<T>::type* __restrict__ dbpart,
                 int S, int B, int C, int F, int H, int W, int splits, int pix_per_split,
                 XAddr xa) {
  using namespace wg_fma;
  typedef typename AccOf<T>::type A;
  __shared__ T As[BK][BM + 1];  // dY: [pixel][o]
  __shared__ T Bs[BK][BN + 1];  // im2col: [pixel][k]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // blockIdx.x = split * (K tiles) + K tile, so the split count never
  // limits the slots.
  const int k_tiles = (C * 9 + BN - 1) / BN, sp = blockIdx.x / k_tiles, s = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = (blockIdx.x - sp * k_tiles) * BN;
  const int HW = H * W, K = C * 9;
  const long long npix = (long long)B * HW;
  const long long p_begin = (long long)sp * pix_per_split;
  const long long p_end = p_begin + pix_per_split < npix ? p_begin + pix_per_split : npix;
  const T* xs = x + xa.slot_base(s);
  const long long dy_b = (long long)S * F * HW;
  const T* dys = dy + (long long)s * F * HW;
  const int pl = tid % BK, row = tid / BK;
  const bool bias_tile = n0 == 0;

  A acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = A(0);
  A bsum = A(0);

  for (long long p0 = p_begin; p0 < p_end; p0 += BK) {
    const long long p = p0 + pl;
    const bool pvalid = p < p_end;
    int pb = 0, r = 0, ph = 0, pw = 0;
    if (pvalid) {
      pb = (int)(p / HW);
      r = (int)(p - (long long)pb * HW);
      ph = r / W;
      pw = r - ph * W;
    }
    const T* dyp = dys + (long long)pb * dy_b + r;
    const T* ximg = xs + (long long)pb * xa.bstride;
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int m = row + i * (NT / BK);
      As[pl][m] = (pvalid && m0 + m < F) ? dyp[(long long)(m0 + m) * HW] : T(0);
    }
#pragma unroll
    for (int i = 0; i < BN * BK / NT; ++i) {
      const int kl = row + i * (NT / BK), k = n0 + kl;
      Bs[pl][kl] = (pvalid && k < K) ? im2col(ximg, k, ph, pw, H, W, HW) : T(0);
    }
    __syncthreads();
    if (bias_tile && tid < BM) {
#pragma unroll
      for (int q = 0; q < BK; ++q) bsum += As[q][tid];
    }
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      A a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[q][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[q][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const long long split_row = (long long)s * splits + sp;
  A* out = part + split_row * F * K;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= F) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = n0 + tx + 16 * j;
      if (k < K) out[(long long)m * K + k] = acc[i][j];
    }
  }
  if (bias_tile && tid < BM && m0 + tid < F) dbpart[split_row * F + m0 + tid] = bsum;
}

// Weight gradient, pass 2: dW[s, o, k] and db[s, o] are the splits' partial
// sums added in split order, rounded once to T.
template <typename T>
__global__ void wgrad_finalize_kernel(const typename AccOf<T>::type* __restrict__ part,
                                      const typename AccOf<T>::type* __restrict__ dbpart,
                                      T* __restrict__ dw, T* __restrict__ db,
                                      int S, int splits, int F, int K) {
  typedef typename AccOf<T>::type A;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long fk = (long long)F * K, nw = (long long)S * fk;
  if (i < nw) {
    const long long s = i / fk, r = i - s * fk;
    const A* src = part + s * splits * fk + r;
    A sum = A(0);
    for (int sp = 0; sp < splits; ++sp) sum += src[sp * fk];
    dw[i] = from_acc(sum, (T*)nullptr);
  } else if (i < nw + (long long)S * F) {
    const long long j = i - nw, s = j / F, o = j - s * F;
    const A* src = dbpart + s * splits * F + o;
    A sum = A(0);
    for (int sp = 0; sp < splits; ++sp) sum += src[(long long)sp * F];
    db[j] = from_acc(sum, (T*)nullptr);
  }
}

static_assert(wg_tc::BN == wg_fma::BN, "one K-tile count for both weight-gradient kernels");

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

template <typename T>
int launch_fwd_fma(const void* x, const void* w, const void* bias, void* y, int S, int B, int C,
                   int F, int H, int W, XAddr xa, cudaStream_t st) {
  dim3 grid(cdiv((long long)B * H * W, fwd_fma::BN), cdiv(F, fwd_fma::BM), S);
  fwd_fma_kernel<T><<<grid, fwd_fma::NT, 0, st>>>((const T*)x, (const T*)w, (const T*)bias,
                                                   (T*)y, S, B, C, F, H, W, xa);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad_fma(const void* x, const void* dy, void* part, void* dbpart, void* dw, void* db,
                     int S, int B, int C, int F, int H, int W, int splits, int pix_per_split,
                     XAddr xa, cudaStream_t st) {
  typedef typename AccOf<T>::type A;
  dim3 grid(cdiv(C * 9, wg_fma::BN) * splits, cdiv(F, wg_fma::BM), S);
  wgrad_fma_kernel<T><<<grid, wg_fma::NT, 0, st>>>((const T*)x, (const T*)dy, (A*)part,
                                                    (A*)dbpart, S, B, C, F, H, W, splits,
                                                    pix_per_split, xa);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)S * F * (C * 9 + 1);
  wgrad_finalize_kernel<T><<<cdiv(total, 256), 256, 0, st>>>((const A*)part, (const A*)dbpart,
                                                            (T*)dw, (T*)db, S, splits, F, C * 9);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, S*F, H, W) = conv(x, w) + bias (bias may be null).  Returns a CUDA
// error code, 0 when the launch was accepted.
int gentun_pop_conv3x3_fwd(int dtype, const void* x, const void* w, const void* bias, void* y,
                           int S, int B, int C, int F, int H, int W, long long sstride,
                           long long bstride, void* stream) {
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  XAddr xa{sstride, bstride};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16: {
      dim3 grid(cdiv((long long)B * H * W, fwd_tc::BN), cdiv(F, fwd_tc::BM), S);
      fwd_bf16_kernel<<<grid, fwd_tc::NT, 0, st>>>((const bf16*)x, (const bf16*)w,
                                                   (const bf16*)bias, (bf16*)y, S, B, C, F, H,
                                                   W, xa);
      return (int)cudaGetLastError();
    }
    case kF32: return launch_fwd_fma<float>(x, w, bias, y, S, B, C, F, H, W, xa, st);
    case kF64: return launch_fwd_fma<double>(x, w, bias, y, S, B, C, F, H, W, xa, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dw (S, F, C, 3, 3) and db (S, F) from x and dy (B, S*F, H, W), through the
// scratch buffers part (S, splits, F, C*9) and dbpart (S, splits, F), float
// for bf16 and float32, double for float64.
int gentun_pop_conv3x3_wgrad(int dtype, const void* x, const void* dy, void* part, void* dbpart,
                             void* dw, void* db, int S, int B, int C, int F, int H, int W,
                             int splits, int pix_per_split, long long sstride,
                             long long bstride, void* stream) {
  if (S < 1 || S > 65535 || splits < 1) return (int)cudaErrorInvalidValue;
  if ((long long)cdiv(C * 9, wg_tc::BN) * splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if ((long long)splits * pix_per_split < (long long)B * H * W) return (int)cudaErrorInvalidValue;
  XAddr xa{sstride, bstride};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16: {
      if (pix_per_split % wg_tc::BK) return (int)cudaErrorInvalidValue;
      dim3 grid(cdiv(C * 9, wg_tc::BN) * splits, cdiv(F, wg_tc::BM), S);
      wgrad_bf16_kernel<<<grid, wg_tc::NT, 0, st>>>((const bf16*)x, (const bf16*)dy,
                                                    (float*)part, (float*)dbpart, S, B, C, F, H,
                                                    W, splits, pix_per_split, xa);
      int err = (int)cudaGetLastError();
      if (err) return err;
      const long long total = (long long)S * F * (C * 9 + 1);
      wgrad_finalize_kernel<bf16><<<cdiv(total, 256), 256, 0, st>>>(
          (const float*)part, (const float*)dbpart, (bf16*)dw, (bf16*)db, S, splits, F, C * 9);
      return (int)cudaGetLastError();
    }
    case kF32:
      return launch_wgrad_fma<float>(x, dy, part, dbpart, dw, db, S, B, C, F, H, W, splits,
                                     pix_per_split, xa, st);
    case kF64:
      return launch_wgrad_fma<double>(x, dy, part, dbpart, dw, db, S, B, C, F, H, W, splits,
                                      pix_per_split, xa, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* gentun_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
