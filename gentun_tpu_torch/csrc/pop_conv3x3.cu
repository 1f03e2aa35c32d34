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
// a fixed number of pixel splits (ops/pop_conv.py::wgrad_split, from the
// shape only) into a scratch buffer of partial sums, and a second pass adds
// the splits in order.
//
// Layouts (the port's, NCHW): activations (B, S*C, H, W); weights (S, F, C, 3, 3)
// contiguous (the bf16 forward takes them tap-major, see fwd_hop); bias
// (S, F).  A shared input (the stage-0 image batch, (B, C, H, W)) is read in
// place by every slot: its slot stride in XAddr is 0.
//
// What bounds them (NVIDIA H100 SXM data sheet, 700 W: 989 TFLOP/s bf16,
// 3.35 TB/s, so 295 flops a byte at the ridge): per pixel and slot a conv
// does 2*9*C*F flops on (C+F)*2 bytes of bf16 activations, 9*C*F/(C+F) flops
// a byte: 144 for config #2's stage-0 node conv (C = F = 32), 288 at stage 1
// (64) and 576 at stage 2 (128).  So stage 0 is bound by memory, stage 1
// sits at the ridge and stage 2 is bound by the tensor cores; the stage-0
// entry conv (C = 3) is bound by writing its output.
//
// The bf16 forward (fwd_hop below, which also runs the input gradient and
// eval) keeps a halo tile and the chunk's weights in shared memory, feeds
// mma.sync from them with ldmatrix and pipelines the next chunk's loads
// under the current chunk's MMAs.  ptxas (sm_90a): 128 registers for the
// configuration of 32 channels x 256 pixels (158 on the narrow-row path),
// 175 for 64 x 256 (220 narrow), no spills; 61,568 bytes of shared memory
// per CTA at config #2's stage 0, 61,056 at stage 1, 71,168 at the stage-2
// entry, 158,720 at the stage-2 node (C = 128, chunks of 32).  Measured
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase K): the stage-0 node
// conv at 0.29 of its memory bound, the stage-2 node at 0.23 of its
// tensor-core bound; what bounds it now is the per-CTA prologue (first
// chunk's loads, not overlapped) and, at stage 2, ldmatrix traffic against
// mma.sync's rate.
//
// The bf16 weight gradient (wg_hop below) is the same design turned
// around: per pixel tile of its split, the dY tile and the input's halo
// tile (fwd_hop's loader) in shared memory, two buffers each, the next
// tile's loads under the current tile's MMAs; one ldmatrix of dY feeds the
// MMAs of all 9 taps, each tap's operand is an ldmatrix.trans of the halo
// tile at a shifted position.  ptxas (sm_90a): 163/159 registers (narrow/
// wide path) for 32 x 8 channels (C <= 8), 236/212 for 32 x 32 (F <= 32),
// 246 for 64 x 32, no spills; 46,912 bytes of shared memory per CTA at
// config #2's stage-0 entry, 88,832 at the stage-0 node, 120,576 at stage
// 1, 134,144 at stage 2.  Measured (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py phase K): 8.9 ms per config #2 train step, 0.36x cuDNN's
// grouped weight gradient, 5.2x its bound; the stage-2 node (C = F = 128,
// bound by the tensor cores) is the one shape where cuDNN is faster.
//
// The float32 and float64 kernels (fwd_fma, wgrad_fma) are the first
// design: implicit GEMMs with a tile in shared memory, no pipelining,
// im2col index arithmetic per element, plain FMA loops (IEEE float32, and
// float64), bound by the latency of their global loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// bf16: halo tiles in shared memory and mma.sync on the tensor cores.
//
// A CTA computes one slot s, BM output channels and one pixel tile: NI whole
// images (small images), or TH rows x TW columns of one image.  It walks the
// input channels in chunks of CK.  For each chunk the halo tile (the tile's
// pixels and a one-pixel border, zero outside the image) and the chunk's
// weights of all 9 taps land in shared memory once; each tap then reads a
// shifted window of that one tile, so no input value is fetched per tap and
// no index needs a divide in the K loop.  The tile is stored channel-
// innermost (a pixel's CK channels in 16-byte chunks, padded), so a shift by
// a pixel moves an operand by whole 16-byte chunks and ldmatrix feeds
// mma.m16n8k16 (bf16 in, float accumulator) at any shift.  Two buffers of
// each: while the MMAs run on chunk i, chunk i+1's activations are in flight
// into registers (16-byte loads along W, transposed into the tile on the
// store) and its weights by cp.async.  The weights come tap-major,
// (S, 9, F, Cp) with Cp = C rounded up to 8 and zero-padded, as
// ops/pop_conv.py lays them out.  Each output's sum runs over the chunks in
// order, the taps in order, then the chunk's channels: fixed by C alone.
// ---------------------------------------------------------------------------

namespace fwd_hop {

constexpr int NT = 256;  // 8 warps

// The CTA's tile shape for one (BM, BN, warp layout, CK) configuration.
template <int BM_, int BN_, int WARPS_M_, int CK_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, CK = CK_;
  static constexpr int WARPS_N = NT / 32 / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's tile
  static constexpr int MT = WM / 16, NT8 = WN / 8;            // its m16 and n8 blocks
  static constexpr int KO = CK / 8;      // 16-byte chunks of channels per pixel
  static constexpr int SC = KO + 1;      // a pixel's pitch in chunks (odd: no bank conflicts)
  static constexpr int HALO_MAX = NT * 8 / KO;  // halo pixels per buffer
  static constexpr int WCHUNKS = 9 * BM * SC;   // weight chunks per buffer
  static constexpr int SCALAR_IT = KO * HALO_MAX / NT;  // halo chunks per thread, narrow path
  static_assert(WM % 16 == 0 && WN % 16 == 0 && CK % 16 == 0, "warp tile");
};

// The pixel tile and its halo, computed on the host from (B, H, W) alone.
struct Geo {
  int ni, th, tw;        // images, output rows, output columns per tile
  int rowc;              // a halo row's pitch in 16-byte chunks
  int tiles_h, tiles_w;  // tiles per image along H and W
  int hchunks;           // chunks of one halo buffer
  long long tiles;       // tiles per slot
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w));
}

__device__ __forceinline__ uint32_t bf16_bits(bf16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A halo tile of K::KO 16-byte chunks of channels per pixel (channel-
// innermost: [image][halo row][halo column][chunk], a pixel's pitch K::SC
// chunks, a row's g.rowc), for one pixel tile with origin (b0, h0, w0) and
// the channels c0.., staged in registers by load() and written to shared
// memory by store(), so the loads can be in flight under other work.  Wide
// path (VEC: whole rows, W a multiple of 8): an item is 8 channels x 8
// pixels of one halo row, eight 16-byte loads along W, transposed on the
// store by __byte_perm.  Narrow path: an item is 8 channels of one halo
// pixel, eight 2-byte loads; it writes every halo pixel, zero outside the
// image.  Items run channel chunk fastest, so the stores of a quarter warp
// land in distinct banks.  Channels >= C load as zero.  The wide path never
// writes the border columns (they stay as the buffer was zeroed); rows and
// images outside the image are skipped, or written as zeros when ZERO_ROWS
// (a buffer that holds tiles of other origins in turn).
template <class K, bool VEC, bool ZERO_ROWS>
struct HaloStage {
  static constexpr int NREG = VEC ? 8 : K::SCALAR_IT;
  uint4 st[NREG];
  int vpos;  // wide path: the item's first chunk in the tile, -1 if none

  __device__ __forceinline__ void load(const bf16* __restrict__ xs, long long bstride, int B,
                                       int C, int H, int W, const Geo& g, int b0, int h0, int w0,
                                       int c0, int tid) {
    const int HW = H * W, hrows = g.th + 2, hcols = g.tw + 2;
    if constexpr (VEC) {
      const int qn = W >> 3, items = g.ni * hrows * qn * K::KO;
      vpos = -1;
      if (tid < items) {
        int t = tid;
        const int co = t % K::KO;
        t /= K::KO;
        const int r = t % hrows;
        t /= hrows;
        const int i = t % g.ni, q = t / g.ni;
        const int b = b0 + i, h = h0 + r - 1;
        const bool in = b < B && h >= 0 && h < H;
        if (in) {
          const int c = c0 + co * 8;
          const bf16* src = xs + (long long)b * bstride + (long long)c * HW + h * W + q * 8;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            st[j] = c + j < C ? __ldg(reinterpret_cast<const uint4*>(src + (long long)j * HW))
                              : make_uint4(0, 0, 0, 0);
        } else if constexpr (ZERO_ROWS) {
#pragma unroll
          for (int j = 0; j < 8; ++j) st[j] = make_uint4(0, 0, 0, 0);
        }
        if (in || ZERO_ROWS) vpos = (i * hrows + r) * g.rowc + (1 + q * 8) * K::SC + co;
      }
    } else {
      const int items = g.ni * hrows * hcols * K::KO;
#pragma unroll
      for (int k = 0; k < NREG; ++k) {
        const int it = tid + k * NT;
        uint32_t v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0;
        if (it < items) {
          const int co = it % K::KO, p = it / K::KO;
          const int cc = p % hcols, t = p / hcols, r = t % hrows, i = t / hrows;
          const int b = b0 + i, h = h0 + r - 1, ww = w0 + cc - 1;
          if (b < B && h >= 0 && h < H && ww >= 0 && ww < W) {
            const int c = c0 + co * 8;
            const bf16* src = xs + (long long)b * bstride + (long long)c * HW + h * W + ww;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (c + j < C) v[j] = bf16_bits(src[(long long)j * HW]);
          }
        }
        st[k] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                           v[6] | v[7] << 16);
      }
    }
  }

  __device__ __forceinline__ void store(uint32_t hb, const Geo& g, int tid) const {
    if constexpr (VEC) {
      if (vpos < 0) return;
#pragma unroll
      for (int p = 0; p < 8; ++p) {  // st[channel] holds pixels 0..7; o holds channels 0..7
        const uint32_t sel = (p & 1) ? 0x7632 : 0x5410;
        const int wd = p >> 1;
        const uint4 o = make_uint4(__byte_perm(word(st[0], wd), word(st[1], wd), sel),
                                   __byte_perm(word(st[2], wd), word(st[3], wd), sel),
                                   __byte_perm(word(st[4], wd), word(st[5], wd), sel),
                                   __byte_perm(word(st[6], wd), word(st[7], wd), sel));
        sts128(hb + (uint32_t)(vpos + p * K::SC) * 16, o);
      }
    } else {
      const int hrows = g.th + 2, hcols = g.tw + 2, items = g.ni * hrows * hcols * K::KO;
#pragma unroll
      for (int k = 0; k < NREG; ++k) {
        const int it = tid + k * NT;
        if (it < items) {
          const int co = it % K::KO, p = it / K::KO;
          const int cc = p % hcols, t = p / hcols, r = t % hrows, i = t / hrows;
          sts128(hb + (uint32_t)((i * hrows + r) * g.rowc + cc * K::SC + co) * 16, st[k]);
        }
      }
    }
  }
};

template <class K, bool VEC>
__global__ void __launch_bounds__(NT)
fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, bf16* __restrict__ y,
                int S, int B, int C, int F, int H, int W, XAddr xa, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mblocks = (F + K::BM - 1) / K::BM;
  const int mb = (int)(blockIdx.x % (unsigned)mblocks);
  long long tile = blockIdx.x / (unsigned)mblocks;
  const int twi = (int)(tile % g.tiles_w);
  tile /= g.tiles_w;
  const int thi = (int)(tile % g.tiles_h);
  const int b0 = (int)(tile / g.tiles_h) * g.ni, h0 = thi * g.th, w0 = twi * g.tw;
  const int s = blockIdx.z, m0 = mb * K::BM;
  const int HW = H * W, Cp = (C + 7) & ~7, hrows = g.th + 2;
  const int tile_pix = g.ni * g.th * g.tw, nch = (C + K::CK - 1) / K::CK;

  // Shared memory: weights [2][9][BM][SC chunks], then halo tiles [2][hchunks].
  const uint32_t wsm = smem_u32(smem), hsm = wsm + 2 * K::WCHUNKS * 16;
  const uint32_t hbytes = (uint32_t)g.hchunks * 16;
  {  // zero the halo buffers: what the loads never write is the zero border
    uint4* hz = reinterpret_cast<uint4*>(smem + 2 * K::WCHUNKS * 16);
    for (int i = tid; i < 2 * g.hchunks; i += NT) hz[i] = make_uint4(0, 0, 0, 0);
  }

  // Each lane's ldmatrix row addresses (bytes, relative to a buffer, tap 0).
  const int wm0 = (warp / K::WARPS_N) * K::WM, wn0 = (warp % K::WARPS_N) * K::WN;
  uint32_t aoff[K::MT], boff[K::NT8 / 2];
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt) {
    const int row = wm0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    aoff[mt] = (uint32_t)(row * K::SC + (lane >> 4)) * 16;
  }
#pragma unroll
  for (int j2 = 0; j2 < K::NT8 / 2; ++j2) {
    const int n = wn0 + j2 * 16 + (lane >> 4) * 8 + (lane & 7);
    int pos = 0;  // pixels past the tile read position 0; their outputs are dropped
    if (n < tile_pix) {
      const int i = n / (g.th * g.tw), rem = n - i * g.th * g.tw, r = rem / g.tw;
      pos = (i * hrows + r) * g.rowc + (rem - r * g.tw) * K::SC;
    }
    boff[j2] = (uint32_t)(pos + ((lane >> 3) & 1)) * 16;
  }

  // Activations of one chunk, staged in registers (HaloStage).
  const bf16* xs = x + xa.slot_base(s);
  HaloStage<K, VEC, false> act;
  auto load_act = [&](int ch) {
    act.load(xs, xa.bstride, B, C, H, W, g, b0, h0, w0, ch * K::CK, tid);
  };
  auto store_act = [&](uint32_t hb) { act.store(hb, g, tid); };

  // The chunk's weights of all 9 taps, [tap][m][channel], by cp.async.
  const bf16* wsl = w + (long long)s * 9 * F * Cp;
  auto load_w = [&](int ch, uint32_t wb) {
    const int c0 = ch * K::CK;
    for (int i = tid; i < 9 * K::BM * K::KO; i += NT) {
      const int co = i % K::KO, t = i / K::KO, m = t % K::BM, tap = t / K::BM;
      const int c = c0 + co * 8;
      const bool ok = m0 + m < F && c < Cp;
      const bf16* src = ok ? wsl + ((long long)tap * F + m0 + m) * Cp + c : w;
      cp_async16(wb + (uint32_t)((tap * K::BM + m) * K::SC + co) * 16, src, ok);
    }
    cp_async_commit();
  };

  float acc[K::MT][K::NT8][4];
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < K::NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  __syncthreads();  // the zeroed halo before any load writes into it
  load_act(0);
  load_w(0, wsm);
  store_act(hsm);
  cp_async_wait_all();
  __syncthreads();
  for (int ch = 0; ch < nch; ++ch) {
    const int cur = ch & 1;
    const bool more = ch + 1 < nch;
    if (more) {  // the next chunk in flight while this one computes
      load_act(ch + 1);
      load_w(ch + 1, wsm + (cur ^ 1) * K::WCHUNKS * 16);
    }
    const uint32_t wb = wsm + cur * K::WCHUNKS * 16, hb = hsm + cur * hbytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t wt = wb + (uint32_t)(tap * K::BM * K::SC) * 16;
      const uint32_t ht = hb + (uint32_t)((tap / 3) * g.rowc + (tap % 3) * K::SC) * 16;
#pragma unroll
      for (int kk = 0; kk < K::KO / 2; ++kk) {
        uint32_t a[K::MT][4], b[K::NT8][2];
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt)
          ldsm_x4(wt + aoff[mt] + kk * 32, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
#pragma unroll
        for (int j2 = 0; j2 < K::NT8 / 2; ++j2)
          ldsm_x4(ht + boff[j2] + kk * 32, b[2 * j2][0], b[2 * j2][1], b[2 * j2 + 1][0],
                  b[2 * j2 + 1][1]);
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < K::NT8; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
    }
    if (more) {
      store_act(hsm + (cur ^ 1) * hbytes);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // Epilogue: round to bf16, add the bias in bf16 (epilogue()), stage the
  // tile in shared memory as [m][pixel], then store along W.
  constexpr int LDC = K::BN + 8;
  bf16* cs = reinterpret_cast<bf16*>(smem);
  const bf16* bs = bias ? bias + (long long)s * F : nullptr;
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wm0 + mt * 16 + (lane >> 2) + half * 8;
      const bf16* bm = m0 + m < F ? bs : nullptr;
#pragma unroll
      for (int nt = 0; nt < K::NT8; ++nt) {
        const int n = wn0 + nt * 8 + (lane & 3) * 2;
        __nv_bfloat162 v;
        v.x = epilogue(acc[mt][nt][2 * half], bm, m0 + m);
        v.y = epilogue(acc[mt][nt][2 * half + 1], bm, m0 + m);
        *reinterpret_cast<__nv_bfloat162*>(cs + m * LDC + n) = v;
      }
    }
  }
  __syncthreads();
  bf16* ys = y + (long long)s * F * HW;
  const long long ybstride = (long long)S * F * HW;
  if constexpr (VEC) {  // whole rows, W a multiple of 8: 8 pixels of one row per store
    for (int it = tid; it < K::BM * (K::BN / 8); it += NT) {
      const int m = it / (K::BN / 8), n = (it - m * (K::BN / 8)) * 8;
      if (m0 + m >= F || n >= tile_pix) continue;
      const int i = n / (g.th * W), rem = n - i * g.th * W, r = rem / W;
      const int b = b0 + i, h = h0 + r;
      if (b >= B || h >= H) continue;
      *reinterpret_cast<uint4*>(ys + b * ybstride + (long long)(m0 + m) * HW + h * W + rem -
                                r * W) = *reinterpret_cast<const uint4*>(cs + m * LDC + n);
    }
  } else {
    for (int it = tid; it < K::BM * K::BN; it += NT) {
      const int m = it / K::BN, n = it - m * K::BN;
      if (m0 + m >= F || n >= tile_pix) continue;
      const int i = n / (g.th * g.tw), rem = n - i * g.th * g.tw, r = rem / g.tw;
      const int b = b0 + i, h = h0 + r, ww = w0 + rem - r * g.tw;
      if (b >= B || h >= H || ww >= W) continue;
      ys[b * ybstride + (long long)(m0 + m) * HW + h * W + ww] = cs[m * LDC + n];
    }
  }
}

template <class K>
Geo geometry(int B, int H, int W) {
  Geo g;
  g.tw = W < K::BN ? W : K::BN;
  g.th = H < K::BN / g.tw ? H : K::BN / g.tw;
  g.ni = 1;
  if (g.th == H && g.tw == W) {
    g.ni = K::BN / (H * W);
    if (g.ni > B) g.ni = B;
    if (g.ni < 1) g.ni = 1;
  }
  auto halo = [&] { return g.ni * (g.th + 2) * (g.tw + 2); };
  while (g.ni > 1 && halo() > K::HALO_MAX) --g.ni;
  while (g.th > 1 && halo() > K::HALO_MAX) --g.th;
  while (g.tw > 1 && halo() > K::HALO_MAX) --g.tw;
  // A halo row's pitch: a pixel's pitch is odd, and successive rows start
  // KO chunks apart modulo 8, so a quarter warp's stores (KO chunks of
  // 8 / KO rows) hit distinct banks.
  g.rowc = (g.tw + 2) * K::SC;
  while (g.rowc % 8 != K::KO % 8) ++g.rowc;
  g.tiles_h = (H + g.th - 1) / g.th;
  g.tiles_w = (W + g.tw - 1) / g.tw;
  g.tiles = (long long)((B + g.ni - 1) / g.ni) * g.tiles_h * g.tiles_w;
  g.hchunks = g.ni * (g.th + 2) * g.rowc;
  return g;
}

template <class K>
int launch(const bf16* x, const bf16* w, const bf16* bias, bf16* y, int S, int B, int C, int F,
           int H, int W, XAddr xa, cudaStream_t st) {
  const Geo g = geometry<K>(B, H, W);
  const long long blocks = g.tiles * ((F + K::BM - 1) / K::BM);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int halo_smem = (2 * K::WCHUNKS + 2 * g.hchunks) * 16, out_smem = K::BM * (K::BN + 8) * 2;
  const int smem = halo_smem > out_smem ? halo_smem : out_smem;
  const bool vec = g.tw == W && W % 8 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)y & 15) == 0;
  auto kernel = vec ? fwd_bf16_kernel<K, true> : fwd_bf16_kernel<K, false>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kernel<<<dim3((unsigned)blocks, 1, S), NT, smem, st>>>(x, w, bias, y, S, B, C, F, H, W, xa, g);
  return (int)cudaGetLastError();
}

// The configurations, and the one a shape takes.  The choice reads the shape
// only, never S: it fixes CK, and so every output's sum order.  At config
// #2's shapes (tools/tune_pop_conv.py) 32 channels x 256 pixels in chunks of
// 16 channels is the faster below C = 128 and 64 x 256 in chunks of 32 at
// C = 128; five other tile shapes were slower at every shape.
typedef int (*Launcher)(const bf16*, const bf16*, const bf16*, bf16*, int, int, int, int, int,
                        int, XAddr, cudaStream_t);
const Launcher kConfigs[] = {
    launch<Cfg<32, 256, 1, 16>>,  // 0
    launch<Cfg<64, 256, 2, 32>>,  // 1
};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

int pick(int C, int F, int H, int W) {
  (void)F, (void)H, (void)W;
  return C >= 128 ? 1 : 0;
}

}  // namespace fwd_hop

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
//   part[s, sp, o, c*9 + tap] = sum over the split's pixels p of dY[o, p] * x[c, p shifted by tap]
//   dbpart[s, sp, o]          = sum over the split's pixels p of dY[o, p]
// (k = c*9 + kh*3 + kw, the weight's order).  A split is a run of whole
// images for bf16 and of pixels for float32 and float64, its size set by
// ops/pop_conv.py::wgrad_split from the shape alone.
// ---------------------------------------------------------------------------

// bf16: the forward's halo tiles turned around, the reduction running over
// pixels instead of channels.
//
// A CTA takes one slot s, BM output channels, CN input channels with all 9
// taps, and one split.  It walks the split's pixel tiles in order: the
// tiles of fwd_hop::geometry (whole rows of one image, or whole small
// images).  Per tile, the dY tile [BM][tile pixels] (NCHW's own order,
// 16-byte cp.async along W) and the input's halo tile (channel-innermost,
// fwd_hop::HaloStage, zero border) land in shared memory, two buffers each,
// and the next tile's loads are in flight while the current tile's MMAs run.
// mma.m16n8k16 (bf16 in, float accumulator) runs with k over pixels: the A
// fragment (dY) comes by ldmatrix once per k16 step and serves all 9 taps;
// each tap's B fragment comes by ldmatrix.trans from the halo tile, each
// lane's row address its pixel's position plus the tap's offset, so a shift
// by a pixel moves an operand by whole 16-byte chunks and costs nothing.
// Each lane's positions are computed once per CTA (every tile of a split
// has the same layout), so the loop does no divides.  db is the same A
// fragments times a fragment of ones.  The warps split the CTA's BM x CN
// tile and, where that is small, the k16 steps of a tile (WARPS_K groups,
// added in group order at the end).  The accumulators (9 x BM x CN floats)
// stay in registers for the whole split.  Every sum's order is fixed by the
// configuration (pick: C and F) and the split (the shape), never by S.
// ---------------------------------------------------------------------------

namespace wg_hop {

using fwd_hop::Geo;
using fwd_hop::NT;

// The CTA's tile for one (BM, CN, warp layout) configuration.
template <int BM_, int CN_, int WARPS_M_, int WARPS_N_>
struct Cfg {
  static constexpr int BM = BM_, CN = CN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int WARPS_K = NT / 32 / (WARPS_M * WARPS_N);  // groups sharing the k16 steps
  static constexpr int WM = BM / WARPS_M, WN = CN / WARPS_N;     // a warp's tile, per tap
  static constexpr int MT = WM / 16, NT8 = WN / 8;               // its m16 and n8 blocks
  static constexpr int BN = 256;                                  // pixels per tile
  static constexpr int KPW = BN / 16 / WARPS_K;                   // a warp's k16 steps per tile
  static constexpr int KO = CN / 8;       // 16-byte chunks of channels per halo pixel
  static constexpr int SC = KO | 1;       // a halo pixel's pitch in chunks (odd: no bank conflicts)
  static constexpr int HALO_MAX = NT * 8 / KO;          // halo pixels per buffer
  static constexpr int SCALAR_IT = KO * HALO_MAX / NT;  // halo chunks per thread, narrow path
  static constexpr int LDA = BN + 8;      // a dY row's pitch in elements: 33 chunks (odd)
  static constexpr int DY_BYTES = BM * LDA * 2;
  static constexpr int DY_IT = BM * BN / 8 / NT;  // 16-byte dY chunks per thread and tile
  static constexpr int RP = CN * 9 + 4;   // a row's pitch in the reduction buffer (floats)
  static constexpr int RED_BYTES = WARPS_K * BM * (RP + 1) * 4;
  static_assert(WARPS_K >= 1 && WARPS_M * WARPS_N * WARPS_K * 32 == NT, "warp layout");
  static_assert(WM % 16 == 0 && WN % 8 == 0 && (NT8 == 1 || NT8 % 2 == 0), "warp tile");
  static_assert(CN % 8 == 0 && BM * BN / 8 % NT == 0, "tile");
};

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

template <class K, bool VEC>
__global__ void __launch_bounds__(NT)
wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  float* __restrict__ part, float* __restrict__ dbpart,
                  int S, int B, int C, int F, int H, int W, int splits, int ips, XAddr xa, Geo g) {
  using fwd_hop::cp_async16;
  using fwd_hop::ldsm_x4;
  using fwd_hop::mma_bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // blockIdx.x = (split * mblocks + m block) * nblocks + n block: the CTAs
  // of one split, which read the same pixels, run side by side.
  const int mblocks = (F + K::BM - 1) / K::BM, nblocks = (C + K::CN - 1) / K::CN;
  unsigned bx = blockIdx.x;
  const int nb = (int)(bx % (unsigned)nblocks);
  bx /= (unsigned)nblocks;
  const int mb = (int)(bx % (unsigned)mblocks), sp = (int)(bx / (unsigned)mblocks);
  const int s = blockIdx.z, m0 = mb * K::BM, c0 = nb * K::CN;
  const int HW = H * W, bfirst = sp * ips, bend = B < bfirst + ips ? B : bfirst + ips;
  const int tiles_img = g.tiles_h * g.tiles_w;
  const int ntiles = (bend - bfirst + g.ni - 1) / g.ni * tiles_img;
  const int tile_pix = g.ni * g.th * g.tw, hrows = g.th + 2;

  // Shared memory: dY tiles [2][BM][LDA], then halo tiles [2][hchunks].
  const uint32_t dsm = fwd_hop::smem_u32(smem), hsm = dsm + 2 * K::DY_BYTES;
  const uint32_t hbytes = (uint32_t)g.hchunks * 16;
  {  // zero both: what no load writes (pixels past the tile, the halo's
     // border columns) must read as zero
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n16 = 2 * K::DY_BYTES / 16 + 2 * g.hchunks;
    for (int i = tid; i < n16; i += NT) z[i] = make_uint4(0, 0, 0, 0);
  }

  // The warp's place, and each lane's ldmatrix row addresses (bytes,
  // relative to a buffer): A at k16 step 0, B at each of its k16 steps, tap 0.
  const int kg = warp / (K::WARPS_M * K::WARPS_N), wmn = warp % (K::WARPS_M * K::WARPS_N);
  const int wm0 = (wmn / K::WARPS_N) * K::WM, wn0 = (wmn % K::WARPS_N) * K::WN;
  uint32_t aoff[K::MT], poff[K::KPW];
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt) {
    const int row = wm0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    aoff[mt] = (uint32_t)(row * K::LDA + (lane >> 4) * 8) * 2;
  }
#pragma unroll
  for (int j = 0; j < K::KPW; ++j) {
    const int n = (kg + j * K::WARPS_K) * 16 + (lane & 15);
    int pos = 0;  // pixels past the tile read position 0; their dY is zero
    if (n < tile_pix) {
      const int i = n / (g.th * g.tw), rem = n - i * g.th * g.tw, r = rem / g.tw;
      pos = (i * hrows + r) * g.rowc + (rem - r * g.tw) * K::SC;
    }
    poff[j] = (uint32_t)(pos + wn0 / 8 + (lane >> 4)) * 16;
  }

  const bf16* xs = x + xa.slot_base(s);
  const bf16* dys = dy + (long long)s * F * HW;
  const long long dyb = (long long)S * F * HW;
  auto origin = [&](int t, int& b0, int& h0, int& w0) {
    const int ig = t / tiles_img, rem = t - ig * tiles_img, thi = rem / g.tiles_w;
    b0 = bfirst + ig * g.ni;
    h0 = thi * g.th;
    w0 = (rem - thi * g.tiles_w) * g.tw;
  };
  fwd_hop::HaloStage<K, VEC, true> act;
  auto load_x = [&](int t) {
    int b0, h0, w0;
    origin(t, b0, h0, w0);
    act.load(xs, xa.bstride, bend, C, H, W, g, b0, h0, w0, c0, tid);
  };
  // dY of tile t.  Wide path: cp.async 16 bytes (8 pixels of a row) at a
  // time, zero-filled outside the image; committed as one group.  Narrow
  // path: 2-byte loads stored at once.
  auto load_dy = [&](int t, uint32_t dbuf) {
    int b0, h0, w0;
    origin(t, b0, h0, w0);
    if constexpr (VEC) {  // whole rows: an image's part of the tile is one run of th*W pixels
      const int run = g.th * W;
#pragma unroll
      for (int k = 0; k < K::DY_IT; ++k) {
        const int it = tid + k * NT, m = it / (K::BN / 8), n = (it - m * (K::BN / 8)) * 8;
        if (n >= tile_pix) continue;
        const int i = n / run, rem = n - i * run;
        const int b = b0 + i;
        const bool ok = b < bend && h0 + rem / W < H && m0 + m < F;
        const bf16* src =
            ok ? dys + b * dyb + (long long)(m0 + m) * HW + h0 * W + rem : dy;
        fwd_hop::cp_async16(dbuf + (uint32_t)(m * K::LDA + n) * 2, src, ok);
      }
      fwd_hop::cp_async_commit();
    } else {
      bf16* dst = reinterpret_cast<bf16*>(smem + (dbuf - dsm));
      const int tpi = g.th * g.tw;
      for (int it = tid; it < K::BM * K::BN; it += NT) {
        const int m = it / K::BN, n = it - m * K::BN;
        if (n >= tile_pix) continue;
        const int i = n / tpi, rem = n - i * tpi, r = rem / g.tw;
        const int b = b0 + i, h = h0 + r, ww = w0 + rem - r * g.tw;
        bf16 v = zero_of<bf16>();
        if (b < bend && h < H && ww < W && m0 + m < F)
          v = dys[b * dyb + (long long)(m0 + m) * HW + h * W + ww];
        dst[m * K::LDA + n] = v;
      }
    }
  };

  float acc[9][K::MT][K::NT8][4], dacc[K::MT][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < K::NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[tap][mt][nt][e] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[mt][e] = 0.0f;
  const bool do_db = nb == 0 && wn0 == 0;  // warp-uniform
  const uint32_t ones[2] = {0x3F803F80u, 0x3F803F80u};  // bf16 1.0 pairs
  const uint32_t rowb = (uint32_t)g.rowc * 16;

  __syncthreads();  // the zeroed buffers before any load writes into them
  if (VEC) load_dy(0, dsm);
  load_x(0);
  act.store(hsm, g, tid);
  if (!VEC) load_dy(0, dsm);
  fwd_hop::cp_async_wait_all();
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < ntiles;
    if (more) {  // the next tile in flight while this one computes
      if (VEC) load_dy(t + 1, dsm + (cur ^ 1) * K::DY_BYTES);
      load_x(t + 1);
    }
    const uint32_t dbuf = dsm + cur * K::DY_BYTES, hbuf = hsm + cur * hbytes;
#pragma unroll
    for (int j = 0; j < K::KPW; ++j) {
      const int ks = kg + j * K::WARPS_K;
      if (ks * 16 >= tile_pix) break;
      uint32_t a[K::MT][4];
#pragma unroll
      for (int mt = 0; mt < K::MT; ++mt)
        ldsm_x4(dbuf + aoff[mt] + ks * 32, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
      if (do_db) {
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt) mma_bf16(dacc[mt], a[mt], ones);
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t bt = hbuf + poff[j] + (tap / 3) * rowb + (tap % 3) * (K::SC * 16);
        uint32_t b[K::NT8][2];
        if constexpr (K::NT8 == 1) {
          ldsm_x2_trans(bt, b[0][0], b[0][1]);
        } else {
#pragma unroll
          for (int j2 = 0; j2 < K::NT8 / 2; ++j2)
            ldsm_x4_trans(bt + j2 * 32, b[2 * j2][0], b[2 * j2][1], b[2 * j2 + 1][0],
                          b[2 * j2 + 1][1]);
        }
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < K::NT8; ++nt) mma_bf16(acc[tap][mt][nt], a[mt], b[nt]);
      }
    }
    if (more) {
      act.store(hsm + (cur ^ 1) * hbytes, g, tid);
      if (!VEC) load_dy(t + 1, dsm + (cur ^ 1) * K::DY_BYTES);
      fwd_hop::cp_async_wait_all();
    }
    __syncthreads();
  }

  // Each warp group's sums into shared memory ([group][m][n*9 + tap], db
  // after them), then added over the groups in order and written out: a
  // row of the CTA's m is CN*9 consecutive floats of part.
  float* red = reinterpret_cast<float*>(smem);
  float* redb = red + K::WARPS_K * K::BM * K::RP;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < K::NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = wm0 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
          const int n = wn0 + nt * 8 + (lane & 3) * 2 + (e & 1);
          red[(kg * K::BM + m) * K::RP + n * 9 + tap] = acc[tap][mt][nt][e];
        }
  if (do_db && (lane & 3) == 0) {
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        redb[kg * K::BM + wm0 + mt * 16 + (lane >> 2) + half * 8] = dacc[mt][2 * half];
  }
  __syncthreads();
  const long long row = (long long)s * splits + sp;
  const int KC = C * 9;
  float* out = part + row * F * KC + (long long)m0 * KC + c0 * 9;
  for (int it = tid; it < K::BM * K::CN * 9; it += NT) {
    const int m = it / (K::CN * 9), q = it - m * (K::CN * 9);
    if (m0 + m >= F || c0 + q / 9 >= C) continue;
    float v = red[m * K::RP + q];
#pragma unroll
    for (int k = 1; k < K::WARPS_K; ++k) v += red[(k * K::BM + m) * K::RP + q];
    out[(long long)m * KC + q] = v;
  }
  if (nb == 0 && tid < K::BM && m0 + tid < F) {
    float v = redb[tid];
#pragma unroll
    for (int k = 1; k < K::WARPS_K; ++k) v += redb[k * K::BM + tid];
    dbpart[row * F + m0 + tid] = v;
  }
}

}  // namespace wg_hop

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

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

namespace wg_hop {

// Pass 1 in configuration K, then pass 2.  pix_per_split is whole images.
template <class K>
int launch(const bf16* x, const bf16* dy, float* part, float* dbpart, bf16* dw, bf16* db, int S,
           int B, int C, int F, int H, int W, int splits, int pix_per_split, XAddr xa,
           cudaStream_t st) {
  const int HW = H * W, ips = pix_per_split / HW;
  if (pix_per_split % HW || (long long)(splits - 1) * ips >= B) return (int)cudaErrorInvalidValue;
  const Geo g = fwd_hop::geometry<K>(ips, H, W);
  const long long blocks = (long long)splits * cdiv(F, K::BM) * cdiv(C, K::CN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int loop_smem = 2 * K::DY_BYTES + 2 * g.hchunks * 16;
  const int smem = loop_smem > K::RED_BYTES ? loop_smem : K::RED_BYTES;
  const bool vec = g.tw == W && W % 8 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)dy & 15) == 0;
  auto kernel = vec ? wgrad_bf16_kernel<K, true> : wgrad_bf16_kernel<K, false>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kernel<<<dim3((unsigned)blocks, 1, S), NT, smem, st>>>(x, dy, part, dbpart, S, B, C, F, H, W,
                                                           splits, ips, xa, g);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)S * F * (C * 9 + 1);
  wgrad_finalize_kernel<bf16><<<cdiv(total, 256), 256, 0, st>>>(part, dbpart, dw, db, S, splits,
                                                                 F, C * 9);
  return (int)cudaGetLastError();
}

// The configurations, and the one a shape takes.  The choice reads the shape
// only, never S: it fixes the warp layout, and so every sum's order.
// (BM, CN, warps along m, warps along n; the rest of the 8 warps share the
// k16 steps.)  At config #2's shapes (tools/tune_pop_conv.py) each is the
// fastest where pick takes it, within 4%; 32 x 32 with one warp per m16 x n8
// block and 64 x 64 (144 accumulators a thread, spilled) were slower at
// every shape.
typedef int (*Launcher)(const bf16*, const bf16*, float*, float*, bf16*, bf16*, int, int, int,
                        int, int, int, int, int, XAddr, cudaStream_t);
const Launcher kConfigs[] = {
    launch<Cfg<32, 8, 2, 1>>,   // 0: C <= 8; 4 groups share the k16 steps
    launch<Cfg<32, 32, 1, 4>>,  // 1: F <= 32; 2 groups
    launch<Cfg<64, 32, 2, 4>>,  // 2
};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

int pick(int C, int F, int H, int W) {
  (void)H, (void)W;
  return C <= 8 ? 0 : F <= 32 ? 1 : 2;
}

}  // namespace wg_hop

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
  if ((long long)cdiv(C * 9, wg_fma::BN) * splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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

// y (B, S*F, H, W) = conv(x, w) + bias (bias may be null).  w is (S, F, C, 3, 3)
// for float32 and float64, and tap-major (S, 9, F, Cp), Cp = C rounded up to
// 8, zero-padded, for bf16.  Returns a CUDA error code, 0 when the launch was
// accepted.
int gentun_pop_conv3x3_fwd(int dtype, const void* x, const void* w, const void* bias, void* y,
                           int S, int B, int C, int F, int H, int W, long long sstride,
                           long long bstride, void* stream) {
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  XAddr xa{sstride, bstride};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return fwd_hop::kConfigs[fwd_hop::pick(C, F, H, W)](
          (const bf16*)x, (const bf16*)w, (const bf16*)bias, (bf16*)y, S, B, C, F, H, W, xa, st);
    case kF32: return launch_fwd_fma<float>(x, w, bias, y, S, B, C, F, H, W, xa, st);
    case kF64: return launch_fwd_fma<double>(x, w, bias, y, S, B, C, F, H, W, xa, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 forward in configuration cfg of fwd_hop::kConfigs (cfg < 0: the
// one gentun_pop_conv3x3_fwd picks), for timing the configurations against
// each other; the arguments are gentun_pop_conv3x3_fwd's.  Returns -1 when
// there is no configuration cfg.
int gentun_pop_conv3x3_fwd_bf16_config(int cfg, const void* x, const void* w, const void* bias,
                                       void* y, int S, int B, int C, int F, int H, int W,
                                       long long sstride, long long bstride, void* stream) {
  if (cfg >= fwd_hop::kNumConfigs) return -1;
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  if (cfg < 0) cfg = fwd_hop::pick(C, F, H, W);
  return fwd_hop::kConfigs[cfg]((const bf16*)x, (const bf16*)w, (const bf16*)bias, (bf16*)y, S,
                                B, C, F, H, W, XAddr{sstride, bstride}, (cudaStream_t)stream);
}

// Which configuration gentun_pop_conv3x3_fwd takes for a bf16 shape.
int gentun_pop_conv3x3_fwd_bf16_pick(int C, int F, int H, int W) {
  return fwd_hop::pick(C, F, H, W);
}

// dw (S, F, C, 3, 3) and db (S, F) from x and dy (B, S*F, H, W), through the
// scratch buffers part (S, splits, F, C*9) and dbpart (S, splits, F), float
// for bf16 and float32, double for float64.
int gentun_pop_conv3x3_wgrad(int dtype, const void* x, const void* dy, void* part, void* dbpart,
                             void* dw, void* db, int S, int B, int C, int F, int H, int W,
                             int splits, int pix_per_split, long long sstride,
                             long long bstride, void* stream) {
  if (S < 1 || S > 65535 || splits < 1) return (int)cudaErrorInvalidValue;
  if ((long long)splits * pix_per_split < (long long)B * H * W) return (int)cudaErrorInvalidValue;
  XAddr xa{sstride, bstride};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return wg_hop::kConfigs[wg_hop::pick(C, F, H, W)](
          (const bf16*)x, (const bf16*)dy, (float*)part, (float*)dbpart, (bf16*)dw, (bf16*)db, S,
          B, C, F, H, W, splits, pix_per_split, xa, st);
    case kF32:
      return launch_wgrad_fma<float>(x, dy, part, dbpart, dw, db, S, B, C, F, H, W, splits,
                                     pix_per_split, xa, st);
    case kF64:
      return launch_wgrad_fma<double>(x, dy, part, dbpart, dw, db, S, B, C, F, H, W, splits,
                                      pix_per_split, xa, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 weight gradient in configuration cfg of wg_hop::kConfigs (cfg < 0:
// the one gentun_pop_conv3x3_wgrad picks), for timing the configurations
// and splits against each other; the arguments are gentun_pop_conv3x3_wgrad's.
// Returns -1 when there is no configuration cfg.
int gentun_pop_conv3x3_wgrad_bf16_config(int cfg, const void* x, const void* dy, void* part,
                                         void* dbpart, void* dw, void* db, int S, int B, int C,
                                         int F, int H, int W, int splits, int pix_per_split,
                                         long long sstride, long long bstride, void* stream) {
  if (cfg >= wg_hop::kNumConfigs) return -1;
  if (S < 1 || S > 65535 || splits < 1) return (int)cudaErrorInvalidValue;
  if ((long long)splits * pix_per_split < (long long)B * H * W) return (int)cudaErrorInvalidValue;
  if (cfg < 0) cfg = wg_hop::pick(C, F, H, W);
  return wg_hop::kConfigs[cfg]((const bf16*)x, (const bf16*)dy, (float*)part, (float*)dbpart,
                               (bf16*)dw, (bf16*)db, S, B, C, F, H, W, splits, pix_per_split,
                               XAddr{sstride, bstride}, (cudaStream_t)stream);
}

// Which configuration gentun_pop_conv3x3_wgrad takes for a bf16 shape.
int gentun_pop_conv3x3_wgrad_bf16_pick(int C, int F, int H, int W) {
  return wg_hop::pick(C, F, H, W);
}

const char* gentun_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
