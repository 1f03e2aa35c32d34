// The stage DAG around the conv for Hopper (sm_90a): the masked node sums,
// ReLU and the mask selections, the stage output and the 2x2 max-pool, and
// their reverse, with a plain C interface (loaded with ctypes by
// gentun_tpu_torch/ops/_build.py, wrapped by gentun_tpu_torch/ops/pop_dag.py,
// whose PopStageFn runs a whole stage through them and the conv kernels).
//
// What they replace: the elementwise work of the JAX package's
// MaskedGeneticCnn.__call__ around each conv, which XLA fused on the TPU
// (there is no Pallas kernel behind it), and its reverse under
// jax.value_and_grad:
//
// replaces pop_dag_node_input: gentun_tpu/models/cnn.py:137-150
// replaces pop_dag_stage_out: gentun_tpu/models/cnn.py:151-160
// replaces pop_dag_node_grad: gentun_tpu/models/cnn.py:267
//
// For a stage of k nodes with raw conv outputs y_entry, y_0 .. y_{k-1}:
//
//   pop_dag_node_input  inp_j = entry[j]*relu(y_entry)
//                             + sum_{i<j} adj[i,j]*(active[i]*relu(y_i))
//   pop_dag_stage_out   out = has*sum_i exit[i]*(active[i]*relu(y_i))
//                             + (1-has)*relu(y_entry)    (k = 0: relu(y_entry))
//                       then either written whole (the stage-exit conv
//                       follows) or max-pooled 2x2 (floored) with a one-byte
//                       window argmax per output; k = 0 with the pool is the
//                       pool-only form, pool(relu(y)), that closes the exit conv
//   pop_dag_node_grad   dy = [y > 0]*a*(c2*(c1*g) + sum_t w_t*d_t): a node's
//                       conv-output gradient from the stage gradient g (the
//                       pooled gradient scattered to each window's argmax on
//                       the fly, or the exit conv's full-size input gradient)
//                       and the input gradients d_j of its successors
//
// Every mask scalar is a per-slot value read from the (S, k, k) / (S, k) /
// (S,) float32 masks; each CTA works in one slot (blockIdx.y) and reads only
// that slot's scalars, so slot s's bits never depend on S.  The arithmetic
// repeats the eager chain's: each product and sum is taken in float (double
// for float64) without contraction and rounded to the compute type where the
// chain rounds (after every multiply and every add), in the chain's order:
// the entry term first and then i = 0..j-1; exit[0] first; the has_active
// select last; in the gradient the stage term first and then the successors
// in descending j, the order in which autograd of the chain accumulates a
// node's gradient.  A scalar of 0 still reads its tensor, so 0*inf = NaN
// survives as in the chain.  ReLU keeps NaN (y < 0 ? 0 : y), its gradient
// passes where !(y <= 0), and the pool picks the first maximum in window
// order, a NaN winning, as torch's CUDA max_pool2d does.
//
// What bounds them (NVIDIA H100 SXM data sheet, 700 W: 3.35 TB/s): bytes.
// Each reads its inputs once and writes its output once, a few flops per
// element: node_input reads j+1 tensors and writes one, stage_out reads k+1
// and writes a quarter (plus an eighth for the argmax) with the pool,
// node_grad reads the stage gradient (a quarter with the pool), y and the
// successors' gradients and writes one.  Design: one thread per 16 bytes of
// a row (8 bf16, 4 float32, 2 float64) with 128-bit loads where the row
// width and every pointer allow it, else one element (one pooled output) a
// thread; the slot's scalars sit in shared memory.  Nothing is staged in
// shared memory: every input element is used once.  ptxas (sm_90a): 30-48
// registers, 144-528 bytes of shared memory, no spills.  Measured (NVIDIA
// H100 80GB HBM3, 700 W; chip_smoke.py phase K, a config #2 train step at
// P=20): node_input 1.34x its bound, stage_out 1.69x, node_grad 1.45x;
// what keeps them above it is not measured.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum DType { kBF16 = 0, kF32 = 1, kF64 = 2 };
enum GradMode { kPlain = 0, kEntry = 1, kNode = 2 };

constexpr int kMaxNodes = 32;
constexpr int kThreads = 256;

template <typename T> struct AccOf { typedef float type; };
template <> struct AccOf<double> { typedef double type; };

__device__ __forceinline__ float to_acc(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }

__device__ __forceinline__ bf16 from_acc(float v, bf16*) { return __float2bfloat16(v); }
__device__ __forceinline__ float from_acc(float v, float*) { return v; }
__device__ __forceinline__ double from_acc(double v, double*) { return v; }

// Rounded to T and back: what torch does after each op of the chain in T.
__device__ __forceinline__ float rnd(float v, bf16*) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float rnd(float v, float*) { return v; }
__device__ __forceinline__ double rnd(double v, double*) { return v; }

// Products and sums rounded once each: never contracted into an FMA.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

template <typename A> __device__ __forceinline__ A relu(A v) { return v < A(0) ? A(0) : v; }

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int V, typename A>
__device__ __forceinline__ void load(const T* __restrict__ p, A (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = to_acc(pk.v[e]);
}

template <typename T, int V, typename A>
__device__ __forceinline__ void store(T* __restrict__ p, const A* in) {
  Pack<T, V> pk;
#pragma unroll
  for (int e = 0; e < V; ++e) pk.v[e] = from_acc(in[e], (T*)nullptr);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// The tensors of one call beside the first: node outputs or successors'
// gradients, by node index.
struct Ptrs {
  const void* p[kMaxNodes];
};

// The stage's masks, float32: adj (S, k, k), entry/active/exit (S, k), has (S,).
struct Masks {
  const float* adj;
  const float* entry;
  const float* active;
  const float* exit;
  const float* has;
  int k;
};

// A mask value as the chain holds it: cast to the compute type.
template <typename T>
__device__ __forceinline__ typename AccOf<T>::type scalar(float m) {
  typedef typename AccOf<T>::type A;
  return rnd((A)m, (T*)nullptr);
}

// Where a thread's unit starts: image b of the call's B, unit u of the image.
struct Unit {
  int b;
  long long u;
};

__device__ __forceinline__ Unit unit_of(int bpi) {
  return Unit{(int)(blockIdx.x / bpi), (long long)(blockIdx.x % bpi) * kThreads + threadIdx.x};
}

// ---------------------------------------------------------------------------
// node_input: inp_j, V elements of the slot's (F, H, W) block per thread.
// sc: [entry[j], then (active[i], adj[i, j]) for i < j]
// ---------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dag_node_input_kernel(const T* __restrict__ ye, Ptrs ys, int j, Masks m, T* __restrict__ out,
                          int S, long long n, int bpi) {
  typedef typename AccOf<T>::type A;
  __shared__ A sc[1 + 2 * kMaxNodes];
  const int s = blockIdx.y;
  if (threadIdx.x == 0) {
    const long long row = (long long)s * m.k;
    sc[0] = scalar<T>(m.entry[row + j]);
    for (int i = 0; i < j; ++i) {
      sc[1 + 2 * i] = scalar<T>(m.active[row + i]);
      sc[2 + 2 * i] = scalar<T>(m.adj[(row + i) * m.k + j]);
    }
  }
  __syncthreads();
  const Unit t = unit_of(bpi);
  if (t.u * V >= n) return;
  const long long off = ((long long)t.b * S + s) * n + t.u * V;
  A v[V], acc[V];
  load<T, V>(ye + off, v);
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = rnd(mul(sc[0], relu(v[e])), (T*)nullptr);
  for (int i = 0; i < j; ++i) {
    load<T, V>((const T*)ys.p[i] + off, v);
    const A a = sc[1 + 2 * i], w = sc[2 + 2 * i];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const A o = rnd(mul(a, relu(v[e])), (T*)nullptr);
      acc[e] = rnd(add(acc[e], rnd(mul(w, o), (T*)nullptr)), (T*)nullptr);
    }
  }
  store<T, V>(out + off, acc);
}

// ---------------------------------------------------------------------------
// stage_out: the stage's merged output at V elements starting at off.
// sc: [has, 1 - has, then (active[i], exit[i]) for i < k]
// ---------------------------------------------------------------------------
template <typename T, int V, typename A>
__device__ __forceinline__ void stage_values(const T* __restrict__ ye, const Ptrs& ys, int k,
                                             const A* sc, long long off, A (&val)[V]) {
  A a0[V], v[V], out[V];
  load<T, V>(ye + off, a0);
#pragma unroll
  for (int e = 0; e < V; ++e) a0[e] = relu(a0[e]);
  if (k == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) val[e] = a0[e];
    return;
  }
  for (int i = 0; i < k; ++i) {
    load<T, V>((const T*)ys.p[i] + off, v);
    const A a = sc[2 + 2 * i], x = sc[3 + 2 * i];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const A o = rnd(mul(a, relu(v[e])), (T*)nullptr);
      const A term = rnd(mul(x, o), (T*)nullptr);
      out[e] = i == 0 ? term : rnd(add(out[e], term), (T*)nullptr);
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    val[e] = rnd(add(rnd(mul(sc[0], out[e]), (T*)nullptr), rnd(mul(sc[1], a0[e]), (T*)nullptr)),
                 (T*)nullptr);
}

// torch's CUDA max_pool2d window rule: the first maximum in window order,
// a NaN winning (a later NaN over an earlier one).
template <typename A>
__device__ __forceinline__ void window_max(const A (&w)[4], A& best, uint8_t& arg) {
  best = w[0];
  arg = 0;
  // w[0] against the initial -inf: it wins unless it is -inf, which leaves
  // the first element as the argmax all the same.
#pragma unroll
  for (int t = 1; t < 4; ++t) {
    if (w[t] > best || w[t] != w[t]) {
      best = w[t];
      arg = (uint8_t)t;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dag_stage_out_kernel(const T* __restrict__ ye, Ptrs ys, Masks m, T* __restrict__ out,
                         uint8_t* __restrict__ argmax, int pool, int S, int F, int H, int W,
                         int bpi) {
  typedef typename AccOf<T>::type A;
  __shared__ A sc[2 + 2 * kMaxNodes];
  const int s = blockIdx.y;
  const int k = m.k;
  if (threadIdx.x == 0 && k > 0) {
    const long long row = (long long)s * k;
    sc[0] = scalar<T>(m.has[s]);
    sc[1] = rnd(A(1) - sc[0], (T*)nullptr);
    for (int i = 0; i < k; ++i) {
      sc[2 + 2 * i] = scalar<T>(m.active[row + i]);
      sc[3 + 2 * i] = scalar<T>(m.exit[row + i]);
    }
  }
  __syncthreads();
  const Unit t = unit_of(bpi);
  const long long n = (long long)F * H * W;
  const long long base = ((long long)t.b * S + s) * n;
  if (!pool) {
    if (t.u * V >= n) return;
    A val[V];
    stage_values<T, V>(ye, ys, k, sc, base + t.u * V, val);
    store<T, V>(out + base + t.u * V, val);
    return;
  }
  const int Ho = H / 2, Wo = W / 2;
  const long long pbase = ((long long)t.b * S + s) * F * Ho * Wo;
  if constexpr (V == 1) {  // one pooled output a thread
    if (t.u >= (long long)F * Ho * Wo) return;
    const int wo = (int)(t.u % Wo);
    const long long r = t.u / Wo;
    const int ho = (int)(r % Ho), f = (int)(r / Ho);
    const long long off = base + ((long long)f * H + 2 * ho) * W + 2 * wo;
    A w[4], v[1];
    const long long at[4] = {off, off + 1, off + W, off + W + 1};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      stage_values<T, 1>(ye, ys, k, sc, at[q], v);
      w[q] = v[0];
    }
    A best;
    uint8_t arg;
    window_max(w, best, arg);
    out[pbase + t.u] = from_acc(best, (T*)nullptr);
    argmax[pbase + t.u] = arg;
  } else {  // V columns of both rows of a window row: V/2 pooled outputs
    const int chunks = W / V;
    if (t.u >= (long long)F * Ho * chunks) return;
    const int wc = (int)(t.u % chunks);
    const long long r = t.u / chunks;
    const int ho = (int)(r % Ho), f = (int)(r / Ho);
    const long long off = base + ((long long)f * H + 2 * ho) * W + (long long)wc * V;
    A top[V], bot[V], best[V / 2];
    stage_values<T, V>(ye, ys, k, sc, off, top);
    stage_values<T, V>(ye, ys, k, sc, off + W, bot);
    Pack<uint8_t, V / 2> args;
#pragma unroll
    for (int q = 0; q < V / 2; ++q) {
      const A w[4] = {top[2 * q], top[2 * q + 1], bot[2 * q], bot[2 * q + 1]};
      window_max(w, best[q], args.v[q]);
    }
    const long long po = pbase + ((long long)f * Ho + ho) * Wo + (long long)wc * (V / 2);
    store<T, V / 2>(out + po, best);
    *reinterpret_cast<Pack<uint8_t, V / 2>*>(argmax + po) = args;
  }
}

// ---------------------------------------------------------------------------
// node_grad: dy at V elements of one row per thread.
// sc: [c1, c2, a, then w for j = k-1 down to lo]
// ---------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dag_node_grad_kernel(const T* __restrict__ y, const T* __restrict__ g,
                         const uint8_t* __restrict__ gidx, Ptrs d, int mode, int node, Masks m,
                         T* __restrict__ dy, int S, int F, int H, int W, int bpi) {
  typedef typename AccOf<T>::type A;
  __shared__ A sc[3 + kMaxNodes];
  __shared__ int lo;
  const int s = blockIdx.y;
  const int k = m.k;
  if (threadIdx.x == 0) {
    const long long row = (long long)s * k;
    A c1 = A(1), c2 = A(1), a = A(1);
    int first = k;  // no successor terms
    if (mode == kEntry) {
      c1 = rnd(A(1) - scalar<T>(m.has[s]), (T*)nullptr);
      first = 0;
      for (int j = k - 1; j >= 0; --j) sc[3 + (k - 1 - j)] = scalar<T>(m.entry[row + j]);
    } else if (mode == kNode) {
      c1 = scalar<T>(m.has[s]);
      c2 = scalar<T>(m.exit[row + node]);
      a = scalar<T>(m.active[row + node]);
      first = node + 1;
      for (int j = k - 1; j > node; --j) sc[3 + (k - 1 - j)] = scalar<T>(m.adj[(row + node) * k + j]);
    }
    sc[0] = c1;
    sc[1] = c2;
    sc[2] = a;
    lo = first;
  }
  __syncthreads();
  const Unit t = unit_of(bpi);
  const long long n = (long long)F * H * W;
  if (t.u * V >= n) return;
  const long long e0 = t.u * V;
  const long long off = ((long long)t.b * S + s) * n + e0;
  A acc[V], v[V];
  if (gidx != nullptr) {  // the pooled gradient, scattered to each window's argmax
    const int w0 = (int)(e0 % W);
    const long long r = e0 / W;
    const int h = (int)(r % H), f = (int)(r / H);
    const int Ho = H / 2, Wo = W / 2;
    const long long prow = (((long long)t.b * S + s) * F + f) * Ho + h / 2;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int w = w0 + e;
      A gv = A(0);
      if (h < 2 * Ho && w < 2 * Wo) {
        const long long po = prow * Wo + w / 2;
        if (gidx[po] == (uint8_t)((h & 1) * 2 + (w & 1))) gv = to_acc(g[po]);
      }
      acc[e] = gv;
    }
  } else {
    load<T, V>(g + off, acc);
  }
  const A c1 = sc[0], c2 = sc[1], a = sc[2];
#pragma unroll
  for (int e = 0; e < V; ++e)
    acc[e] = rnd(mul(c2, rnd(mul(c1, acc[e]), (T*)nullptr)), (T*)nullptr);
  for (int j = k - 1; j >= lo; --j) {
    load<T, V>((const T*)d.p[j] + off, v);
    const A w = sc[3 + (k - 1 - j)];
#pragma unroll
    for (int e = 0; e < V; ++e)
      acc[e] = rnd(add(acc[e], rnd(mul(w, v[e]), (T*)nullptr)), (T*)nullptr);
  }
  load<T, V>(y + off, v);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const A gh = rnd(mul(a, acc[e]), (T*)nullptr);
    acc[e] = v[e] <= A(0) ? A(0) : gh;
  }
  store<T, V>(dy + off, acc);
}

// ---------------------------------------------------------------------------
// Launch helpers: the vector width V = 16 bytes of T where every row is whole
// chunks of V and every pointer is 16-byte aligned, else 1.
// ---------------------------------------------------------------------------
inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
bool vectorised(int W, const void* const* ptrs, int count) {
  if (W % (16 / (int)sizeof(T)) != 0) return false;
  for (int i = 0; i < count; ++i)
    if (ptrs[i] != nullptr && !aligned16(ptrs[i])) return false;
  return true;
}

bool fill(Ptrs& out, const void* const* src, int count) {
  if (count < 0 || count > kMaxNodes) return false;
  for (int i = 0; i < kMaxNodes; ++i) out.p[i] = i < count ? src[i] : nullptr;
  return true;
}

// A grid of B * bpi blocks by S slots, bpi = blocks per image.
bool grid_of(int B, int S, long long units, dim3& grid, int& bpi) {
  const long long per = cdiv(units, kThreads);
  if (per < 1 || per * B > 0x7fffffffLL || S < 1 || S > 65535) return false;
  bpi = (int)per;
  grid = dim3((unsigned)(per * B), (unsigned)S);
  return true;
}

template <typename T>
int launch_node_input(const void* ye, const void* const* ys, int j, Masks m, void* out, int S,
                      int B, int F, int H, int W, cudaStream_t st) {
  Ptrs p;
  if (j < 0 || j >= m.k || !fill(p, ys, j)) return (int)cudaErrorInvalidValue;
  const void* all[kMaxNodes + 2] = {ye, out};
  for (int i = 0; i < j; ++i) all[2 + i] = ys[i];
  const long long n = (long long)F * H * W;
  constexpr int VW = 16 / sizeof(T);
  const bool vec = vectorised<T>(W, all, 2 + j);
  dim3 grid;
  int bpi;
  if (!grid_of(B, S, vec ? n / VW : n, grid, bpi)) return (int)cudaErrorInvalidValue;
  if (vec)
    dag_node_input_kernel<T, VW><<<grid, kThreads, 0, st>>>((const T*)ye, p, j, m, (T*)out, S, n, bpi);
  else
    dag_node_input_kernel<T, 1><<<grid, kThreads, 0, st>>>((const T*)ye, p, j, m, (T*)out, S, n, bpi);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stage_out(const void* ye, const void* const* ys, Masks m, void* out, void* argmax,
                     int pool, int S, int B, int F, int H, int W, cudaStream_t st) {
  Ptrs p;
  if (!fill(p, ys, m.k)) return (int)cudaErrorInvalidValue;
  if (pool && (H < 2 || W < 2 || argmax == nullptr)) return (int)cudaErrorInvalidValue;
  const void* all[kMaxNodes + 3] = {ye, out, argmax};
  for (int i = 0; i < m.k; ++i) all[3 + i] = ys[i];
  constexpr int VW = 16 / sizeof(T);
  const bool vec = vectorised<T>(W, all, 3 + m.k);
  const long long n = (long long)F * H * W;
  long long units;
  if (!pool) units = vec ? n / VW : n;
  else units = (long long)F * (H / 2) * (vec ? W / VW : W / 2);
  dim3 grid;
  int bpi;
  if (!grid_of(B, S, units, grid, bpi)) return (int)cudaErrorInvalidValue;
  if (vec)
    dag_stage_out_kernel<T, VW><<<grid, kThreads, 0, st>>>(
        (const T*)ye, p, m, (T*)out, (uint8_t*)argmax, pool, S, F, H, W, bpi);
  else
    dag_stage_out_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        (const T*)ye, p, m, (T*)out, (uint8_t*)argmax, pool, S, F, H, W, bpi);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_node_grad(const void* y, const void* g, const void* gidx, const void* const* d,
                     int mode, int node, Masks m, void* dy, int S, int B, int F, int H, int W,
                     cudaStream_t st) {
  Ptrs p;
  if (!fill(p, d, m.k)) return (int)cudaErrorInvalidValue;
  if (mode == kNode && (node < 0 || node >= m.k)) return (int)cudaErrorInvalidValue;
  if (mode != kPlain && mode != kEntry && mode != kNode) return (int)cudaErrorInvalidValue;
  if (gidx != nullptr && (H < 2 || W < 2)) return (int)cudaErrorInvalidValue;
  const int lo = mode == kEntry ? 0 : mode == kNode ? node + 1 : m.k;
  const void* all[kMaxNodes + 3] = {y, dy, gidx != nullptr ? nullptr : g};
  int count = 3;
  for (int j = lo; j < m.k; ++j) {
    if (d[j] == nullptr) return (int)cudaErrorInvalidValue;
    all[count++] = d[j];
  }
  constexpr int VW = 16 / sizeof(T);
  const bool vec = vectorised<T>(W, all, count);
  const long long n = (long long)F * H * W;
  dim3 grid;
  int bpi;
  if (!grid_of(B, S, vec ? n / VW : n, grid, bpi)) return (int)cudaErrorInvalidValue;
  if (vec)
    dag_node_grad_kernel<T, VW><<<grid, kThreads, 0, st>>>(
        (const T*)y, (const T*)g, (const uint8_t*)gidx, p, mode, node, m, (T*)dy, S, F, H, W, bpi);
  else
    dag_node_grad_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        (const T*)y, (const T*)g, (const uint8_t*)gidx, p, mode, node, m, (T*)dy, S, F, H, W, bpi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// inp (B, S*F, H, W) of node j from y_entry and ys[0..j-1] (each (B, S*F, H, W),
// raw conv outputs) and the masks entry, active (S, k) and adj (S, k, k),
// float32.  Returns a CUDA error code, 0 when the launch was accepted.
int gentun_pop_dag_node_input(int dtype, const void* y_entry, const void* const* ys, int j,
                              const void* entry, const void* adj, const void* active, int k,
                              void* out, int S, int B, int F, int H, int W, void* stream) {
  const Masks m{(const float*)adj, (const float*)entry, (const float*)active, nullptr, nullptr, k};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16: return launch_node_input<bf16>(y_entry, ys, j, m, out, S, B, F, H, W, st);
    case kF32: return launch_node_input<float>(y_entry, ys, j, m, out, S, B, F, H, W, st);
    case kF64: return launch_node_input<double>(y_entry, ys, j, m, out, S, B, F, H, W, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The stage output from y_entry and ys[0..k-1] with the masks active, exit
// (S, k) and has_active (S,), float32 (unread when k = 0).  pool = 0: out is
// (B, S*F, H, W); pool = 1: out and argmax are (B, S*F, H/2, W/2), argmax one
// byte per output (the window position 2*dh + dw).
int gentun_pop_dag_stage_out(int dtype, const void* y_entry, const void* const* ys, int k,
                             const void* active, const void* exit, const void* has, void* out,
                             void* argmax, int pool, int S, int B, int F, int H, int W,
                             void* stream) {
  const Masks m{nullptr, nullptr, (const float*)active, (const float*)exit, (const float*)has, k};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16: return launch_stage_out<bf16>(y_entry, ys, m, out, argmax, pool, S, B, F, H, W, st);
    case kF32: return launch_stage_out<float>(y_entry, ys, m, out, argmax, pool, S, B, F, H, W, st);
    case kF64: return launch_stage_out<double>(y_entry, ys, m, out, argmax, pool, S, B, F, H, W, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dy (B, S*F, H, W) of a conv output y: mode 0 (the pool-only form's and a
// node-free stage's entry) [y > 0]*g; mode 1 (the entry conv of a stage of k
// nodes) with c1 = 1 - has and the terms entry[j]*d[j], j = k-1..0; mode 2
// (node `node`) with c1 = has, c2 = exit[node], a = active[node] and the terms
// adj[node, j]*d[j], j = k-1..node+1.  g is the pooled gradient (B, S*F, H/2,
// W/2) with its argmax gidx, or, with gidx null, the full-size gradient.
int gentun_pop_dag_node_grad(int dtype, const void* y, const void* g, const void* gidx,
                             const void* const* d, int k, int mode, int node, const void* adj,
                             const void* entry, const void* active, const void* exit,
                             const void* has, void* dy, int S, int B, int F, int H, int W,
                             void* stream) {
  const Masks m{(const float*)adj, (const float*)entry, (const float*)active, (const float*)exit,
                (const float*)has, k};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kBF16:
      return launch_node_grad<bf16>(y, g, gidx, d, mode, node, m, dy, S, B, F, H, W, st);
    case kF32:
      return launch_node_grad<float>(y, g, gidx, d, mode, node, m, dy, S, B, F, H, W, st);
    case kF64:
      return launch_node_grad<double>(y, g, gidx, d, mode, node, m, dy, S, B, F, H, W, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
