// Hopper kernels of the Mamba mixer's causal depthwise conv and its SiLU
// (models/ssm.py `ssm_forward`), forward and backward:
//
//   y[b, t, c] = silu(conv[b, t, c] + bias[c]),
//   conv[b, t, c] = sum_k x[b, t - (K-1) + k, c] * w[k, c],  rows t < 0 zero.
//
// Replaces no TPU kernel: the JAX package computes this conv with
// jax.lax.conv_general_dilated (XLA).  The plain PyTorch version it is held
// against is `ref.py::causal_conv_silu`, the model's code before this
// kernel, which ran as some 20 eager passes over memory forward and 40
// backward.  Both directions do a few dozen instructions a byte at most,
// so the card's memory bounds them: the forward has to read x and write y
// once, the backward to read dy and x and write dx once (the taps, the
// bias and their gradients are K + 1 rows).  The exact expf and division
// the numbers need (below) cost about as much issue time as the bytes, so
// the design keeps loads in flight while a lane computes.
//
// Design.  A lane owns V adjacent channels -- one 8-byte access a row
// forward, two channels backward -- of one run of `rows` consecutive steps
// of one sequence, and walks down the run with the K - 1 rows before the
// current one (and, backward, their gradients) in registers.  Inside a run
// rows come in groups of FWD_UNROLL (BWD_UNROLL), a group's rows computed
// with no branch between them while the next group's loads are in flight.
// A run re-reads only its K - 1 halo rows (2 (K - 1) of x and K - 1 of dy
// backward, whose d(pre) it recomputes), which its neighbouring run read
// last.  `rows` (1 to 64) is chosen per call from the shapes and the
// kernel's occupancy: the run length whose whole waves of blocks, at a
// cost of rows plus halo and fixed work a wave, finish first, so a short
// prefill fills the card and a long step leaves no wave nearly empty.  A
// warp's 32 lanes take 32 neighbouring channel vectors of a row: each row
// access is contiguous.  Blocks are small (4 runs of a warp each), so that
// the occupancy the registers allow is met in fine steps.  x is read
// through its batch and step strides (the model passes a view of its fused
// projection; no copy is made); y, dy and dx are contiguous.  Where C is
// not a multiple of V, or a pointer or a stride is not aligned to a
// vector, the same kernels run with V = 1.
//
// Numbers.  The forward is bit for bit the plain version's on the card:
// float32 products and sums in the order ((x0 w0 + x1 w1) + x2 w2) + x3 w3,
// each rounded on its own (__fmul_rn / __fadd_rn: nothing is contracted to
// an FMA, as PyTorch's separate passes round), the sum rounded to the
// input dtype, the bias added in float32 and rounded again (PyTorch adds
// two bf16 tensors so), then SiLU as PyTorch computes it, x / (1 + expf(-x))
// in float32 (built without fast math), rounded once.  The backward
// recomputes the pre-SiLU value from x, forms d(pre) by PyTorch's SiLU
// backward, dy s (1 + x (1 - s)), rounded to the dtype as autograd's is,
// then dx = sum_k d(pre)[t + K-1 - k] w[k] in float32, rounded once.  dw
// and db are float32 sums: each lane's run, then the RY runs of a block in
// order in shared memory, then (a second kernel) the blocks in order, each
// rounded once to the dtype.  No atomics: two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int MAX_TAPS = 4;
constexpr int CX = 32;       // lanes of a block along channels: one warp
constexpr int RY = 4;        // lanes of a block along runs
constexpr int FWD_UNROLL = 4;  // rows a group; one group is loaded ahead
constexpr int BWD_UNROLL = 4;
constexpr int MAX_ROWS = 64;
// the cost of a run's fixed work (its taps and bias, its block's sums) in
// rows, for the choice of `rows`
constexpr int RUN_FIXED_ROWS = 4;

// ---------------------------------------------------------------------------
// Elements: float32 or bfloat16, loaded raw and widened to float
// ---------------------------------------------------------------------------

template <int BYTES> struct RawOf;
template <> struct RawOf<2> { typedef unsigned short type; };
template <> struct RawOf<4> { typedef unsigned type; };
template <> struct RawOf<8> { typedef uint2 type; };
template <> struct RawOf<16> { typedef uint4 type; };

// V elements of T as they sit in memory
template <typename T, int V>
using Raw = typename RawOf<V * static_cast<int>(sizeof(T))>::type;

__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ unsigned word(const uint2& r, int i) {
  return i == 0 ? r.x : r.y;
}
__device__ __forceinline__ unsigned word(unsigned r, int) { return r; }

__device__ __forceinline__ void set_word(uint4& r, int i, unsigned w) {
  if (i == 0) r.x = w; else if (i == 1) r.y = w; else if (i == 2) r.z = w; else r.w = w;
}
__device__ __forceinline__ void set_word(uint2& r, int i, unsigned w) {
  if (i == 0) r.x = w; else r.y = w;
}
__device__ __forceinline__ void set_word(unsigned& r, int, unsigned w) { r = w; }

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int PER_WORD = 1;
  template <typename R>
  static __device__ __forceinline__ float get(const R& r, int i) {
    return __uint_as_float(word(r, i));
  }
  // word j of v as it sits in memory
  template <int V>
  static __device__ __forceinline__ unsigned word_of(const float (&v)[V], int j) {
    return __float_as_uint(v[j]);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  template <int V>
  static __device__ __forceinline__ void round_vec(float (&)[V]) {}
};

template <> struct Elem<__nv_bfloat16> {
  // a bf16 is the high half of the float it widens to; two a word, the
  // even element in the low half
  static constexpr int PER_WORD = 2;
  // lo and hi rounded to bf16 (one conversion for the pair) as a word
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return static_cast<unsigned>(__bfloat16_as_ushort(h.x)) |
           (static_cast<unsigned>(__bfloat16_as_ushort(h.y)) << 16);
  }
  template <int V>
  static __device__ __forceinline__ unsigned word_of(const float (&v)[V], int j) {
    return pack2(v[2 * j], v[2 * j + 1]);
  }
  // v rounded to bf16, a pair at a time where V allows
  template <int V>
  static __device__ __forceinline__ void round_vec(float (&v)[V]) {
#pragma unroll
    for (int i = 0; i + 1 < V; i += 2) {
      const unsigned u = pack2(v[i], v[i + 1]);
      v[i] = __uint_as_float(u << 16);
      v[i + 1] = __uint_as_float(u & 0xffff0000u);
    }
    if constexpr (V % 2) v[V - 1] = __bfloat162float(__float2bfloat16_rn(v[V - 1]));
  }
  template <typename R>
  static __device__ __forceinline__ float get(const R& r, int i) {
    const unsigned u = word(r, i >> 1);
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  static __device__ __forceinline__ float get(const unsigned short& r, int) {
    return __uint_as_float(static_cast<unsigned>(r) << 16);  // a lone bf16
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  return *reinterpret_cast<const Raw<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = Elem<T>::get(r, i);
}

// V floats rounded to T, stored as one access at p
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V % Elem<T>::PER_WORD) {
    Elem<T>::store(p, v[0]);  // a lone bf16
  } else {
    Raw<T, V> r{};
#pragma unroll
    for (int j = 0; j < V / Elem<T>::PER_WORD; ++j) set_word(r, j, Elem<T>::word_of(v, j));
    *reinterpret_cast<Raw<T, V>*>(p) = r;
  }
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  unpack<T, V>(load_raw<T, V>(p), v);
}

template <int V>
__device__ __forceinline__ void zero(float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = 0.0f;
}

template <int V>
__device__ __forceinline__ void copy(float (&to)[V], const float (&from)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) to[i] = from[i];
}

// The pre-SiLU values from the window win (rows t-K+1 .. t): the plain
// version's roundings, in its order
template <typename T, int V, int K>
__device__ __forceinline__ void pre_silu(const float (&win)[K][V],
                                         const float (&wf)[K][V],
                                         const float (&bf)[V], float (&pre)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float acc = __fmul_rn(win[0][i], wf[0][i]);
#pragma unroll
    for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(win[k][i], wf[k][i]));
    pre[i] = acc;
  }
  Elem<T>::round_vec(pre);
#pragma unroll
  for (int i = 0; i < V; ++i) pre[i] = __fadd_rn(pre[i], bf[i]);
  Elem<T>::round_vec(pre);
}

// The lane's run: its batch row, first step and end (exclusive), or false
// for a lane past the last run or channel
struct Run {
  int b, t0, t1;
};

__device__ __forceinline__ bool lane_run(int B, int S, int C, int rows, int c0,
                                         Run& r) {
  const int runs = (S + rows - 1) / rows;
  const long long run = static_cast<long long>(blockIdx.x) * RY + threadIdx.y;
  if (c0 >= C || run >= static_cast<long long>(B) * runs) return false;
  r.b = static_cast<int>(run / runs);
  r.t0 = static_cast<int>(run % runs) * rows;
  r.t1 = min(r.t0 + rows, S);
  return true;
}

// row t of a strided array, raw; zeros at and past `end`
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_row(const T* p, long long step, int t,
                                              int end) {
  return t < end ? load_raw<T, V>(p + t * step) : Raw<T, V>{};
}

// rows t .. t + U - 1 of a strided array, raw
template <typename T, int V, int U>
__device__ __forceinline__ void load_group(Raw<T, V> (&g)[U], const T* p,
                                           long long step, int t) {
#pragma unroll
  for (int u = 0; u < U; ++u) g[u] = load_raw<T, V>(p + (t + u) * step);
}

template <int K, int V>
__device__ __forceinline__ void shift(float (&win)[K][V]) {
#pragma unroll
  for (int j = 0; j < K - 1; ++j) copy(win[j], win[j + 1]);
}

// The taps and the bias of the lane's channels, and the window's K - 1 rows
// of x before t0 (zeros before the sequence)
template <typename T, int V, int K>
__device__ __forceinline__ void lane_setup(const T* w, const T* bias, int C,
                                           int c0, const T* xs, long long x_step,
                                           int t0, float (&wf)[K][V],
                                           float (&bf)[V], float (&win)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k) load_vec<T, V>(w + static_cast<long long>(k) * C + c0, wf[k]);
  load_vec<T, V>(bias + c0, bf);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int t = t0 - (K - 1) + j;
    if (j < K - 1 && t >= 0) {
      load_vec<T, V>(xs + t * x_step, win[j]);
    } else {
      zero(win[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Output row t at y_row from x's row t (raw) and the window's K - 1 rows
// before it; the window moves on a row
template <typename T, int V, int K>
__device__ __forceinline__ void fwd_row(float (&win)[K][V], const Raw<T, V>& xr,
                                        const float (&wf)[K][V],
                                        const float (&bf)[V], T* y_row) {
  unpack<T, V>(xr, win[K - 1]);
  float out[V];
  pre_silu<T, V, K>(win, wf, bf, out);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = out[i] / (1.0f + expf(-out[i]));
  store_vec<T, V>(y_row, out);
  shift(win);
}

template <typename T, int V, int K>
__global__ void __launch_bounds__(CX* RY)
    causal_conv_fwd_kernel(const T* __restrict__ x, long long x_batch,
                           long long x_step, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ y,
                           int B, int S, int C, int rows) {
  constexpr int U = FWD_UNROLL;
  const int c0 = (blockIdx.y * CX + threadIdx.x) * V;
  Run r;
  if (!lane_run(B, S, C, rows, c0, r)) return;
  const T* xs = x + r.b * x_batch + c0;
  T* ys = y + static_cast<long long>(r.b) * S * C + c0;
  float wf[K][V], bf[V], win[K][V];  // win[K-1] is the current row
  lane_setup<T, V, K>(w, bias, C, c0, xs, x_step, r.t0, wf, bf, win);
  int t = r.t0;
  // whole groups of U rows, the next group's loads in flight meanwhile
  if (t + U <= r.t1) {
    Raw<T, V> cur[U], next[U];
    load_group<T, V, U>(cur, xs, x_step, t);
    for (; t + U <= r.t1; t += U) {
      const bool more = t + 2 * U <= r.t1;
      if (more) load_group<T, V, U>(next, xs, x_step, t + U);
#pragma unroll
      for (int u = 0; u < U; ++u)
        fwd_row<T, V, K>(win, cur[u], wf, bf, ys + static_cast<long long>(t + u) * C);
      if (more) {
#pragma unroll
        for (int u = 0; u < U; ++u) cur[u] = next[u];
      }
    }
  }
  for (; t < r.t1; ++t)
    fwd_row<T, V, K>(win, load_raw<T, V>(xs + t * x_step), wf, bf,
                     ys + static_cast<long long>(t) * C);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// d(pre) of row t into gw[K-1] from x's and dy's row t (raw; zeros past S,
// whose d(pre) is then 0), the windows of x and d(pre) moving on a row
// after: with ACC the row's terms of dw and db; with STORE dx of row t -
// (K-1), whose K rows of d(pre) are now formed, written at dx_row
template <typename T, int V, int K, bool ACC, bool STORE>
__device__ __forceinline__ void bwd_row(float (&xw)[K][V], float (&gw)[K][V],
                                        const Raw<T, V>& xr, const Raw<T, V>& gr,
                                        const float (&wf)[K][V],
                                        const float (&bf)[V], float (&dw)[K][V],
                                        float (&db)[V], T* dx_row) {
  unpack<T, V>(xr, xw[K - 1]);
  float g[V], pre[V];
  unpack<T, V>(gr, g);
  pre_silu<T, V, K>(xw, wf, bf, pre);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float s = 1.0f / (1.0f + expf(-pre[i]));
    gw[K - 1][i] = g[i] * s * (1.0f + pre[i] * (1.0f - s));
  }
  Elem<T>::round_vec(gw[K - 1]);
  if constexpr (ACC) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      db[i] += gw[K - 1][i];
#pragma unroll
      for (int k = 0; k < K; ++k) dw[k][i] += gw[K - 1][i] * xw[k][i];
    }
  }
  if constexpr (STORE) {
    float out[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float acc = gw[K - 1][i] * wf[0][i];
#pragma unroll
      for (int k = 1; k < K; ++k) acc += gw[K - 1 - k][i] * wf[k][i];
      out[i] = acc;
    }
    store_vec<T, V>(dx_row, out);
  }
  shift(xw);
  shift(gw);
}

// dx of every step, and per block the float32 sums of dw (K rows) and db
// over its RY runs, in order: part[blockIdx.x][k][c], k = K for db
template <typename T, int V, int K>
__global__ void __launch_bounds__(CX* RY)
    causal_conv_bwd_kernel(const T* __restrict__ x, long long x_batch,
                           long long x_step, const T* __restrict__ w,
                           const T* __restrict__ bias,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ part, int B, int S, int C,
                           int rows) {
  constexpr int U = BWD_UNROLL;
  __shared__ float red[RY][K + 1][CX * V];
  const int c0 = (blockIdx.y * CX + threadIdx.x) * V;
  float dw[K][V], db[V];
#pragma unroll
  for (int k = 0; k < K; ++k) zero(dw[k]);
  zero(db);
  Run r;
  if (lane_run(B, S, C, rows, c0, r)) {
    const T* xs = x + r.b * x_batch + c0;
    const long long row0 = static_cast<long long>(r.b) * S * C + c0;
    const T* dys = dy + row0;
    T* dxs = dx + row0;
    float wf[K][V], bf[V], xw[K][V], gw[K][V];  // index K-1: the current row
    lane_setup<T, V, K>(w, bias, C, c0, xs, x_step, r.t0, wf, bf, xw);
#pragma unroll
    for (int j = 0; j < K; ++j) zero(gw[j]);  // rows before the run: never read
    // rows t0 .. t0 + K - 2: their d(pre) (their dw and db terms where the
    // run holds them); no dx yet
    int t = r.t0;
    for (; t < r.t0 + K - 1; ++t) {
      const Raw<T, V> xr = load_row<T, V>(xs, x_step, t, S);
      const Raw<T, V> gr = load_row<T, V>(dys, C, t, S);
      if (t < r.t1) {
        bwd_row<T, V, K, true, false>(xw, gw, xr, gr, wf, bf, dw, db, nullptr);
      } else {
        bwd_row<T, V, K, false, false>(xw, gw, xr, gr, wf, bf, dw, db, nullptr);
      }
    }
    // the rest of the run: whole groups of U rows, the next group's loads
    // in flight meanwhile, then single rows
    if (t + U <= r.t1) {
      Raw<T, V> xc[U], gc[U], xn[U], gn[U];
      load_group<T, V, U>(xc, xs, x_step, t);
      load_group<T, V, U>(gc, dys, C, t);
      for (; t + U <= r.t1; t += U) {
        const bool more = t + 2 * U <= r.t1;
        if (more) {
          load_group<T, V, U>(xn, xs, x_step, t + U);
          load_group<T, V, U>(gn, dys, C, t + U);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          bwd_row<T, V, K, true, true>(xw, gw, xc[u], gc[u], wf, bf, dw, db,
                                       dxs + static_cast<long long>(t + u - (K - 1)) * C);
        if (more) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            xc[u] = xn[u];
            gc[u] = gn[u];
          }
        }
      }
    }
    for (; t < r.t1; ++t)
      bwd_row<T, V, K, true, true>(xw, gw, load_raw<T, V>(xs + t * x_step),
                                   load_raw<T, V>(dys + static_cast<long long>(t) * C),
                                   wf, bf, dw, db, dxs + static_cast<long long>(t - (K - 1)) * C);
    // rows t1 .. t1 + K - 2: the last rows' dx (d(pre) 0 past S)
    for (; t < r.t1 + K - 1; ++t)
      bwd_row<T, V, K, false, true>(xw, gw, load_row<T, V>(xs, x_step, t, S),
                                    load_row<T, V>(dys, C, t, S), wf, bf, dw, db,
                                    dxs + static_cast<long long>(t - (K - 1)) * C);
  }
  // the block's sums over its RY runs, in order
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[threadIdx.y][k][threadIdx.x * V + i] = dw[k][i];
    red[threadIdx.y][K][threadIdx.x * V + i] = db[i];
  }
  __syncthreads();
  const int cb = blockIdx.y * CX * V;
  for (int j = threadIdx.y * CX + threadIdx.x; j < (K + 1) * CX * V; j += CX * RY) {
    const int k = j / (CX * V), cc = j % (CX * V);
    if (cb + cc < C) {
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < RY; ++q) s += red[q][k][cc];
      part[(static_cast<long long>(blockIdx.x) * (K + 1) + k) * C + cb + cc] = s;
    }
  }
}

// dw (K, C) and db (C,) from the blocks' partial sums, in block order
template <typename T>
__global__ void __launch_bounds__(256)
    causal_conv_bwd_sums_kernel(const float* __restrict__ part, int blocks,
                                int C, int K, T* __restrict__ dw,
                                T* __restrict__ db) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = static_cast<long long>(K + 1) * C;
  if (j >= n) return;
  float s = 0.0f;
  for (int p = 0; p < blocks; ++p) s += part[p * n + j];
  const int k = static_cast<int>(j / C), c = static_cast<int>(j % C);
  Elem<T>::store(k < K ? dw + static_cast<long long>(k) * C + c : db + c, s);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The forward's and the backward's vector widths: 8 bytes, 2 elements (the
// backward's lanes hold twice the state; wider lanes cost occupancy)
constexpr int FWD_BYTES = 8;
template <typename T> constexpr int fwd_width() { return FWD_BYTES / static_cast<int>(sizeof(T)); }
constexpr int BWD_WIDTH = 2;

struct Plan {
  int rows;
  dim3 grid;
};

// Blocks of `kernel` an SM holds at once (1 if the runtime cannot say)
template <typename Kernel>
int blocks_per_sm(Kernel kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, CX * RY, 0) !=
          cudaSuccess ||
      n < 1) {
    cudaGetLastError();
    n = 1;
  }
  return n;
}

// The run length and grid for V channels a lane: of the run lengths 1 ..
// MAX_ROWS (each that some count of runs a sequence gives), the one whose
// whole waves of `per_sm` x `sms` blocks cost least at rows + halo +
// RUN_FIXED_ROWS a wave; ties go to the longer run.  false where the
// channel blocks do not fit the grid's y axis.
bool plan_of(int V, int B, int S, int C, int sms, int per_sm, int halo, Plan& p) {
  const long long blocks_y = ((C + V - 1) / V + CX - 1) / CX;
  if (blocks_y > 65535) return false;
  const long long cap = static_cast<long long>(sms) * per_sm;
  long long best = LLONG_MAX;
  for (int rows = S < MAX_ROWS ? S : MAX_ROWS; rows >= 1; --rows) {
    const int runs = (S + rows - 1) / rows;
    if ((S + runs - 1) / runs != rows) continue;  // the same runs as a longer one
    const long long blocks_x = (static_cast<long long>(B) * runs + RY - 1) / RY;
    const long long waves = (blocks_x * blocks_y + cap - 1) / cap;
    const long long cost = waves * (rows + halo + RUN_FIXED_ROWS);
    if (cost < best && blocks_x <= 0x7fffffffLL) {
      best = cost;
      p.rows = rows;
      p.grid = dim3(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y));
    }
  }
  return best != LLONG_MAX;
}

template <typename T, int V, int K>
bool fwd_plan(int B, int S, int C, int sms, Plan& p) {
  static const int per_sm = blocks_per_sm(causal_conv_fwd_kernel<T, V, K>);
  return plan_of(V, B, S, C, sms, per_sm, 0, p);
}

template <typename T, int V, int K>
bool bwd_plan(int B, int S, int C, int sms, Plan& p) {
  static const int per_sm = blocks_per_sm(causal_conv_bwd_kernel<T, V, K>);
  return plan_of(V, B, S, C, sms, per_sm, K - 1, p);
}

struct Shapes {
  int B, S, C, sms;
};

struct FwdCall {
  const void *x, *w, *b;
  void* y;
  long long x_batch, x_step;
  Shapes s;
  cudaStream_t stream;
  template <typename T, int V, int K>
  cudaError_t run() const {
    Plan p;
    if (!fwd_plan<T, V, K>(s.B, s.S, s.C, s.sms, p)) return cudaErrorInvalidConfiguration;
    causal_conv_fwd_kernel<T, V, K><<<p.grid, dim3(CX, RY), 0, stream>>>(
        static_cast<const T*>(x), x_batch, x_step, static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(y), s.B, s.S, s.C, p.rows);
    return cudaGetLastError();
  }
};

struct BwdCall {
  const void *x, *w, *b, *dy;
  void *dx, *dw, *db;
  float* ws;
  long long x_batch, x_step;
  Shapes s;
  cudaStream_t stream;
  template <typename T, int V, int KK>
  cudaError_t run() const {
    Plan p;
    if (!bwd_plan<T, V, KK>(s.B, s.S, s.C, s.sms, p)) return cudaErrorInvalidConfiguration;
    causal_conv_bwd_kernel<T, V, KK><<<p.grid, dim3(CX, RY), 0, stream>>>(
        static_cast<const T*>(x), x_batch, x_step, static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<const T*>(dy), static_cast<T*>(dx),
        ws, s.B, s.S, s.C, p.rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long n = static_cast<long long>(KK + 1) * s.C;
    causal_conv_bwd_sums_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
        ws, static_cast<int>(p.grid.x), s.C, KK, static_cast<T*>(dw),
        static_cast<T*>(db));
    return cudaGetLastError();
  }
};

struct WorkspaceCall {
  Shapes s;
  template <typename T, int V, int K>
  long long run() const {
    Plan p;
    if (!bwd_plan<T, V, K>(s.B, s.S, s.C, s.sms, p)) return -1;
    return static_cast<long long>(p.grid.x) * (K + 1) * s.C;
  }
};

template <typename T, int V, typename F>
auto by_taps(int K, const F& f) {
  switch (K) {
    case 1: return f.template run<T, V, 1>();
    case 2: return f.template run<T, V, 2>();
    case 3: return f.template run<T, V, 3>();
    default: return f.template run<T, V, 4>();
  }
}

// f.run<T, V, K>() for dtype (0 float32, 1 bfloat16), the vector path's
// width (VF32 or VBF16 elements) or 1, and K
template <int VF32, int VBF16, typename F>
auto dispatch(int dtype, int vec, int K, const F& f) {
  if (dtype == 0) return vec ? by_taps<float, VF32>(K, f) : by_taps<float, 1>(K, f);
  return vec ? by_taps<__nv_bfloat16, VBF16>(K, f) : by_taps<__nv_bfloat16, 1>(K, f);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Whether the vector path takes these pointers and strides at `width`
// elements of `item` bytes
bool vector_ok(int width, int item, int C, long long xb, long long xs,
               const void* const* ptrs, int n) {
  if (C % width || xb % width || xs % width) return false;
  for (int i = 0; i < n; ++i)
    if (!aligned(ptrs[i], width * item)) return false;
  return true;
}

bool valid(int dtype, int B, int S, int C, int K, int sms) {
  return B > 0 && S > 0 && C > 0 && K >= 1 && K <= MAX_TAPS && sms > 0 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// The forward: y (B, S, C) contiguous in x's dtype (0 float32, 1 bfloat16)
// from x (B, S, C) with strides (x_batch, x_step, 1) in elements, w (K, C)
// and b (C,) contiguous in that dtype, on `stream`: 8-byte lanes where C,
// the strides and every pointer allow them, else one element a lane.
// `sms` is the card's SM count.  Returns a cudaError_t.
int causal_conv_fwd_launch(int dtype, const void* x, long long x_batch,
                           long long x_step, const void* w, const void* b,
                           void* y, int B, int S, int C, int K, int sms,
                           void* stream) {
  if (!valid(dtype, B, S, C, K, sms)) return cudaErrorInvalidValue;
  const int item = dtype ? 2 : 4;
  const void* ptrs[] = {x, w, b, y};
  const int vec = vector_ok(FWD_BYTES / item, item, C, x_batch, x_step, ptrs, 4);
  const FwdCall f{x, w, b, y, x_batch, x_step, {B, S, C, sms},
                  static_cast<cudaStream_t>(stream)};
  return dispatch<fwd_width<float>(), fwd_width<__nv_bfloat16>()>(dtype, vec, K, f);
}

// Float32 elements of the workspace (the blocks' partial sums) that the
// backward of these arguments needs, or -1.
long long causal_conv_bwd_workspace(int dtype, const void* x, long long x_batch,
                                    long long x_step, const void* w,
                                    const void* b, const void* dy,
                                    const void* dx, int B, int S, int C, int K,
                                    int sms) {
  if (!valid(dtype, B, S, C, K, sms)) return -1;
  const int item = dtype ? 2 : 4;
  const void* ptrs[] = {x, w, b, dy, dx};
  const int vec = vector_ok(BWD_WIDTH, item, C, x_batch, x_step, ptrs, 5);
  return dispatch<BWD_WIDTH, BWD_WIDTH>(dtype, vec, K, WorkspaceCall{{B, S, C, sms}});
}

// The backward: dx (B, S, C) contiguous, dw (K, C) and db (C,) in x's
// dtype from x (strided as the forward's), w, b and dy (B, S, C)
// contiguous; `ws` holds causal_conv_bwd_workspace(...) floats.  Two
// kernels on `stream`, two channels a lane where C, the strides and every
// pointer allow it, else one.  Returns a cudaError_t.
int causal_conv_bwd_launch(int dtype, const void* x, long long x_batch,
                           long long x_step, const void* w, const void* b,
                           const void* dy, void* dx, void* dw, void* db,
                           void* ws, int B, int S, int C, int K, int sms,
                           void* stream) {
  if (!valid(dtype, B, S, C, K, sms)) return cudaErrorInvalidValue;
  const int item = dtype ? 2 : 4;
  const void* ptrs[] = {x, w, b, dy, dx};
  const int vec = vector_ok(BWD_WIDTH, item, C, x_batch, x_step, ptrs, 5);
  const BwdCall f{x, w, b, dy, dx, dw, db, static_cast<float*>(ws), x_batch,
                  x_step, {B, S, C, sms}, static_cast<cudaStream_t>(stream)};
  return dispatch<BWD_WIDTH, BWD_WIDTH>(dtype, vec, K, f);
}

const char* causal_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
