// Hopper chunked SSD: the Mamba2 state-space scan of a whole prompt.
//
// Replaces the Pallas TPU kernel `ssd_pallas` / `_ssd_kernel`
// (src/repro/kernels/ssd/kernel.py:113) of the JAX package; the plain
// PyTorch version it is held against is `ops.py::ssd_chunked`, and both
// are held against the sequential oracle `ref.py::ssd_reference`.
//
// What it computes, for each batch row b and head h (group g = h / (H/G)),
// chunk by chunk over the sequence (chunk length Q, the last one ragged),
// with cumA the inclusive cumulative sum of dt*A within the chunk and tot
// its last value:
//
//   y_i = sum_{j<=i} (C_i . B_j) exp(cumA_i - cumA_j) dt_j x_j   intra-chunk
//       + exp(cumA_i) S_prev C_i                                  inter-chunk
//       + D x_i                                                   skip
//   S   = exp(tot) S_prev + sum_j exp(tot - cumA_j) dt_j x_j (outer) B_j
//
// in true float32 (expf without fast math, no TF32); bfloat16 x, B and C
// are widened on load and y is rounded to x's dtype on store.  The state S
// (P x N) starts from the initial state (or 0) and its last value is the
// final state.
//
// What bounds it on this card: at mamba2's serving shapes (H = 64 heads of
// P = 64, N = 128, G = 1, Q = 256) the causal FLOPs and the bytes are about
// level -- at S = 1024, ~5.4 GFLOP against ~20 MB, each ~6 us at the
// tensor-core bf16 rate and at HBM bandwidth -- so a fast kernel needs the
// tensor cores and a grid that fills the card.  This first version is a
// scalar FP32-FMA kernel fed from shared memory: right first, fast in a
// later change.  What its design does:
//
//   * one block per (head, batch row), and a loop over the chunks inside
//     the block takes the place of the Pallas grid's sequential chunk axis;
//     the f32 state (32 KB at P = 64, N = 128) stays in shared memory
//     across chunks.  At the serving prefill (B = 1) that is 64 blocks on
//     132 SMs; splitting a head across blocks is later work;
//   * the Pallas kernel's (Q x Q) f32 score matrix (256 KB at Q = 256) does
//     not fit a block's 227 KB, so the intra-chunk term is tiled: 64-row
//     query tiles, and for each, the 64-row key tiles at or before it
//     (causal: the later ones are never touched) -- scores, then the
//     masked decay, then scores @ x, accumulated in registers;
//   * only pairs j <= i get exp(cumA_i - cumA_j) (<= 1 there); the others
//     are set to 0 and never exponentiated, so an overflow can not meet a
//     zero mask and make NaN;
//   * B and C are read by group, g = h / (H/G), never repeated to heads;
//     x, B and C are read through their strides, so the views that the
//     model's split of the fused projection makes need no copy;
//   * the ragged tail is handled here, not padded on the host: rows past
//     S load as 0 with dt = 0 (cumA then stays at its last real value) and
//     are never stored, so the final state is the one after step S-1;
//   * each thread owns a 4 x (P/16) tile of y and a (P/16) x (N/16) tile
//     of the state update; shared rows are padded to N + 1 floats so the
//     16 rows a half-warp reads at one column fall in distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows of a query or key tile
constexpr int kMaxQ = 256;       // the longest chunk
constexpr int kMaxN = 128;       // the largest d_state
constexpr int kGs = kTile + 1;   // row stride of the score tile
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kMaxQ, "one thread per step of a chunk");
static_assert(kTile == 4 * (kThreads / 16), "4 rows per thread row");

struct Params {
  const void* x;         // (B, S, H, P), strides xs_*
  const float* dt;       // (B, S, H) contiguous
  const float* A;        // (H,)
  const void* Bm;        // (B, S, G, N), strides bs_*
  const void* Cm;        // (B, S, G, N), strides cs_*
  const float* D;        // (H,)
  const float* init;     // (B, H, P, N) or null
  void* y;               // (B, S, H, P) contiguous
  float* fin;            // (B, H, P, N) contiguous
  int S, H, G, N, Q;
  long long xs_b, xs_s, xs_h, bs_b, bs_s, bs_g, cs_b, cs_s, cs_g;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Rows row0 .. row0 + kTile - 1 of a (rows, width) matrix whose rows are
// `stride` elements apart, widened to f32 into dst (row stride ld); rows
// at or past `valid` are 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long stride, int row0,
                                          int valid, int width) {
  for (int i = threadIdx.x; i < kTile * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    dst[r * ld + c] =
        r < valid ? to_f32(src[static_cast<long long>(row0 + r) * stride + c])
                  : 0.f;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Params p) {
  constexpr int kCols = P / 16;     // y columns and state rows per thread
  extern __shared__ float smem[];
  const int N = p.N, NS = N + 1, nb = N / 16;
  float* st = smem;                 // (P, NS)  the state
  float* cs = st + P * NS;          // (kTile, NS)  C of the query tile
  float* bs = cs + kTile * NS;      // (kTile, NS)  B of the key tile
  float* xs = bs + kTile * NS;      // (kTile, P)   x of the key tile
  float* gs = xs + kTile * P;       // (kTile, kGs) masked, decayed scores
  float* cum = gs + kTile * kGs;    // (kMaxQ)  cumA within the chunk
  float* dts = cum + kMaxQ;         // (kMaxQ)  dt, 0 past the end
  float* ecum = dts + kMaxQ;        // (kMaxQ)  exp(cumA)
  float* wj = ecum + kMaxQ;         // (kMaxQ)  exp(tot - cumA) dt
  float* wsum = wj + kMaxQ;         // (8)      warp totals of the scan

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const T* xb = static_cast<const T*>(p.x) + b * p.xs_b + h * p.xs_h;
  const T* bb = static_cast<const T*>(p.Bm) + b * p.bs_b + g * p.bs_g;
  const T* cb = static_cast<const T*>(p.Cm) + b * p.cs_b + g * p.cs_g;
  const float* dtb = p.dt + static_cast<long long>(b) * p.S * p.H + h;
  T* yb = static_cast<T*>(p.y) +
          (static_cast<long long>(b) * p.S * p.H + h) * P;
  const long long row_y = static_cast<long long>(p.H) * P;
  const float A = p.A[h], Dh = p.D[h];
  const long long sbase = (static_cast<long long>(b) * p.H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads)
    st[(i / N) * NS + i % N] = p.init ? p.init[sbase + i] : 0.f;

  for (int t0 = 0; t0 < p.S; t0 += p.Q) {
    const int L = min(p.Q, p.S - t0);
    const int n_tiles = (L + kTile - 1) / kTile;
    __syncthreads();                // the last chunk is done with cum..wj

    // dt and the inclusive scan of dt*A over the chunk; past L the terms
    // are 0, so cumA stays at cum[L-1] and the weights are 0
    float d = 0.f, v = 0.f;
    if (tid < L) {
      d = dtb[static_cast<long long>(t0 + tid) * p.H];
      v = d * A;
    }
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int k = 0; k < warp; ++k) v += wsum[k];
    cum[tid] = v;
    dts[tid] = d;
    ecum[tid] = expf(v);
    __syncthreads();
    const float tot = cum[L - 1];
    wj[tid] = expf(tot - v) * d;

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int i0 = qt * kTile, qrows = min(kTile, L - i0);
      __syncthreads();              // cs is free
      load_rows(cs, NS, cb, p.cs_s, t0 + i0, qrows, N);
      __syncthreads();

      // inter-chunk term: exp(cumA_i) * (S_prev C_i)
      float acc[4][kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[kCols];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * NS + n];
#pragma unroll
        for (int c = 0; c < kCols; ++c) sv[c] = st[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[a][c] += cv[a] * sv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = ecum[i0 + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[a][c] *= e;
      }

      // intra-chunk term over the key tiles at or before this one
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * kTile;
        __syncthreads();            // bs, xs and gs are free
        load_rows(bs, NS, bb, p.bs_s, t0 + j0, min(kTile, L - j0), N);
        load_rows(xs, P, xb, p.xs_s, t0 + j0, min(kTile, L - j0), P);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[a][e] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * NS + n];
#pragma unroll
          for (int e = 0; e < 4; ++e) bv[e] = bs[(tx + 16 * e) * NS + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[a][e] += cv[a] * bv[e];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + tx + 16 * e;
            gs[(ty + 16 * a) * kGs + tx + 16 * e] =
                j <= i && j < L ? s[a][e] * expf(cum[i] - cum[j]) * dts[j]
                                : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < kTile; ++j) {
          float gv[4], xv[kCols];
#pragma unroll
          for (int a = 0; a < 4; ++a) gv[a] = gs[(ty + 16 * a) * kGs + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) xv[c] = xs[j * P + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[a][c] += gv[a] * xv[c];
        }
      }

      // skip term (xs now holds this tile's own rows), then store
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        if (r < qrows) {
          T* out = yb + static_cast<long long>(t0 + i0 + r) * row_y;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            out[tx + 16 * c] =
                from_f32<T>(acc[a][c] + Dh * xs[r * P + tx + 16 * c]);
        }
      }
    }

    // state update: S = exp(tot) S + sum_j x_j (outer) (w_j B_j)
    float su[kCols][kMaxN / 16];
#pragma unroll
    for (int a = 0; a < kCols; ++a)
#pragma unroll
      for (int e = 0; e < kMaxN / 16; ++e) su[a][e] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int j0 = kt * kTile;
      __syncthreads();
      load_rows(bs, NS, bb, p.bs_s, t0 + j0, min(kTile, L - j0), N);
      load_rows(xs, P, xb, p.xs_s, t0 + j0, min(kTile, L - j0), P);
      __syncthreads();
      for (int j = 0; j < kTile; ++j) {
        const float w = wj[j0 + j];
        float xv[kCols];
#pragma unroll
        for (int a = 0; a < kCols; ++a) xv[a] = xs[j * P + ty + 16 * a] * w;
#pragma unroll
        for (int e = 0; e < kMaxN / 16; ++e) {
          if (e < nb) {
            const float bv = bs[j * NS + tx + 16 * e];
#pragma unroll
            for (int a = 0; a < kCols; ++a) su[a][e] += xv[a] * bv;
          }
        }
      }
    }
    const float et = expf(tot);
#pragma unroll
    for (int a = 0; a < kCols; ++a)
#pragma unroll
      for (int e = 0; e < kMaxN / 16; ++e)
        if (e < nb) {
          float* sp = st + (ty + 16 * a) * NS + tx + 16 * e;
          *sp = et * *sp + su[a][e];
        }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    p.fin[sbase + i] = st[(i / N) * NS + i % N];
}

size_t smem_bytes(int P, int N) {
  const int NS = N + 1;
  return sizeof(float) * (static_cast<size_t>(P) * NS + 2 * kTile * NS +
                          kTile * P + kTile * kGs + 4 * kMaxQ + 8);
}

template <typename T, int P>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(ssd_kernel<T, P>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
cudaError_t init_dtype(int bytes) {
  cudaError_t err = allow_smem<T, 16>(bytes);
  if (err == cudaSuccess) err = allow_smem<T, 32>(bytes);
  if (err == cudaSuccess) err = allow_smem<T, 64>(bytes);
  if (err == cudaSuccess) err = allow_smem<T, 128>(bytes);
  return err;
}

template <typename T>
cudaError_t launch_dtype(int P, const Params& p, int B, cudaStream_t s) {
  const dim3 grid(p.H, B);
  const size_t smem = smem_bytes(P, p.N);
  switch (P) {
    case 16: ssd_kernel<T, 16><<<grid, kThreads, smem, s>>>(p); break;
    case 32: ssd_kernel<T, 32><<<grid, kThreads, smem, s>>>(p); break;
    case 64: ssd_kernel<T, 64><<<grid, kThreads, smem, s>>>(p); break;
    case 128: ssd_kernel<T, 128><<<grid, kThreads, smem, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

struct DeviceScope {
  int prev = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    else prev = -1;
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// Dynamic shared memory one launch with head dim P and d_state N needs,
// in bytes.
int ssd_smem(int P, int N) { return static_cast<int>(smem_bytes(P, N)); }

// Once per device, before its first launch: lets every template use the
// largest dynamic shared memory a block may have there, and returns that
// size in bytes (or minus a cudaError_t).
int ssd_init(int device) {
  int bytes = 0;
  DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess) err = init_dtype<float>(bytes);
  if (err == cudaSuccess) err = init_dtype<__nv_bfloat16>(bytes);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y); dt, A, D and the
// states are float32.  init may be null (a zero initial state).  Strides
// are in elements.  Returns a cudaError_t (0 = launched).
int ssd_launch(int device, int dtype, const void* x, const void* dt,
               const void* A, const void* Bm, const void* Cm, const void* D,
               const void* init, void* y, void* fin, int B, int S, int H,
               int P, int G, int N, int Q, long long xs_b, long long xs_s,
               long long xs_h, long long bs_b, long long bs_s, long long bs_g,
               long long cs_b, long long cs_s, long long cs_g, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 ||
      N % 16 != 0 || N > kMaxN || Q <= 0 || Q > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.Cm = Cm;
  p.D = static_cast<const float*>(D);
  p.init = static_cast<const float*>(init);
  p.y = y;
  p.fin = static_cast<float*>(fin);
  p.S = S;
  p.H = H;
  p.G = G;
  p.N = N;
  p.Q = Q;
  p.xs_b = xs_b;
  p.xs_s = xs_s;
  p.xs_h = xs_h;
  p.bs_b = bs_b;
  p.bs_s = bs_s;
  p.bs_g = bs_g;
  p.cs_b = cs_b;
  p.cs_s = cs_s;
  p.cs_g = cs_g;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_dtype<float>(P, p, B, s)
                               : launch_dtype<__nv_bfloat16>(P, p, B, s);
  return static_cast<int>(err);
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
