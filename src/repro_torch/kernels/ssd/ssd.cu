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
// The state S (P x N, float32) starts from the initial state (or 0) and
// its last value is the final state.  cumA is a float32 scan (no fast
// math) in both instances, and the decay differences cumA_i - cumA_j are
// taken in float32: that is where float32 cancellation lives.  Only pairs
// j <= i keep exp(cumA_i - cumA_j) (<= 1 there); the others are set to 0,
// never multiplied by their decay, so an overflow can not meet a zero
// mask and make NaN.  B and C are read by
// group, never repeated to heads; x, B and C are read through their
// strides, so the views that the model's split of the fused projection
// makes need no copy.  The ragged tail is handled here, not padded on the
// host: rows past S load as 0 with dt = 0 (cumA then stays at its last
// real value) and are never stored, so the final state is the one after
// step S-1.
//
// What bounds it on this card: at mamba2's serving shapes (H = 64 heads of
// P = 64, N = 128, G = 1, Q = 256) the causal FLOPs and the bytes are about
// level -- at S = 1024, ~5.4 GFLOP against ~20 MB, each ~6 us at the
// tensor-core bf16 rate and at HBM bandwidth -- so a fast kernel needs the
// tensor cores and a grid that fills the card.  Two instances:
//
// "mma" (bfloat16; P and N 64 or 128; the chunk a multiple of 64; x, B
// and C 16-byte aligned with strides a multiple of 8 elements): the
// chunk-parallel split of Dao & Gu (arXiv:2405.21060 sec. 6), four
// kernels on one stream, no atomics (two calls give the same bits).  The
// TPU grid's sequential chunk axis is not carried over: on Hopper it would
// put each head's chunks on one SM one after another.
//
//   1. ssd_mma_states, grid (chunks, P/64 * N/64, B*H): the chunk's cumA
//      scan (to a small float32 workspace for passes 2 and 3), then a
//      64 x 64 slice of its own state contribution S_c = (w x)^T B, w_j =
//      exp(tot - cumA_j) dt_j, a (64 x Q)(Q x 64) product per block on the
//      tensor cores, its step tiles through a two-stage cp.async ring.  x
//      is scaled by w in float32 and rounded to bf16 once, in registers
//      (B stays exact), so S_c carries one bf16 rounding per term.
//   2. ssd_mma_pass, grid (P*N/256, B*H): the only sequential part, a
//      thread per state element walking the chunks: it writes the state
//      entering each chunk as bf16 hi + lo planes (hi = bf16(s), lo =
//      bf16(s - hi): ~16 bits of the float32 state) and the final state.
//      With one chunk and no initial state it only forms the final state.
//   3a. ssd_mma_scores, grid (tile pairs kt <= qt, chunks, B*G): the
//      scores C B^T of each 64-row query tile and key tile at or before
//      it (64 x 64, depth N), once per group, into a float32 workspace
//      that every head of the group reads (G = 1 in mamba2 and jamba: 64
//      and 128 heads), 16 KB a pair, 0.66 MB at S = 1024.
//   3b. ssd_mma_outputs, grid (64-row query tiles, chunks, B*H): the C
//      tile and the entering state's planes by cp.async, the inter-chunk
//      term C (S_hi + S_lo)^T (two products: the state dominates y late
//      in a long prompt) scaled by exp(cumA_i); then for each key tile at
//      or before the diagonal, its scores from 3a (float4 loads into the
//      accumulator layout, from L2 for all but the first head), masked,
//      decayed and scaled by dt in registers on pairs j <= i only, packed
//      in place to bf16 as the A operand of scores @ x (the accumulator
//      map of m16n8k16 is the A fragment of the next product); then D x,
//      and y is stored in bf16.  On the diagonal tile a warp skips the
//      key columns past its last row.
//
//   The products are `mma.sync.m16n8k16` (bf16 in, f32 accumulate) fed by
//   `ldmatrix` from padded shared rows (conflict-free), tiles staged with
//   `cp.async`.  Not wgmma: at ~5.4 GFLOP a call, mma.sync at a third of
//   the peak is ~16 us, and its 16-row warp tiles take a 64-row tile's
//   ragged edge and the causal skip per warp without a TMA ring's phase
//   bookkeeping.  The decays and pass 1's weights use the MUFU ex2 on
//   cumA in log2 units (the libdevice expf takes a dozen instructions a
//   pair; what it would add, ~1e-6 relative, is lost in the bf16 rounding
//   that follows); cumA itself and pass 2's chunk decays stay expf.  The
//   scores are formed once per group, not per head, by measurement
//   (`study.py` against `per_head_scores.cu`, whose outputs pass loads a
//   B tile and forms C B^T itself; the same bits): on an H100 the shared
//   scores take a call's device time 15-18 % lower at mamba2's serving
//   shapes and 8-10 % at jamba's.  What holds pass 3 back is moving its
//   tiles (with the products removed it kept most of its time), not the
//   tensor cores; 128-row query tiles (half the traffic) and a
//   prefetching ring (fewer blocks an SM) were both no faster.
//
// "simt" (float32, and the shapes the mma instance does not take): the
// first version, scalar FP32 FMAs in true float32 (no TF32: the float32
// gates are 2e-3 on the kernel and 1e-4 on full-width logits); bfloat16
// x, B and C are widened on load.  What its design does:
//
//   * one block per (head, batch row), and a loop over the chunks inside
//     the block takes the place of the Pallas grid's sequential chunk axis;
//     the f32 state (32 KB at P = 64, N = 128) stays in shared memory
//     across chunks;
//   * the Pallas kernel's (Q x Q) f32 score matrix (256 KB at Q = 256) does
//     not fit a block's 227 KB, so the intra-chunk term is tiled: 64-row
//     query tiles, and for each, the 64-row key tiles at or before it
//     (causal: the later ones are never touched) -- scores, then the
//     masked decay, then scores @ x, accumulated in registers;
//   * each thread owns a 4 x (P/16) tile of y and a (P/16) x (N/16) tile
//     of the state update; shared rows are padded to N + 1 floats so the
//     16 rows a half-warp reads at one column fall in distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
  float* enter;          // (B, nc, H, P, N) the state entering each chunk
                         // (for the backward), or null
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
    if (p.enter && (t0 > 0 || p.init)) {
      // kept for the backward: chunk 0's only with an initial state
      const int nc = (p.S + p.Q - 1) / p.Q;
      float* to = p.enter + ((static_cast<long long>(b) * nc + t0 / p.Q) *
                                 p.H + h) * P * N;
      for (int i = tid; i < P * N; i += kThreads)
        to[i] = st[(i / N) * NS + i % N];
    }

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

// ---------------------------------------------------------------------------
// the tensor-core instance ("mma"): chunk-parallel passes
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;     // four warps, 16 rows of a 64-row tile each
constexpr int kRows = 64;         // rows of a query, key, step or P tile
constexpr int kMaxQ = 256;        // the longest chunk
constexpr int kPassThreads = 256;

struct Params {
  const bf16* x;         // (B, S, H, P), strides xs_*
  const float* dt;       // (B, S, H) contiguous
  const float* A;        // (H,)
  const bf16* Bm;        // (B, S, G, N), strides bs_*
  const bf16* Cm;        // (B, S, G, N), strides cs_*
  const float* D;        // (H,)
  const float* init;     // (B, H, P, N) or null
  bf16* y;               // (B, S, H, P) contiguous
  float* fin;            // (B, H, P, N) contiguous
  float* cum;            // (B*H, nc, Qp) cumA of each chunk (workspace)
  float* states;         // (B, nc, H, P, N) S_c (workspace)
  bf16* enter;           // (B, nc, H, 2, P, N) the state entering chunk c
                         // as bf16 hi and lo planes (workspace)
  float* scores;         // (B, nc, G, T, 64 x 64) C B^T of each tile pair
                         // kt <= qt of a chunk (workspace, `pair_tile`)
  int S, H, G, P, N, Q, Qp, nc;
  long long xs_b, xs_s, xs_h, bs_b, bs_s, bs_g, cs_b, cs_s, cs_g;
};

// Shared rows are padded by 8 bf16 (16 bytes): the 8 rows one ldmatrix
// phase reads fall in 8 distinct 16-byte bank groups.
__host__ __device__ constexpr int pad(int width) { return width + 8; }

// Pass 1: a two-stage ring of (x, B) step tiles, cumA, w and the scan's
// warp totals.
__host__ __device__ constexpr size_t states_smem() {
  return sizeof(bf16) * 2 * kRows * 2 * pad(kRows) +
         sizeof(float) * (2 * kMaxQ + 4);
}

// Pass 3a: a query tile's C and a key tile's B.
__host__ __device__ constexpr size_t scores_smem(int N) {
  return sizeof(bf16) * 2 * kRows * pad(N);
}

// Pass 3b, the shared region after the C tile: the entering state's hi
// and lo parts, and later (over them) the key tile's x.
__host__ __device__ constexpr int outputs_region(int P, int N) {
  return 2 * P * pad(N) > kRows * pad(P) ? 2 * P * pad(N) : kRows * pad(P);
}

__host__ __device__ constexpr size_t outputs_smem(int P, int N) {
  return sizeof(bf16) * (kRows * pad(N) + outputs_region(P, N)) +
         sizeof(float) * 2 * kMaxQ;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// d += a (16 x 16, row) b (16 x 8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the MUFU approximation (relative error ~2^-22, subnormals to 0).
// The decays it gives are multiplied into values that are rounded to bf16
// (2^-9) right after, so it costs nothing the result can show; the
// libdevice expf it replaces takes a dozen instructions a pair.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16 pair, the first in the low half (the lower column
// of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows 0 .. ROWS-1 of a (rows, W) bf16 matrix whose rows are `stride`
// elements apart, into dst (row stride ld), by cp.async; rows at or past
// `valid` are 0.  The caller commits and waits.
template <int W, int ROWS = kRows>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long stride, int valid) {
  constexpr int kPer = W / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kPer; i += kThreads) {
    const int r = i / kPer, col = (i - r * kPer) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + col, src + (ok ? r * stride : 0) + col,
               ok ? 16 : 0);
  }
}

// The inclusive scan of dt*A over steps 0 .. Qp-1 of a chunk of L steps
// (dt at dtb, steps ds floats apart; 0 past L, so cumA holds its last
// value there) into cum, and dt into dts.  Rounds of 128 steps: a warp
// shuffle scan, the warps' totals, the last round's carry.
__device__ void chunk_scan(float* cum, float* dts, float* wsum,
                           const float* dtb, long long ds, int L, int Qp,
                           float A) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int r = 0; r < Qp; r += kThreads) {
    const int j = r + tid;
    const float d = j < L ? dtb[j * ds] : 0.f;
    float v = d * A;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    float off = carry;
    for (int k = 0; k < warp; ++k) off += wsum[k];
    cum[j] = off + v;
    dts[j] = d;
    __syncthreads();
    carry = cum[r + kThreads - 1];
  }
}

// Pass 1, block (chunk c, P rows p0 .. p0+63 and N columns n0 .. n0+63,
// head bh): the chunk's cumA (to the workspace) and that slice of its
// state contribution S_c[p, n] = sum_j w_j x[j, p] B[j, n], w_j =
// exp(tot - cumA_j) dt_j.  Warp w owns P rows p0 + 16w .. p0 + 16w + 15.
// The step tiles come through a two-stage cp.async ring, the first one in
// flight during the scan; x^T's fragments are scaled by w in float32 and
// rounded to bf16 once, in registers (B stays exact).  Slicing N as well
// as P lets one kernel serve every d_state; it gives mamba2's 512-step
// prefill 256 blocks rather than 128, and measured no faster for it.
__global__ void __launch_bounds__(kThreads) ssd_mma_states(Params p) {
  constexpr int LX = pad(kRows), LB = pad(kRows);
  constexpr int kStage = kRows * (LX + LB);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);  // 2 x ((64 steps, 64 of
                                                  // P) x, (64 steps, 64 of
                                                  // N) B)
  float* cum = reinterpret_cast<float*>(ring + 2 * kStage);   // (kMaxQ)
  float* wj = cum + kMaxQ;                        // (kMaxQ) dt, then w
  float* wsum = wj + kMaxQ;                       // (4)
  const int n_slices = p.N / kRows;
  const int c = blockIdx.x, bh = blockIdx.z;
  const int p0 = blockIdx.y / n_slices * kRows;
  const int n0 = blockIdx.y % n_slices * kRows;
  const int b = bh / p.H, h = bh - b * p.H, g = h / (p.H / p.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0);
  const int n_tiles = (L + kRows - 1) / kRows;
  const bf16* xb = p.x + b * p.xs_b + static_cast<long long>(t0) * p.xs_s +
                   h * p.xs_h + p0;
  const bf16* bb = p.Bm + b * p.bs_b + static_cast<long long>(t0) * p.bs_s +
                   g * p.bs_g + n0;
  auto load_stage = [&](int t) {
    bf16* xs = ring + (t & 1) * kStage;
    const int j0 = t * kRows, rows = min(kRows, L - j0);
    load_tile<kRows>(xs, LX, xb + static_cast<long long>(j0) * p.xs_s,
                     p.xs_s, rows);
    load_tile<kRows>(xs + kRows * LX, LB,
                     bb + static_cast<long long>(j0) * p.bs_s, p.bs_s, rows);
    cp_async_commit();
  };

  load_stage(0);
  chunk_scan(cum, wj, wsum,
             p.dt + (static_cast<long long>(b) * p.S + t0) * p.H + h, p.H, L,
             p.Qp, p.A[h]);
  if (blockIdx.y == 0) {
    float* out = p.cum + (static_cast<long long>(bh) * p.nc + c) * p.Qp;
    for (int j = tid; j < p.Qp; j += kThreads) out[j] = cum[j];
  }
  const float tot = cum[L - 1];
  for (int j = tid; j < p.Qp; j += kThreads)
    wj[j] = j < L ? ex2((tot - cum[j]) * kLog2e) * wj[j] : 0.f;

  float acc[kRows / 8][4];
#pragma unroll
  for (int nt = 0; nt < kRows / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_stage(t + 1);
      cp_async_wait_one();          // tile t has landed
    } else {
      cp_async_wait_all();
    }
    __syncthreads();                // ... for every thread; w is written
    const bf16* xs = ring + (t & 1) * kStage;
    const bf16* bs = xs + kRows * LX;
    const float* w = wj + t * kRows;
#pragma unroll
    for (int kk = 0; kk < kRows; kk += 16) {
      uint32_t a[4];                // x^T: A[p][j] from x stored (j, p)
      ldsm_x4_trans(a, xs + (kk + (lane & 7) + (lane >> 4) * 8) * LX +
                           warp * 16 + ((lane >> 3) & 1) * 8);
      // a0, a1 hold steps kk + 2(lane % 4) + {0, 1}; a2, a3 those + 8
      const int j = kk + 2 * (lane & 3);
      const float2 w01 = make_float2(w[j], w[j + 1]);
      const float2 w89 = make_float2(w[j + 8], w[j + 9]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&a[r]));
        const float2 ww = r < 2 ? w01 : w89;
        a[r] = pack_bf16(f.x * ww.x, f.y * ww.y);
      }
#pragma unroll
      for (int nt = 0; nt < kRows / 8; nt += 2) {
        uint32_t bq[4];             // B[j][n] stored (j, n)
        ldsm_x4_trans(bq, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LB +
                              nt * 8 + (lane >> 4) * 8);
        mma16816(acc[nt], a, bq[0], bq[1]);
        mma16816(acc[nt + 1], a, bq[2], bq[3]);
      }
    }
    __syncthreads();                // the stage is free for tile t + 2
  }

  // rows p0 + 16w + lane/4 (and + 8), columns n0 + 8nt + 2(lane % 4)
  float* out = p.states +
               ((static_cast<long long>(b) * p.nc + c) * p.H + h) * p.P * p.N +
               static_cast<long long>(p0 + warp * 16 + (lane >> 2)) * p.N +
               n0 + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < kRows / 8; ++nt) {
    *reinterpret_cast<float2*>(out + nt * 8) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + 8 * p.N + nt * 8) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Pass 2, a thread per state element (e of P*N, head bh): walks the
// chunks in order and writes the state entering each chunk (the initial
// state, or none, for the first) as bf16 hi and lo parts, hi = bf16(s)
// and lo = bf16(s - hi), and the final state in float32.
__global__ void __launch_bounds__(kPassThreads) ssd_mma_pass(Params p) {
  const int PN = p.P * p.N, e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= PN) return;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const long long at = static_cast<long long>(bh) * PN + e;
  const float* cum = p.cum + static_cast<long long>(bh) * p.nc * p.Qp;
  const long long chunk_step = static_cast<long long>(p.H) * PN;
  const long long first =
      (static_cast<long long>(b) * p.nc * p.H + h) * PN + e;
  const float* contrib = p.states + first;
  bf16* enter = p.enter + 2 * (first - e) + e;
  // chunk c's total decay, tot_c = cumA at its last step
  auto tot = [&](int c) {
    return cum[static_cast<long long>(c) * p.Qp + min(p.Q, p.S - c * p.Q) - 1];
  };
  float s = p.init ? p.init[at] : 0.f;
  float next = contrib[0], next_tot = tot(0);
  for (int c = 0; c < p.nc; ++c) {
    const float here = next, decay = expf(next_tot);
    if (c + 1 < p.nc) {             // the next chunk's loads in flight
      next = contrib[(c + 1) * chunk_step];
      next_tot = tot(c + 1);
    }
    if (c > 0 || p.init) {
      const bf16 hi = __float2bfloat16(s);
      bf16* to = enter + 2 * c * chunk_step;
      to[0] = hi;
      to[PN] = __float2bfloat16(s - __bfloat162float(hi));
    }
    s = decay * s + here;
  }
  p.fin[at] = s;
}

// The scores workspace: the tile pair (qt, kt <= qt) of chunk c, batch row
// b and group g is 64 x 64 floats at this offset; T = nq (nq + 1) / 2
// pairs of the nq = Qp / 64 tiles of a chunk, pair qt (qt + 1) / 2 + kt.
// Inside a tile, fragment order: thread `lane` of warp w keeps its four
// accumulators of key n8 tile nt at ((w * 8 + nt) * 32 + lane) * 4, one
// float4, so a warp moves 512 contiguous bytes an n8 tile.
__device__ __forceinline__ long long pair_tile(const Params& p, int b, int c,
                                               int g, int qt, int kt) {
  const int nq = p.Qp / kRows, T = nq * (nq + 1) / 2;
  return (((static_cast<long long>(b) * p.nc + c) * p.G + g) * T +
          qt * (qt + 1) / 2 + kt) *
         kRows * kRows;
}

// Pass 3a, block (tile pair, chunk c, batch row and group bg): the scores
// C_i B_j^T of query tile qt and key tile kt <= qt, 64 x 64 of depth N,
// once for every head of the group.  Warp w owns query rows 16w .. 16w +
// 15; on the diagonal it skips the key n8 tiles past its last row (pass
// 3b never reads them).
template <int N>
__global__ void __launch_bounds__(kThreads) ssd_mma_scores(Params p) {
  constexpr int LC = pad(N);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* cs = reinterpret_cast<bf16*>(smem_tc);    // (64 queries, N)
  bf16* bs = cs + kRows * LC;                     // (64 keys, N)
  const int pair = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= pair) ++qt;
  const int kt = pair - qt * (qt + 1) / 2;
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0);
  const int i0 = qt * kRows, j0 = kt * kRows;
  if (i0 >= L) return;              // a tile past the ragged last chunk
  const int b = bg / p.G, g = bg - b * p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* bb = p.Bm + b * p.bs_b + static_cast<long long>(t0) * p.bs_s +
                   g * p.bs_g;
  const bf16* cb = p.Cm + b * p.cs_b + static_cast<long long>(t0) * p.cs_s +
                   g * p.cs_g;
  load_tile<N>(cs, LC, cb + static_cast<long long>(i0) * p.cs_s, p.cs_s,
               min(kRows, L - i0));
  load_tile<N>(bs, LC, bb + static_cast<long long>(j0) * p.bs_s, p.bs_s,
               min(kRows, L - j0));
  cp_async_wait_all();
  __syncthreads();
  // key n8 tiles holding some j <= i of this warp's rows
  const int live = kt == qt ? 2 * warp + 2 : 8;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < N; kk += 16) {
    uint32_t a[4];                  // C[i][n] stored (i, n)
    ldsm_x4(a, cs + (warp * 16 + (lane & 15)) * LC + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      if (nt < live) {
        uint32_t bq[4];             // B[j][n] stored (j, n)
        ldsm_x4(bq, bs + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LC + kk +
                        ((lane >> 3) & 1) * 8);
        mma16816(s[nt], a, bq[0], bq[1]);
        mma16816(s[nt + 1], a, bq[2], bq[3]);
      }
    }
  }
  float4* out = reinterpret_cast<float4*>(p.scores +
                                          pair_tile(p, b, c, g, qt, kt)) +
                warp * 8 * 32 + lane;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    if (nt < live)
      out[nt * 32] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
}

// Pass 3b, block (query tile qt, chunk c, head bh): y for the 64 query
// rows i0 .. i0+63 of the chunk.  Warp w owns rows i0 + 16w .. i0 + 16w +
// 15.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_mma_outputs(Params p) {
  constexpr int LC = pad(N), LX = pad(P);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* cs = reinterpret_cast<bf16*>(smem_tc);    // (64 queries, N)
  bf16* hi = cs + kRows * LC;                     // (P, N) entering state,
  bf16* lo = hi + P * LC;                         //   bf16 hi and lo parts
  bf16* xs = cs + kRows * LC;                     // (64 keys, P), over hi
  float* cum = reinterpret_cast<float*>(cs + kRows * LC +
                                        outputs_region(P, N));
  float* dts = cum + kMaxQ;
  const int qt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0), i0 = qt * kRows;
  if (i0 >= L) return;              // a tile past the ragged last chunk
  const int b = bh / p.H, h = bh - b * p.H, g = h / (p.H / p.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = lane & 3, r0 = warp * 16 + (lane >> 2);   // rows r0, r0+8
  const bf16* xb = p.x + b * p.xs_b + static_cast<long long>(t0) * p.xs_s +
                   h * p.xs_h;
  const bf16* cb = p.Cm + b * p.cs_b + static_cast<long long>(t0) * p.cs_s +
                   g * p.cs_g;

  const float* cum_in = p.cum + (static_cast<long long>(bh) * p.nc + c) * p.Qp;
  const float* dtb = p.dt + (static_cast<long long>(b) * p.S + t0) * p.H + h;
  for (int j = tid; j < i0 + kRows; j += kThreads) {
    cum[j] = cum_in[j] * kLog2e;    // cumA in log2 units, for ex2
    dts[j] = j < L ? dtb[static_cast<long long>(j) * p.H] : 0.f;
  }

  float acc[P / 8][4];
#pragma unroll
  for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  // inter-chunk term: exp(cumA_i) (C_i . S_enter[p, :]), the state as
  // pass 2 split it into bf16 hi + lo (two products)
  if (c > 0 || p.init) {
    const bf16* from =
        p.enter + ((static_cast<long long>(b) * p.nc + c) * p.H + h) * 2 * P * N;
    load_tile<N>(cs, LC, cb + static_cast<long long>(i0) * p.cs_s, p.cs_s,
                 min(kRows, L - i0));
    load_tile<N, P>(hi, LC, from, N, P);
    load_tile<N, P>(lo, LC, from + P * N, N, P);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < N; kk += 16) {
      uint32_t a[4];                // C[i][n] stored (i, n)
      ldsm_x4(a, cs + (warp * 16 + (lane & 15)) * LC + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < P / 8; nt += 2) {
        // S[p][n] stored (p, n): the col-major B of C S^T
        const int off = (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LC + kk +
                        ((lane >> 3) & 1) * 8;
        uint32_t bq[4];
        ldsm_x4(bq, hi + off);
        mma16816(acc[nt], a, bq[0], bq[1]);
        mma16816(acc[nt + 1], a, bq[2], bq[3]);
        ldsm_x4(bq, lo + off);
        mma16816(acc[nt], a, bq[0], bq[1]);
        mma16816(acc[nt + 1], a, bq[2], bq[3]);
      }
    }
    const float e0 = ex2(cum[i0 + r0]), e1 = ex2(cum[i0 + r0 + 8]);
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
  }

  // intra-chunk term over the key tiles at or before this one, their
  // scores from pass 3a
  const int ri0 = i0 + r0, ri1 = ri0 + 8;
  for (int kt = 0; kt <= qt; ++kt) {
    const int j0 = kt * kRows;
    __syncthreads();                // the state's or the last tile's space
    load_tile<P>(xs, LX, xb + static_cast<long long>(j0) * p.xs_s, p.xs_s,
                 min(kRows, L - j0));
    const int live = kt == qt ? 2 * warp + 2 : 8;
    const float4* tile = reinterpret_cast<const float4*>(
                             p.scores + pair_tile(p, b, c, g, qt, kt)) +
                         warp * 8 * 32 + lane;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float4 v = nt < live ? tile[nt * 32] : make_float4(0, 0, 0, 0);
      s[nt][0] = v.x;
      s[nt][1] = v.y;
      s[nt][2] = v.z;
      s[nt][3] = v.w;
    }
    cp_async_wait_all();
    __syncthreads();
    const float ci0 = cum[ri0], ci1 = cum[ri1];
    // mask, decay and dt: below the diagonal tile every pair has j < i;
    // on it, pairs j > i (and past L) are set to 0 by a select, never
    // multiplied by their decay, which may be infinite
    const bool diag = kt == qt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + nt * 8 + 2 * tq + u;
        const float cj = cum[j], dj = dts[j];
        const bool k0 = !diag || (j <= ri0 && j < L);
        const bool k1 = !diag || (j <= ri1 && j < L);
        s[nt][u] = k0 ? s[nt][u] * ex2(ci0 - cj) * dj : 0.f;
        s[nt][2 + u] = k1 ? s[nt][2 + u] * ex2(ci1 - cj) * dj : 0.f;
      }
    // scores @ x: key tiles 2k and 2k+1's accumulators are, packed to
    // bf16, the A fragment of the k-th 16-key slice
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (2 * k < live) {
        const uint32_t a[4] = {pack_bf16(s[2 * k][0], s[2 * k][1]),
                               pack_bf16(s[2 * k][2], s[2 * k][3]),
                               pack_bf16(s[2 * k + 1][0], s[2 * k + 1][1]),
                               pack_bf16(s[2 * k + 1][2], s[2 * k + 1][3])};
#pragma unroll
        for (int nt = 0; nt < P / 8; nt += 2) {
          uint32_t bq[4];           // x[j][p] stored (j, p)
          ldsm_x4_trans(bq, xs + (k * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                     LX + nt * 8 + (lane >> 4) * 8);
          mma16816(acc[nt], a, bq[0], bq[1]);
          mma16816(acc[nt + 1], a, bq[2], bq[3]);
        }
      }
    }
  }

  // skip term (xs holds this tile's own rows), then store
  const float Dh = p.D[h];
  bf16* yb = p.y + ((static_cast<long long>(b) * p.S + t0) * p.H + h) * P;
  const long long ry = static_cast<long long>(p.H) * P;
#pragma unroll
  for (int nt = 0; nt < P / 8; ++nt) {
    const int col = nt * 8 + 2 * tq;
    if (ri0 < L) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + r0 * LX + col));
      *reinterpret_cast<__nv_bfloat162*>(yb + ri0 * ry + col) =
          __floats2bfloat162_rn(acc[nt][0] + Dh * xv.x,
                                acc[nt][1] + Dh * xv.y);
    }
    if (ri1 < L) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + (r0 + 8) * LX + col));
      *reinterpret_cast<__nv_bfloat162*>(yb + ri1 * ry + col) =
          __floats2bfloat162_rn(acc[nt][2] + Dh * xv.x,
                                acc[nt][3] + Dh * xv.y);
    }
  }
}

template <int P, int N>
cudaError_t allow_outputs_smem() {
  return cudaFuncSetAttribute(ssd_mma_outputs<P, N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(outputs_smem(P, N)));
}

cudaError_t init() {
  cudaError_t err = allow_outputs_smem<64, 64>();
  if (err == cudaSuccess) err = allow_outputs_smem<64, 128>();
  if (err == cudaSuccess) err = allow_outputs_smem<128, 64>();
  if (err == cudaSuccess) err = allow_outputs_smem<128, 128>();
  return err;
}

template <int P, int N>
cudaError_t launch_pn(const Params& p, int BH, cudaStream_t s) {
  const int nq = p.Qp / kRows;
  ssd_mma_states<<<dim3(p.nc, P / kRows * (N / kRows), BH), kThreads,
                   states_smem(), s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_mma_pass<<<dim3((P * N + kPassThreads - 1) / kPassThreads, BH),
                 kPassThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_mma_scores<N><<<dim3(nq * (nq + 1) / 2, p.nc, BH / p.H * p.G),
                      kThreads, scores_smem(N), s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_mma_outputs<P, N><<<dim3(nq, p.nc, BH), kThreads, outputs_smem(P, N),
                          s>>>(p);
  return cudaGetLastError();
}

cudaError_t launch(const Params& p, int BH, cudaStream_t s) {
  if (p.P == 64 && p.N == 64) return launch_pn<64, 64>(p, BH, s);
  if (p.P == 64 && p.N == 128) return launch_pn<64, 128>(p, BH, s);
  if (p.P == 128 && p.N == 64) return launch_pn<128, 64>(p, BH, s);
  if (p.P == 128 && p.N == 128) return launch_pn<128, 128>(p, BH, s);
  return cudaErrorInvalidValue;
}

}  // namespace tc

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

// Dynamic shared memory one launch of the simt instance with head dim P
// and d_state N needs, in bytes.
int ssd_smem(int P, int N) { return static_cast<int>(smem_bytes(P, N)); }

// The most dynamic shared memory a block of the mma instance needs (its
// outputs pass), in bytes; 0 for a P or N it does not take.
int ssd_mma_smem(int P, int N) {
  if ((P != 64 && P != 128) || (N != 64 && N != 128)) return 0;
  return static_cast<int>(tc::outputs_smem(P, N));
}

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
  if (err == cudaSuccess) err = tc::init();
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// The simt instance.  dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and
// y); dt, A, D and the states are float32.  init may be null (a zero
// initial state); enter, when not null, receives the float32 state
// entering each chunk c (B, nc, H, P, N), for c > 0 and, with an initial
// state, c = 0.  Strides are in elements.  Returns a cudaError_t (0 =
// launched).
int ssd_launch(int device, int dtype, const void* x, const void* dt,
               const void* A, const void* Bm, const void* Cm, const void* D,
               const void* init, void* y, void* fin, void* enter, int B,
               int S, int H,
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
  p.enter = static_cast<float*>(enter);
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

// The mma instance (bfloat16 x, Bm, Cm and y; P and N 64 or 128; Q at
// most 256), its four kernels on `stream`.  init may be null (a zero
// initial state).  Workspaces: cum holds B*H*nc*Qp floats, states
// B*nc*H*P*N floats, enter 2*B*nc*H*P*N bf16 and scores B*nc*G*T*4096
// floats, nc = ceil(S / Q), Qp = Q rounded up to a multiple of 64, nq =
// Qp / 64 and T = nq*(nq+1)/2; their contents on entry do not matter.  x, Bm and Cm must be 16-byte aligned with strides (in
// elements) a multiple of 8.  Returns a cudaError_t (0 = launched).
int ssd_mma_launch(int device, const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* init, void* y, void* fin, void* cum,
                   void* states, void* enter, void* scores, int B, int S,
                   int H, int P, int G, int N, int Q, long long xs_b,
                   long long xs_s, long long xs_h, long long bs_b,
                   long long bs_s, long long bs_g, long long cs_b,
                   long long cs_s, long long cs_g, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const long long BH = static_cast<long long>(B) * H;
  const int nc = S > 0 && Q > 0 ? (S + Q - 1) / Q : 0;
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0 ||
      Q > tc::kMaxQ || BH > 65535 || nc > 65535 ||
      ssd_mma_smem(P, N) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = static_cast<const __nv_bfloat16*>(Bm);
  p.Cm = static_cast<const __nv_bfloat16*>(Cm);
  p.D = static_cast<const float*>(D);
  p.init = static_cast<const float*>(init);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.fin = static_cast<float*>(fin);
  p.cum = static_cast<float*>(cum);
  p.states = static_cast<float*>(states);
  p.enter = static_cast<__nv_bfloat16*>(enter);
  p.scores = static_cast<float*>(scores);
  p.S = S;
  p.H = H;
  p.G = G;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.Qp = (Q + tc::kRows - 1) / tc::kRows * tc::kRows;
  p.nc = nc;
  p.xs_b = xs_b;
  p.xs_s = xs_s;
  p.xs_h = xs_h;
  p.bs_b = bs_b;
  p.bs_s = bs_s;
  p.bs_g = bs_g;
  p.cs_b = cs_b;
  p.cs_s = cs_s;
  p.cs_g = cs_g;
  return static_cast<int>(
      tc::launch(p, static_cast<int>(BH), static_cast<cudaStream_t>(stream)));
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
