// Hopper backward of the chunked SSD scan: the gradients of y and of the
// final state with respect to x, dt, A, B, C, D and the initial state.
//
// The JAX package has no Pallas backward: it differentiates its plain
// chunked scan `ssd_chunked_jnp` (src/repro/kernels/ssd/ops.py:32).  The
// plain PyTorch version this kernel is held against is
// `ref.py::ssd_backward_reference`, whose docstring gives the formulas.
// Per batch row b, head h (group g) and chunk c of L steps, with a = dt A,
// cum its inclusive cumsum over the chunk, tot = cum_{L-1}, L_ij =
// exp(cum_i - cum_j) on j <= i, w_j = exp(tot - cum_j) dt_j, S_prev the
// state entering the chunk and G_c the gradient of the state leaving it:
//
//   a. U_c = sum_i exp(cum_i) dy_i^T C_i (P x N), chunk-parallel; cum of
//      each chunk into a small workspace that the later passes read.
//   b. G_{c-1} = exp(tot_c) G_c + U_c walked from the last chunk (dfinal,
//      or 0) to the first, a thread per state element; G_c kept per chunk,
//      the gradient of the initial state, and per-block partials of
//      <G_c, S_prev_c>.
//   c1. per (64-step key tile j, chunk, split of heads): for each head of
//      the split, the query tiles i >= j: S^T = B_j C_i^T and dY^T = x_j
//      dy_i^T, masked and decayed on pairs j <= i only, then
//        dx_j  += (S^T L dt) dy_i,     dB_j += (dY^T L dt) C_i,
//      beside the state terms w_j G_c B_j and w_j G_c^T x_j and D dy_j;
//      ddt's direct part  sum_i S L dY + exp(tot - cum_j) x_j.G_c B_j, and
//      dcum's key-side part -dt_j sum_{i>j} S L dY, and T_j = w_j x_j.G_c
//      B_j.  dB sums over the split's heads in registers, in order.
//   c2. per (64-step query tile i, chunk, split of heads): the key tiles j
//      <= i: S = C_i B_j^T, dY = dy_i x_j^T, dC_i += (dY L dt) B_j, beside
//      exp(cum_i) S_prev^T dy_i; dcum_i = sum_{j<i} M_ij + dy_i.y_inter_i
//      + c1's part, M = S L dt dY, y_inter_i = exp(cum_i) S_prev C_i (C_i
//      dotted with the dC state term: no extra product).  The diagonal
//      M_ii, which dcum adds and takes away, is left out of both sums.
//   d. fixed-order reductions: da_j = sum_{i>=j} dcum_i + sum_{i<j} T_i +
//      exp(tot) <G_c, S_prev_c> (the gradients of tot, <G_c, S_after_c>,
//      and of the weights w, -T, folded so that they do not cancel), ddt
//      += A da and dA's partial sum dt da per chunk; dB and dC over each
//      group's splits; dA and dD over batch rows, chunks and tiles.
//
// No atomics: every sum runs in a fixed order, so two calls give the same
// bits.  Only pairs j <= i are exponentiated (the others are set to 0 by a
// select, never multiplied by a decay that may be infinite).  cum and tot
// are float32 scans without fast math.  The ragged tail is handled here,
// not padded on the host: rows past the chunk's end load as 0 with dt = 0
// and are never stored.  x, B and C are read through their strides (the
// views of the model's fused projection); dy, dx, dB and dC are
// contiguous.  The split of heads: a block walks Hs heads of one group (the
// largest divisor of the group's heads up to 8), so the per-split dB and
// dC partials are (H / Hs) / H of per-head ones -- at mamba2's B = 8, S =
// 512 (64 heads, N 128) 16.8 MB each instead of 134 MB -- while the grid
// keeps 4 x 2 x 8 x 8 = 512 blocks.
//
// The state entering each chunk comes from the forward (the `keep`
// workspace of ssd.cu): float32 from the SIMT instance, bf16 hi + lo
// planes (~16 bits) from the tensor-core one; chunk 0's is the initial
// state or 0.
//
// Two instances, as in the forward:
//   "simt": f32 FMAs from shared memory (bf16 operands widened on load);
//     float32 keeps its gates without TF32.  256 threads, a thread owning
//     4 rows x (cols / 16) of each tile.
//   "mma" (bfloat16, P and N 64 or 128, 16-byte aligned rows): passes a,
//     c1 and c2 on mma.sync.m16n8k16 (bf16 in, f32 accumulate), tiles by
//     cp.async into padded shared rows, fragments by ldmatrix; the masked,
//     decayed products S L dt and dY L dt are rounded to bf16 as the A
//     operand of the next product straight from the accumulators; G_c and
//     S_prev enter their products as bf16 hi + lo (two products each);
//     ddt and dcum are formed from the float32 accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;        // steps of a key or query tile
constexpr int kMaxQ = 256;       // the longest chunk
constexpr int kMaxN = 128;       // the largest d_state
constexpr int kMaxSplit = 8;     // the most heads a block walks
constexpr int kPassThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* x;         // (B, S, H, P), strides xs_*
  const float* dt;       // (B, S, H) contiguous
  const float* A;        // (H,)
  const void* Bm;        // (B, S, G, N), strides bs_*
  const void* Cm;        // (B, S, G, N), strides cs_*
  const float* D;        // (H,)
  const void* dy;        // (B, S, H, P) contiguous
  const void* enter;     // the state entering each chunk: float32 (B, nc,
                         // H, P, N) or bf16 hi, lo (B, nc, H, 2, P, N)
  const float* dfinal;   // (B, H, P, N) or null (0)
  void* dx;              // (B, S, H, P) contiguous
  float* ddt;            // (B, S, H)
  float* dA;             // (H,)
  void* dB;              // (B, S, G, N) contiguous
  void* dC;              // (B, S, G, N) contiguous
  float* dD;             // (H,)
  float* dinit;          // (B, H, P, N) or null
  // workspace (`Workspace`)
  float* cum;            // (B*H, nc, Qp)
  float* U;              // (B, nc, H, P, N)
  void* Gs;              // G_c: float32 (B, nc, H, P, N) or bf16 hi, lo
  float* gdot;           // (B*H, nc, nblk) partials of <G_c, S_prev_c>
  float* dcum;           // (B, S, H) c1's part, then dcum
  float* tj;             // (B, S, H) T_j = w_j x_j.G_c B_j
  float* dbp;            // (B, S, nsplit, N) dB over a split's heads
  float* dcp;            // (B, S, nsplit, N) dC over a split's heads
  float* dDp;            // (B*H, nc, Qp / 64) sum dy.x of a key tile
  float* dAp;            // (B*H, nc) sum dt da of a chunk
  int Bsz, S, H, G, P, N, Q, Qp, nc, Hs, nsplit, nblk;
  int has_init, enter_f32;
  long long xs_b, xs_s, xs_h, bs_b, bs_s, bs_g, cs_b, cs_s, cs_g;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ inline int heads_per_split(int heads_in_group) {
  int hs = 1;
  for (int d = 1; d <= kMaxSplit; ++d)
    if (heads_in_group % d == 0) hs = d;
  return hs;
}

// offset of the (P, N) state of (b, chunk c, h) in a (B, nc, H, P, N) array
__device__ __forceinline__ long long state_at(const Params& p, int b, int c,
                                              int h) {
  return ((static_cast<long long>(b) * p.nc + c) * p.H + h) * p.P * p.N;
}

// element e of the state entering chunk c (0 for chunk 0 without an
// initial state), from either format
__device__ __forceinline__ float enter_elem(const Params& p, int b, int c,
                                            int h, int e) {
  if (c == 0 && !p.has_init) return 0.f;
  const long long at = state_at(p, b, c, h);
  if (p.enter_f32) return static_cast<const float*>(p.enter)[at + e];
  const bf16* hl = static_cast<const bf16*>(p.enter) + 2 * at;
  return __bfloat162float(hl[e]) + __bfloat162float(hl[p.P * p.N + e]);
}

// The sum of v over the block, in a fixed order, in thread 0; red holds
// one float a warp.  Every thread must call it.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

// The inclusive scan of dt*A over steps 0 .. Qp-1 of a chunk of L steps
// (dt at dtb, steps ds floats apart; 0 past L, so cum keeps its last value
// there) into cum, and dt into dts.  Rounds of THREADS steps.
template <int THREADS>
__device__ void chunk_scan(float* cum, float* dts, float* wsum,
                           const float* dtb, long long ds, int L, int Qp,
                           float A) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int r = 0; r < Qp; r += THREADS) {
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
    if (j < Qp) {
      cum[j] = off + v;
      dts[j] = d;
    }
    __syncthreads();
    carry = cum[min(r + THREADS, Qp) - 1];
  }
}

// ---------------------------------------------------------------------------
// pass b and pass d: both instances
// ---------------------------------------------------------------------------

// Pass b, a thread per state element (e of P*N, head bh): G from dfinal
// (or 0) back over the chunks; G_c stored (float32, or with HILO as bf16
// hi and lo planes), the block's part of <G_c, S_prev_c> per chunk, and
// the gradient of the initial state.
template <bool HILO>
__global__ void __launch_bounds__(kPassThreads) ssd_bwd_pass(Params p) {
  __shared__ float red[kPassThreads / 32];
  const int PN = p.P * p.N, e = blockIdx.x * kPassThreads + threadIdx.x;
  const bool ok = e < PN;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const long long at = static_cast<long long>(bh) * PN + e;
  const float* cum = p.cum + static_cast<long long>(bh) * p.nc * p.Qp;
  float g = ok && p.dfinal ? p.dfinal[at] : 0.f;
  for (int c = p.nc - 1; c >= 0; --c) {
    const long long sc = state_at(p, b, c, h);
    float prev = 0.f, u = 0.f;
    if (ok) {
      if (HILO) {
        bf16* to = static_cast<bf16*>(p.Gs) + 2 * sc;
        const bf16 hi = __float2bfloat16(g);
        to[e] = hi;
        to[PN + e] = __float2bfloat16(g - __bfloat162float(hi));
      } else {
        static_cast<float*>(p.Gs)[sc + e] = g;
      }
      prev = enter_elem(p, b, c, h, e);
      u = p.U[sc + e];
    }
    const float part = block_sum<kPassThreads>(g * prev, red);
    if (threadIdx.x == 0)
      p.gdot[(static_cast<long long>(bh) * p.nc + c) * p.nblk + blockIdx.x] =
          part;
    const float tot = cum[static_cast<long long>(c) * p.Qp +
                          min(p.Q, p.S - c * p.Q) - 1];
    g = expf(tot) * g + u;
  }
  if (ok && p.dinit) p.dinit[at] = g;
}

// The inclusive scan of v over the block's kMaxQ threads, in thread order.
__device__ __forceinline__ float block_scan(float v, float* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int k = 0; k < warp; ++k) v += wsum[k];
  __syncthreads();
  return v;
}

// Pass d1, block (chunk c, head bh), a thread per step: da_j = sum_{i>=j}
// dcum_i + sum_{i<j} T_i + exp(tot) <G_c, S_prev_c>, ddt += A da, and the
// chunk's sum of dt da.
__global__ void __launch_bounds__(kMaxQ) ssd_bwd_dcum(Params p) {
  __shared__ float wsum[kMaxQ / 32];
  __shared__ float red[kMaxQ / 32];
  __shared__ float rev[kMaxQ];     // sum_{i>=j} dcum_i
  __shared__ float fwd[kMaxQ];     // sum_{i<=j} T_i
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0);
  const int tid = threadIdx.x;
  const float* gd = p.gdot + (static_cast<long long>(bh) * p.nc + c) * p.nblk;
  float dprev = 0.f;
  for (int k = 0; k < p.nblk; ++k) dprev += gd[k];
  const float tot =
      p.cum[(static_cast<long long>(bh) * p.nc + c) * p.Qp + L - 1];
  const float carried = expf(tot) * dprev;
  const long long row = static_cast<long long>(b) * p.S + t0;
  const bool ok = tid < L;
  // thread tid takes step L-1-tid for the reverse sum, step tid for T's
  const float r = block_scan(
      ok ? p.dcum[(row + L - 1 - tid) * p.H + h] : 0.f, wsum);
  const float f = block_scan(ok ? p.tj[(row + tid) * p.H + h] : 0.f, wsum);
  if (ok) {
    rev[L - 1 - tid] = r;
    fwd[tid] = f;
  }
  __syncthreads();
  float part = 0.f;
  if (ok) {
    const long long at = (row + tid) * p.H + h;
    const float da = rev[tid] + (tid > 0 ? fwd[tid - 1] : 0.f) + carried;
    p.ddt[at] += p.A[h] * da;
    part = p.dt[at] * da;
  }
  const float total = block_sum<kMaxQ>(part, red);
  if (tid == 0) p.dAp[static_cast<long long>(bh) * p.nc + c] = total;
}

// Pass d2, a thread per element of dB and dC: the group's splits in order.
template <typename T>
__global__ void __launch_bounds__(kPassThreads) ssd_bwd_group_sums(Params p) {
  const long long total =
      static_cast<long long>(p.Bsz) * p.S * p.G * p.N;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % p.N);
  const long long rest = idx / p.N;
  const int g = static_cast<int>(rest % p.G);
  const long long bt = rest / p.G;
  const int per = p.nsplit / p.G;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < per; ++k) {
    const long long o = (bt * p.nsplit + g * per + k) * p.N + n;
    sb += p.dbp[o];
    sc += p.dcp[o];
  }
  static_cast<T*>(p.dB)[idx] = from_f32<T>(sb);
  static_cast<T*>(p.dC)[idx] = from_f32<T>(sc);
}

// Pass d3, a block per head: dA and dD over batch rows, chunks and the
// key tiles of each chunk, in order.
__global__ void ssd_bwd_head_sums(Params p) {
  if (threadIdx.x != 0) return;
  const int h = blockIdx.x, nt = p.Qp / kRows;
  float a = 0.f, d = 0.f;
  for (int b = 0; b < p.Bsz; ++b) {
    const long long bh = static_cast<long long>(b) * p.H + h;
    for (int c = 0; c < p.nc; ++c) {
      a += p.dAp[bh * p.nc + c];
      const int L = min(p.Q, p.S - c * p.Q);
      for (int k = 0; k * kRows < L; ++k) d += p.dDp[(bh * p.nc + c) * nt + k];
    }
  }
  p.dA[h] = a;
  p.dD[h] = d;
}

// ---------------------------------------------------------------------------
// the SIMT instance: f32 FMAs from shared memory
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kThreads = 256;
constexpr int kGs = kRows + 1;   // row stride of a 64 x 64 tile

// Rows row0 .. row0 + 63 of a (rows, width) matrix whose rows are `stride`
// elements apart, widened to f32 into dst (row stride ld); rows at or past
// `valid` are 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long stride, int row0,
                                          int valid, int width) {
  for (int i = threadIdx.x; i < kRows * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    dst[r * ld + c] =
        r < valid ? to_f32(src[static_cast<long long>(row0 + r) * stride + c])
                  : 0.f;
  }
}

// Pass a: block (chunk c, head bh), U_c = sum_i exp(cum_i) dy_i^T C_i, and
// cum into the workspace.  Thread (ty, tx) owns rows ty + 16a of P and
// columns tx + 16e of N.
__host__ __device__ constexpr size_t states_smem(int P, int N) {
  return sizeof(float) * (static_cast<size_t>(kRows) * P + kRows * (N + 1) +
                          2 * kMaxQ + 8);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_states(Params p) {
  constexpr int kC = P / 16;
  extern __shared__ float smem[];
  const int N = p.N, NS = N + 1, nb = N / 16;
  float* dys = smem;                 // (64, P)
  float* cs = dys + kRows * P;       // (64, NS)
  float* cum = cs + kRows * NS;      // (kMaxQ)
  float* ecum = cum + kMaxQ;         // (kMaxQ) dt, then exp(cum)
  float* wsum = ecum + kMaxQ;        // (8)
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0);
  const int n_tiles = (L + kRows - 1) / kRows;
  const T* dyb = static_cast<const T*>(p.dy) +
                 (static_cast<long long>(b) * p.S + t0) * p.H * P + h * P;
  const T* cb = static_cast<const T*>(p.Cm) + b * p.cs_b +
                static_cast<long long>(t0) * p.cs_s + g * p.cs_g;
  chunk_scan<kThreads>(cum, ecum, wsum,
                       p.dt + (static_cast<long long>(b) * p.S + t0) * p.H + h,
                       p.H, L, p.Qp, p.A[h]);
  float* out = p.cum + (static_cast<long long>(bh) * p.nc + c) * p.Qp;
  for (int j = tid; j < p.Qp; j += kThreads) {
    out[j] = cum[j];
    ecum[j] = expf(cum[j]);
  }
  float acc[kC][kMaxN / 16];
#pragma unroll
  for (int a = 0; a < kC; ++a)
#pragma unroll
    for (int e = 0; e < kMaxN / 16; ++e) acc[a][e] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * kRows, rows = min(kRows, L - j0);
    __syncthreads();
    load_rows(dys, P, dyb, static_cast<long long>(p.H) * P, j0, rows, P);
    load_rows(cs, NS, cb, p.cs_s, j0, rows, N);
    __syncthreads();
    for (int j = 0; j < kRows; ++j) {
      const float ev = ecum[j0 + j];
      float dv[kC];
#pragma unroll
      for (int a = 0; a < kC; ++a) dv[a] = dys[j * P + ty + 16 * a] * ev;
#pragma unroll
      for (int e = 0; e < kMaxN / 16; ++e) {
        if (e < nb) {
          const float cv = cs[j * NS + tx + 16 * e];
#pragma unroll
          for (int a = 0; a < kC; ++a) acc[a][e] += dv[a] * cv;
        }
      }
    }
  }
  float* u = p.U + state_at(p, b, c, h);
#pragma unroll
  for (int a = 0; a < kC; ++a)
#pragma unroll
    for (int e = 0; e < kMaxN / 16; ++e)
      if (e < nb) u[(ty + 16 * a) * N + tx + 16 * e] = acc[a][e];
}

// Pass c1 and c2's shared memory: two (64, N) and two (64, P) step tiles
// beside a region that holds a (P, N) state first and 64 x 64 tiles later.
__host__ __device__ constexpr size_t region_floats(int P, int N, int tiles) {
  return static_cast<size_t>(P) * (N + 1) >
                 static_cast<size_t>(kRows) * (N + 1) + kRows * (P + 1) +
                     tiles * kRows * kGs
             ? static_cast<size_t>(P) * (N + 1)
             : static_cast<size_t>(kRows) * (N + 1) + kRows * (P + 1) +
                   tiles * kRows * kGs;
}

__host__ __device__ constexpr size_t keys_smem(int P, int N) {
  return sizeof(float) * (static_cast<size_t>(kRows) * (N + 1) +
                          kRows * (P + 1) + region_floats(P, N, 2) +
                          2 * kMaxQ + 8);
}

__host__ __device__ constexpr size_t queries_smem(int P, int N) {
  return sizeof(float) * (static_cast<size_t>(kRows) * (N + 1) +
                          kRows * (P + 1) + region_floats(P, N, 1) +
                          2 * kMaxQ + 8);
}

// the chunk's cum (from pass a) and dt (0 past L) of head h
__device__ __forceinline__ void load_cum_dt(const Params& p, float* cum,
                                           float* dts, int b, int h, int c,
                                           int t0, int L, int threads,
                                           float scale) {
  const float* from =
      p.cum + ((static_cast<long long>(b) * p.H + h) * p.nc + c) * p.Qp;
  for (int j = threadIdx.x; j < p.Qp; j += threads) {
    cum[j] = from[j] * scale;
    dts[j] = j < L ? p.dt[(static_cast<long long>(b) * p.S + t0 + j) * p.H + h]
                   : 0.f;
  }
}

// Pass c1, block (key tile kt, chunk c, batch row and split): dx, ddt's
// direct part, the split's dB.  Thread (ty, tx) owns key rows ty + 16a
// (a < 4) and columns tx + 16k of every tile.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_keys(Params p) {
  constexpr int kC = P / 16, PS = P + 1;
  extern __shared__ float smem[];
  const int N = p.N, NS = N + 1, nb = N / 16;
  float* bsm = smem;                 // (64, NS) B of the key tile
  float* xs = bsm + kRows * NS;      // (64, PS) x of the key tile
  float* region = xs + kRows * PS;
  float* gm = region;                // (P, NS) G_c; later, over it:
  float* cs = region;                // (64, NS) C of the query tile
  float* dys = cs + kRows * NS;      // (64, PS) dy of the query tile
  float* g1 = dys + kRows * PS;      // (64, kGs) S^T L dt
  float* g2 = g1 + kRows * kGs;      // (64, kGs) dY^T L dt
  float* cum = region + region_floats(P, N, 2);
  float* dts = cum + kMaxQ;
  float* red = dts + kMaxQ;
  const int kt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / p.nsplit, s = blockIdx.z - b * p.nsplit;
  const int h0 = s * p.Hs, g = h0 / (p.H / p.G);
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0), j0 = kt * kRows;
  if (j0 >= L) return;              // a tile past the ragged last chunk
  const int n_tiles = (L + kRows - 1) / kRows, rows = min(kRows, L - j0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long row_dy = static_cast<long long>(p.H) * P;
  const T* bb = static_cast<const T*>(p.Bm) + b * p.bs_b +
                static_cast<long long>(t0) * p.bs_s + g * p.bs_g;
  const T* cb = static_cast<const T*>(p.Cm) + b * p.cs_b +
                static_cast<long long>(t0) * p.cs_s + g * p.cs_g;
  load_rows(bsm, NS, bb, p.bs_s, j0, rows, N);

  float db[4][kMaxN / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kMaxN / 16; ++e) db[a][e] = 0.f;

  for (int hh = 0; hh < p.Hs; ++hh) {
    const int h = h0 + hh, bh = b * p.H + h;
    const T* xb = static_cast<const T*>(p.x) + b * p.xs_b +
                  static_cast<long long>(t0) * p.xs_s + h * p.xs_h;
    const T* dyb = static_cast<const T*>(p.dy) +
                   (static_cast<long long>(b) * p.S + t0) * row_dy + h * P;
    __syncthreads();                // the last head is done with xs, region
    load_rows(xs, PS, xb, p.xs_s, j0, rows, P);
    const float* gsrc = static_cast<const float*>(p.Gs) + state_at(p, b, c, h);
    for (int i = tid; i < P * N; i += kThreads)
      gm[(i / N) * NS + i % N] = gsrc[i];
    load_cum_dt(p, cum, dts, b, h, c, t0, L, kThreads, 1.f);
    __syncthreads();
    const float tot = cum[L - 1];

    // state terms: G B_j (rows j, columns p) and G^T x_j (rows j, columns n)
    float dxa[4][kC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < kC; ++k) dxa[a][k] = 0.f;
    for (int n = 0; n < N; ++n) {
      float bv[4], gv[kC];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = bsm[(ty + 16 * a) * NS + n];
#pragma unroll
      for (int k = 0; k < kC; ++k) gv[k] = gm[(tx + 16 * k) * NS + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < kC; ++k) dxa[a][k] += bv[a] * gv[k];
    }
    float ej[4], wj[4], z[4], csum[4], ksum[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
      ej[a] = expf(tot - cum[j]);
      wj[a] = ej[a] * dts[j];
      z[a] = 0.f;
      csum[a] = ksum[a] = 0.f;
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        z[a] += xs[(ty + 16 * a) * PS + tx + 16 * k] * dxa[a][k];
        dxa[a][k] *= wj[a];
      }
    }
    for (int q = 0; q < P; ++q) {
      float xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = xs[(ty + 16 * a) * PS + q] * wj[a];
#pragma unroll
      for (int e = 0; e < kMaxN / 16; ++e) {
        if (e < nb) {
          const float gv = gm[q * NS + tx + 16 * e];
#pragma unroll
          for (int a = 0; a < 4; ++a) db[a][e] += xv[a] * gv;
        }
      }
    }

    // the query tiles at or after the key tile
    for (int it = kt; it < n_tiles; ++it) {
      const int i0 = it * kRows;
      __syncthreads();              // G_c or the last tile's space is free
      load_rows(cs, NS, cb, p.cs_s, i0, min(kRows, L - i0), N);
      load_rows(dys, PS, dyb, row_dy, i0, min(kRows, L - i0), P);
      __syncthreads();
      float sv[4][4], dv[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[a][e] = dv[a][e] = 0.f;
      for (int n = 0; n < N; ++n) {
        float bv[4], cv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = bsm[(ty + 16 * a) * NS + n];
#pragma unroll
        for (int e = 0; e < 4; ++e) cv[e] = cs[(tx + 16 * e) * NS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) sv[a][e] += bv[a] * cv[e];
      }
      for (int q = 0; q < P; ++q) {
        float xv[4], yv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = xs[(ty + 16 * a) * PS + q];
#pragma unroll
        for (int e = 0; e < 4; ++e) yv[e] = dys[(tx + 16 * e) * PS + q];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) dv[a][e] += xv[a] * yv[e];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = j0 + ty + 16 * a;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + tx + 16 * e;
          const float lx = j <= i && i < L ? expf(cum[i] - cum[j]) : 0.f;
          const float sl = sv[a][e] * lx, m = sl * dv[a][e];
          csum[a] += m;
          ksum[a] += j < i ? m : 0.f;
          g1[(ty + 16 * a) * kGs + tx + 16 * e] = sl * dts[j];
          g2[(ty + 16 * a) * kGs + tx + 16 * e] = dv[a][e] * lx * dts[j];
        }
      }
      __syncthreads();
      for (int i = 0; i < kRows; ++i) {
        float s1[4], s2[4], yv[kC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          s1[a] = g1[(ty + 16 * a) * kGs + i];
          s2[a] = g2[(ty + 16 * a) * kGs + i];
        }
#pragma unroll
        for (int k = 0; k < kC; ++k) yv[k] = dys[i * PS + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < kC; ++k) dxa[a][k] += s1[a] * yv[k];
#pragma unroll
        for (int e = 0; e < kMaxN / 16; ++e) {
          if (e < nb) {
            const float cv = cs[i * NS + tx + 16 * e];
#pragma unroll
            for (int a = 0; a < 4; ++a) db[a][e] += s2[a] * cv;
          }
        }
      }
      if (it == kt) {               // dys holds the key tile's own rows
        const float Dh = p.D[h];
        float dd = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < kC; ++k) {
            const float yv = dys[(ty + 16 * a) * PS + tx + 16 * k];
            dxa[a][k] += Dh * yv;
            dd += yv * xs[(ty + 16 * a) * PS + tx + 16 * k];
          }
        dd = block_sum<kThreads>(dd, red);
        if (tid == 0)
          p.dDp[(static_cast<long long>(bh) * p.nc + c) * (p.Qp / kRows) +
                kt] = dd;
      }
    }

    // ddt's direct part (column sums over the 16 lanes of a row), dx
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        csum[a] += __shfl_xor_sync(kFull, csum[a], o);
        ksum[a] += __shfl_xor_sync(kFull, ksum[a], o);
        z[a] += __shfl_xor_sync(kFull, z[a], o);
      }
      const int j = j0 + ty + 16 * a;
      if (j < L) {
        const long long t = static_cast<long long>(b) * p.S + t0 + j;
        if (tx == 0) {
          p.ddt[t * p.H + h] = csum[a] + ej[a] * z[a];
          p.dcum[t * p.H + h] = -dts[j] * ksum[a];
          p.tj[t * p.H + h] = wj[a] * z[a];
        }
        T* out = static_cast<T*>(p.dx) + (t * p.H + h) * P;
#pragma unroll
        for (int k = 0; k < kC; ++k) out[tx + 16 * k] = from_f32<T>(dxa[a][k]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j < L) {
      float* out = p.dbp + ((static_cast<long long>(b) * p.S + t0 + j) *
                                p.nsplit + s) * N;
#pragma unroll
      for (int e = 0; e < kMaxN / 16; ++e)
        if (e < nb) out[tx + 16 * e] = db[a][e];
    }
  }
}

// Pass c2, block (query tile qt, chunk c, batch row and split): the split's
// dC and dcum.  Thread (ty, tx) owns query rows ty + 16a and columns tx +
// 16k of every tile.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_queries(Params p) {
  constexpr int PS = P + 1;
  extern __shared__ float smem[];
  const int N = p.N, NS = N + 1, nb = N / 16;
  float* cs = smem;                  // (64, NS) C of the query tile
  float* dys = cs + kRows * NS;      // (64, PS) dy of the query tile
  float* region = dys + kRows * PS;
  float* sp = region;                // (P, NS) S_prev; later, over it:
  float* bsm = region;               // (64, NS) B of the key tile
  float* xs = bsm + kRows * NS;      // (64, PS) x of the key tile
  float* g2 = xs + kRows * PS;       // (64, kGs) dY L dt
  float* cum = region + region_floats(P, N, 1);
  float* dts = cum + kMaxQ;
  const int qt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / p.nsplit, s = blockIdx.z - b * p.nsplit;
  const int h0 = s * p.Hs, g = h0 / (p.H / p.G);
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0), i0 = qt * kRows;
  if (i0 >= L) return;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long row_dy = static_cast<long long>(p.H) * P;
  const bool has_prev = c > 0 || p.has_init;
  const T* bb = static_cast<const T*>(p.Bm) + b * p.bs_b +
                static_cast<long long>(t0) * p.bs_s + g * p.bs_g;
  const T* cb = static_cast<const T*>(p.Cm) + b * p.cs_b +
                static_cast<long long>(t0) * p.cs_s + g * p.cs_g;
  load_rows(cs, NS, cb, p.cs_s, i0, min(kRows, L - i0), N);

  float dc[4][kMaxN / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kMaxN / 16; ++e) dc[a][e] = 0.f;

  for (int hh = 0; hh < p.Hs; ++hh) {
    const int h = h0 + hh;
    const T* xb = static_cast<const T*>(p.x) + b * p.xs_b +
                  static_cast<long long>(t0) * p.xs_s + h * p.xs_h;
    const T* dyb = static_cast<const T*>(p.dy) +
                   (static_cast<long long>(b) * p.S + t0) * row_dy + h * P;
    __syncthreads();
    load_rows(dys, PS, dyb, row_dy, i0, min(kRows, L - i0), P);
    if (has_prev)
      for (int i = tid; i < P * N; i += kThreads)
        sp[(i / N) * NS + i % N] = enter_elem(p, b, c, h, i);
    load_cum_dt(p, cum, dts, b, h, c, t0, L, kThreads, 1.f);
    __syncthreads();

    float rs[4], yi[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) rs[a] = yi[a] = 0.f;
    if (has_prev) {                 // exp(cum_i) S_prev^T dy_i
      float t[4][kMaxN / 16];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < kMaxN / 16; ++e) t[a][e] = 0.f;
      for (int q = 0; q < P; ++q) {
        float yv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = dys[(ty + 16 * a) * PS + q];
#pragma unroll
        for (int e = 0; e < kMaxN / 16; ++e) {
          if (e < nb) {
            const float sv = sp[q * NS + tx + 16 * e];
#pragma unroll
            for (int a = 0; a < 4; ++a) t[a][e] += yv[a] * sv;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ei = expf(cum[i0 + ty + 16 * a]);
#pragma unroll
        for (int e = 0; e < kMaxN / 16; ++e)
          if (e < nb) {
            const float v = t[a][e] * ei;
            dc[a][e] += v;
            yi[a] += cs[(ty + 16 * a) * NS + tx + 16 * e] * v;
          }
      }
    }

    for (int jt = 0; jt <= qt; ++jt) {
      const int j0 = jt * kRows;
      __syncthreads();              // S_prev or the last tile's space
      load_rows(bsm, NS, bb, p.bs_s, j0, min(kRows, L - j0), N);
      load_rows(xs, PS, xb, p.xs_s, j0, min(kRows, L - j0), P);
      __syncthreads();
      float sv[4][4], dv[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[a][e] = dv[a][e] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(ty + 16 * a) * NS + n];
#pragma unroll
        for (int e = 0; e < 4; ++e) bv[e] = bsm[(tx + 16 * e) * NS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) sv[a][e] += cv[a] * bv[e];
      }
      for (int q = 0; q < P; ++q) {
        float yv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = dys[(ty + 16 * a) * PS + q];
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[e] = xs[(tx + 16 * e) * PS + q];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) dv[a][e] += yv[a] * xv[e];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + tx + 16 * e;
          const float w =
              j <= i && i < L ? expf(cum[i] - cum[j]) * dts[j] : 0.f;
          const float dw = dv[a][e] * w;
          rs[a] += j < i ? sv[a][e] * dw : 0.f;
          g2[(ty + 16 * a) * kGs + tx + 16 * e] = dw;
        }
      }
      __syncthreads();
      for (int j = 0; j < kRows; ++j) {
        float s2[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) s2[a] = g2[(ty + 16 * a) * kGs + j];
#pragma unroll
        for (int e = 0; e < kMaxN / 16; ++e) {
          if (e < nb) {
            const float bv = bsm[j * NS + tx + 16 * e];
#pragma unroll
            for (int a = 0; a < 4; ++a) dc[a][e] += s2[a] * bv;
          }
        }
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        rs[a] += __shfl_xor_sync(kFull, rs[a], o);
        yi[a] += __shfl_xor_sync(kFull, yi[a], o);
      }
      const int i = i0 + ty + 16 * a;
      if (tx == 0 && i < L) {
        const long long t =
            (static_cast<long long>(b) * p.S + t0 + i) * p.H + h;
        p.dcum[t] += rs[a] + yi[a];
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i < L) {
      float* out = p.dcp + ((static_cast<long long>(b) * p.S + t0 + i) *
                                p.nsplit + s) * N;
#pragma unroll
      for (int e = 0; e < kMaxN / 16; ++e)
        if (e < nb) out[tx + 16 * e] = dc[a][e];
    }
  }
}

template <typename T, int P>
cudaError_t allow(int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_keys<T, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_queries<T, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  return err;
}

template <typename T>
cudaError_t init_dtype(int bytes) {
  cudaError_t err = allow<T, 16>(bytes);
  if (err == cudaSuccess) err = allow<T, 32>(bytes);
  if (err == cudaSuccess) err = allow<T, 64>(bytes);
  if (err == cudaSuccess) err = allow<T, 128>(bytes);
  return err;
}

template <typename T, int P>
cudaError_t launch_p(const Params& p, int BH, cudaStream_t st) {
  const int nt = p.Qp / kRows;
  ssd_bwd_states<T, P><<<dim3(p.nc, BH), kThreads, states_smem(P, p.N), st>>>(
      p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_pass<false><<<dim3(p.nblk, BH), kPassThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 tiles(nt, p.nc, p.Bsz * p.nsplit);
  ssd_bwd_keys<T, P><<<tiles, kThreads, keys_smem(P, p.N), st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_queries<T, P><<<tiles, kThreads, queries_smem(P, p.N), st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int BH, cudaStream_t st) {
  switch (p.P) {
    case 16: return launch_p<T, 16>(p, BH, st);
    case 32: return launch_p<T, 32>(p, BH, st);
    case 64: return launch_p<T, 64>(p, BH, st);
    case 128: return launch_p<T, 128>(p, BH, st);
    default: return cudaErrorInvalidValue;
  }
}

size_t max_smem(int P, int N) {
  const size_t a = states_smem(P, N), k = keys_smem(P, N),
               q = queries_smem(P, N);
  return a > k ? (a > q ? a : q) : (k > q ? k : q);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// the tensor-core instance ("mma"): passes a, c1 and c2 on mma.sync
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 128;     // four warps, 16 rows of a 64-row tile each

// Shared rows are padded by 8 bf16 (16 bytes): the 8 rows one ldmatrix
// phase reads fall in 8 distinct 16-byte bank groups.
__host__ __device__ constexpr int pad(int width) { return width + 8; }

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

// 2^x by the MUFU approximation (relative error ~2^-22, subnormals to 0);
// the decays it gives meet values rounded to bf16 or float32 sums of
// bf16 products.
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

__device__ __forceinline__ float2 bf16x2(const bf16* at) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
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

// Pass a: a two-stage ring of (dy, C) step tiles, cum, exp(cum) and the
// scan's warp totals.
__host__ __device__ constexpr size_t states_smem() {
  return sizeof(bf16) * 2 * kRows * 2 * pad(kRows) +
         sizeof(float) * (2 * kMaxQ + 4);
}

// Pass a, block (chunk c, P rows p0 .. p0+63 and N columns n0 .. n0+63,
// head bh): the chunk's cum (to the workspace) and that slice of U_c[p, n]
// = sum_i exp(cum_i) dy[i, p] C[i, n]: the forward's state pass with dy
// for x, C for B and exp(cum) for w.  Warp w owns P rows p0 + 16w ..
// p0 + 16w + 15.  dy^T's fragments are scaled by exp(cum) in float32 and
// rounded to bf16 once, in registers (C stays exact).
__global__ void __launch_bounds__(kThreads) ssd_bwd_states_mma(Params p) {
  constexpr int LX = pad(kRows), LB = pad(kRows);
  constexpr int kStage = kRows * (LX + LB);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);
  float* cum = reinterpret_cast<float*>(ring + 2 * kStage);   // (kMaxQ)
  float* ew = cum + kMaxQ;                        // (kMaxQ) dt, then e^cum
  float* wsum = ew + kMaxQ;                       // (4)
  const int n_slices = p.N / kRows;
  const int c = blockIdx.x, bh = blockIdx.z;
  const int p0 = blockIdx.y / n_slices * kRows;
  const int n0 = blockIdx.y % n_slices * kRows;
  const int b = bh / p.H, h = bh - b * p.H, g = h / (p.H / p.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0);
  const int n_tiles = (L + kRows - 1) / kRows;
  const long long row_dy = static_cast<long long>(p.H) * p.P;
  const bf16* dyb = static_cast<const bf16*>(p.dy) +
                    (static_cast<long long>(b) * p.S + t0) * row_dy +
                    h * p.P + p0;
  const bf16* cb = static_cast<const bf16*>(p.Cm) + b * p.cs_b +
                   static_cast<long long>(t0) * p.cs_s + g * p.cs_g + n0;
  auto load_stage = [&](int t) {
    bf16* ys = ring + (t & 1) * kStage;
    const int j0 = t * kRows, rows = min(kRows, L - j0);
    load_tile<kRows>(ys, LX, dyb + j0 * row_dy, row_dy, rows);
    load_tile<kRows>(ys + kRows * LX, LB,
                     cb + static_cast<long long>(j0) * p.cs_s, p.cs_s, rows);
    cp_async_commit();
  };

  load_stage(0);
  chunk_scan<kThreads>(cum, ew, wsum,
                       p.dt + (static_cast<long long>(b) * p.S + t0) * p.H + h,
                       p.H, L, p.Qp, p.A[h]);
  if (blockIdx.y == 0) {
    float* out = p.cum + (static_cast<long long>(bh) * p.nc + c) * p.Qp;
    for (int j = tid; j < p.Qp; j += kThreads) out[j] = cum[j];
  }
  for (int j = tid; j < p.Qp; j += kThreads)
    ew[j] = j < L ? ex2(cum[j] * kLog2e) : 0.f;

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
    __syncthreads();                // ... for every thread; ew is written
    const bf16* ys = ring + (t & 1) * kStage;
    const bf16* csm = ys + kRows * LX;
    const float* w = ew + t * kRows;
#pragma unroll
    for (int kk = 0; kk < kRows; kk += 16) {
      uint32_t a[4];                // dy^T: A[p][i] from dy stored (i, p)
      ldsm_x4_trans(a, ys + (kk + (lane & 7) + (lane >> 4) * 8) * LX +
                           warp * 16 + ((lane >> 3) & 1) * 8);
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
        uint32_t bq[4];             // C[i][n] stored (i, n)
        ldsm_x4_trans(bq, csm + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LB +
                              nt * 8 + (lane >> 4) * 8);
        mma16816(acc[nt], a, bq[0], bq[1]);
        mma16816(acc[nt + 1], a, bq[2], bq[3]);
      }
    }
    __syncthreads();                // the stage is free for tile t + 2
  }

  float* out = p.U + state_at(p, b, c, h) +
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

// Passes c1 and c2: two step tiles (64 x N and 64 x P) beside a region
// that holds a state's hi and lo planes (2 x P x N) first and two more
// step tiles later, then cum and dt.
__host__ __device__ constexpr int region(int P, int N) {
  return 2 * P * pad(N) > kRows * (pad(N) + pad(P)) ? 2 * P * pad(N)
                                                    : kRows * (pad(N) + pad(P));
}

__host__ __device__ constexpr size_t tiles_smem(int P, int N) {
  return sizeof(bf16) * (kRows * (pad(N) + pad(P)) + region(P, N)) +
         sizeof(float) * (2 * kMaxQ + 4);
}

// Pass c1, block (key tile kt, chunk c, batch row and split): dx, ddt's
// direct part and the split's dB, for the 64 key rows j0 .. j0+63.  Warp w
// owns key rows j0 + 16w .. j0 + 16w + 15; a thread rows r0 and r0 + 8.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_keys_mma(Params p) {
  constexpr int LN = pad(N), LP = pad(P);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* bsm = reinterpret_cast<bf16*>(smem_tc);   // (64 keys, N) B
  bf16* xs = bsm + kRows * LN;                    // (64 keys, P) x
  bf16* reg = xs + kRows * LP;
  bf16* ghi = reg;                                // (P, N) G_c hi, lo
  bf16* glo = ghi + P * LN;
  bf16* cs = reg;                                 // (64 queries, N) C,
  bf16* dys = cs + kRows * LN;                    // (64 queries, P) dy
  float* cum = reinterpret_cast<float*>(reg + region(P, N));  // log2 units
  float* dts = cum + kMaxQ;
  float* red = dts + kMaxQ;
  const int kt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / p.nsplit, s = blockIdx.z - b * p.nsplit;
  const int h0 = s * p.Hs, g = h0 / (p.H / p.G);
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0), j0 = kt * kRows;
  if (j0 >= L) return;              // a tile past the ragged last chunk
  const int n_tiles = (L + kRows - 1) / kRows, rows = min(kRows, L - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = lane & 3, r0 = warp * 16 + (lane >> 2);   // rows r0, r0+8
  const long long row_dy = static_cast<long long>(p.H) * P;
  const bf16* bb = static_cast<const bf16*>(p.Bm) + b * p.bs_b +
                   static_cast<long long>(t0) * p.bs_s + g * p.bs_g;
  const bf16* cb = static_cast<const bf16*>(p.Cm) + b * p.cs_b +
                   static_cast<long long>(t0) * p.cs_s + g * p.cs_g;
  load_tile<N>(bsm, LN, bb + static_cast<long long>(j0) * p.bs_s, p.bs_s,
               rows);

  float db[N / 8][4];
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[nt][e] = 0.f;

  for (int hh = 0; hh < p.Hs; ++hh) {
    const int h = h0 + hh, bh = b * p.H + h;
    const bf16* xb = static_cast<const bf16*>(p.x) + b * p.xs_b +
                     static_cast<long long>(t0) * p.xs_s + h * p.xs_h;
    const bf16* dyb = static_cast<const bf16*>(p.dy) +
                      (static_cast<long long>(b) * p.S + t0) * row_dy + h * P;
    const bf16* gsrc =
        static_cast<const bf16*>(p.Gs) + 2 * state_at(p, b, c, h);
    __syncthreads();                // the last head is done with xs, reg
    load_tile<P>(xs, LP, xb + static_cast<long long>(j0) * p.xs_s, p.xs_s,
                 rows);
    load_tile<N, P>(ghi, LN, gsrc, N, P);
    load_tile<N, P>(glo, LN, gsrc + P * N, N, P);
    simt::load_cum_dt(p, cum, dts, b, h, c, t0, L, kThreads, kLog2e);
    cp_async_wait_all();
    __syncthreads();
    const float tot = cum[L - 1];

    // state terms: G (B_j) rows j x columns p, two products (hi, lo)
    float dxa[P / 8][4];
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[nt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < N; kk += 16) {
      uint32_t a[4];                // B[j][n] stored (j, n)
      ldsm_x4(a, bsm + (warp * 16 + (lane & 15)) * LN + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < P / 8; nt += 2) {
        // G[p][n] stored (p, n): the col-major B of B_j G^T
        const int off = (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LN + kk +
                        ((lane >> 3) & 1) * 8;
        uint32_t bq[4];
        ldsm_x4(bq, ghi + off);
        mma16816(dxa[nt], a, bq[0], bq[1]);
        mma16816(dxa[nt + 1], a, bq[2], bq[3]);
        ldsm_x4(bq, glo + off);
        mma16816(dxa[nt], a, bq[0], bq[1]);
        mma16816(dxa[nt + 1], a, bq[2], bq[3]);
      }
    }
    const float e0 = ex2(tot - cum[j0 + r0]), e1 = ex2(tot - cum[j0 + r0 + 8]);
    const float w0 = e0 * dts[j0 + r0], w1 = e1 * dts[j0 + r0 + 8];
    float z0 = 0.f, z1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      const int col = nt * 8 + 2 * tq;
      const float2 x0 = bf16x2(xs + r0 * LP + col);
      const float2 x1 = bf16x2(xs + (r0 + 8) * LP + col);
      z0 += x0.x * dxa[nt][0] + x0.y * dxa[nt][1];
      z1 += x1.x * dxa[nt][2] + x1.y * dxa[nt][3];
      dxa[nt][0] *= w0;
      dxa[nt][1] *= w0;
      dxa[nt][2] *= w1;
      dxa[nt][3] *= w1;
    }
    // G^T x_j: rows j x columns n, scaled by w_j in float32 into dB
    {
      float gx[N / 8][4];
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) gx[nt][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < P; kk += 16) {
        uint32_t a[4];              // x[j][p] stored (j, p)
        ldsm_x4(a, xs + (warp * 16 + (lane & 15)) * LP + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < N / 8; nt += 2) {
          // G[p][n] stored (p, n): the row-major B of x_j G
          const int off = (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LN +
                          nt * 8 + (lane >> 4) * 8;
          uint32_t bq[4];
          ldsm_x4_trans(bq, ghi + off);
          mma16816(gx[nt], a, bq[0], bq[1]);
          mma16816(gx[nt + 1], a, bq[2], bq[3]);
          ldsm_x4_trans(bq, glo + off);
          mma16816(gx[nt], a, bq[0], bq[1]);
          mma16816(gx[nt + 1], a, bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        db[nt][0] += w0 * gx[nt][0];
        db[nt][1] += w0 * gx[nt][1];
        db[nt][2] += w1 * gx[nt][2];
        db[nt][3] += w1 * gx[nt][3];
      }
    }

    // the query tiles at or after the key tile
    float cs0 = 0.f, cs1 = 0.f;     // sum_i S L dY of rows r0, r0 + 8
    float ks0 = 0.f, ks1 = 0.f;     // the same over i > j
    const float cj0 = cum[j0 + r0], cj1 = cum[j0 + r0 + 8];
    const float d0 = dts[j0 + r0], d1 = dts[j0 + r0 + 8];
    const int rj0 = j0 + r0, rj1 = rj0 + 8;
    for (int it = kt; it < n_tiles; ++it) {
      const int i0 = it * kRows, irows = min(kRows, L - i0);
      __syncthreads();              // G_c or the last tile's space is free
      load_tile<N>(cs, LN, cb + static_cast<long long>(i0) * p.cs_s, p.cs_s,
                   irows);
      load_tile<P>(dys, LP, dyb + i0 * row_dy, row_dy, irows);
      cp_async_wait_all();
      __syncthreads();
      const bool diag = it == kt;
      // on the diagonal, query n8 tiles holding some i >= j of this warp
      const int first = diag ? 2 * warp : 0;
      float sv[8][4], dv[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[nt][e] = dv[nt][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < N; kk += 16) {
        uint32_t a[4];              // B[j][n] stored (j, n)
        ldsm_x4(a, bsm + (warp * 16 + (lane & 15)) * LN + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          if (nt >= first) {
            uint32_t bq[4];         // C[i][n] stored (i, n)
            ldsm_x4(bq, cs + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LN + kk +
                            ((lane >> 3) & 1) * 8);
            mma16816(sv[nt], a, bq[0], bq[1]);
            mma16816(sv[nt + 1], a, bq[2], bq[3]);
          }
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < P; kk += 16) {
        uint32_t a[4];              // x[j][p] stored (j, p)
        ldsm_x4(a, xs + (warp * 16 + (lane & 15)) * LP + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          if (nt >= first) {
            uint32_t bq[4];         // dy[i][p] stored (i, p)
            ldsm_x4(bq, dys + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LP +
                            kk + ((lane >> 3) & 1) * 8);
            mma16816(dv[nt], a, bq[0], bq[1]);
            mma16816(dv[nt + 1], a, bq[2], bq[3]);
          }
        }
      }
      // mask and decay: pairs i < j (and i past L) are set to 0 by a select
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + nt * 8 + 2 * tq + u;
          const float ci = cum[i];
          const float l0 = i >= rj0 && i < L ? ex2(ci - cj0) : 0.f;
          const float l1 = i >= rj1 && i < L ? ex2(ci - cj1) : 0.f;
          const float s0 = sv[nt][u] * l0, s1 = sv[nt][2 + u] * l1;
          const float m0 = s0 * dv[nt][u], m1 = s1 * dv[nt][2 + u];
          cs0 += m0;
          cs1 += m1;
          ks0 += i > rj0 ? m0 : 0.f;
          ks1 += i > rj1 ? m1 : 0.f;
          sv[nt][u] = s0 * d0;
          sv[nt][2 + u] = s1 * d1;
          dv[nt][u] *= l0 * d0;
          dv[nt][2 + u] *= l1 * d1;
        }
      // dx += (S^T L dt) dy_i and dB += (dY^T L dt) C_i: query n8 tiles 2k
      // and 2k+1's accumulators are, packed to bf16, the A fragment of the
      // k-th 16-query slice
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (2 * k + 1 >= first) {
          const int k0 = 2 * k, k1 = 2 * k + 1;
          const uint32_t as[4] = {pack_bf16(sv[k0][0], sv[k0][1]),
                                  pack_bf16(sv[k0][2], sv[k0][3]),
                                  pack_bf16(sv[k1][0], sv[k1][1]),
                                  pack_bf16(sv[k1][2], sv[k1][3])};
          const uint32_t ad[4] = {pack_bf16(dv[k0][0], dv[k0][1]),
                                  pack_bf16(dv[k0][2], dv[k0][3]),
                                  pack_bf16(dv[k1][0], dv[k1][1]),
                                  pack_bf16(dv[k1][2], dv[k1][3])};
          const int row = k * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int nt = 0; nt < P / 8; nt += 2) {
            uint32_t bq[4];         // dy[i][p] stored (i, p)
            ldsm_x4_trans(bq, dys + row * LP + nt * 8 + (lane >> 4) * 8);
            mma16816(dxa[nt], as, bq[0], bq[1]);
            mma16816(dxa[nt + 1], as, bq[2], bq[3]);
          }
#pragma unroll
          for (int nt = 0; nt < N / 8; nt += 2) {
            uint32_t bq[4];         // C[i][n] stored (i, n)
            ldsm_x4_trans(bq, cs + row * LN + nt * 8 + (lane >> 4) * 8);
            mma16816(db[nt], ad, bq[0], bq[1]);
            mma16816(db[nt + 1], ad, bq[2], bq[3]);
          }
        }
      }
      if (diag) {                   // dys holds the key tile's own rows
        const float Dh = p.D[h];
        float dd = 0.f;
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const int col = nt * 8 + 2 * tq;
          const float2 y0 = bf16x2(dys + r0 * LP + col);
          const float2 y1 = bf16x2(dys + (r0 + 8) * LP + col);
          const float2 x0 = bf16x2(xs + r0 * LP + col);
          const float2 x1 = bf16x2(xs + (r0 + 8) * LP + col);
          dxa[nt][0] += Dh * y0.x;
          dxa[nt][1] += Dh * y0.y;
          dxa[nt][2] += Dh * y1.x;
          dxa[nt][3] += Dh * y1.y;
          dd += y0.x * x0.x + y0.y * x0.y + y1.x * x1.x + y1.y * x1.y;
        }
        dd = block_sum<kThreads>(dd, red);
        if (tid == 0)
          p.dDp[(static_cast<long long>(bh) * p.nc + c) * (p.Qp / kRows) +
                kt] = dd;
      }
    }

    // ddt's direct part (sums over the quad's columns), dx
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      cs0 += __shfl_xor_sync(kFull, cs0, o);
      cs1 += __shfl_xor_sync(kFull, cs1, o);
      ks0 += __shfl_xor_sync(kFull, ks0, o);
      ks1 += __shfl_xor_sync(kFull, ks1, o);
      z0 += __shfl_xor_sync(kFull, z0, o);
      z1 += __shfl_xor_sync(kFull, z1, o);
    }
    const long long tr0 = static_cast<long long>(b) * p.S + t0 + rj0;
    if (tq == 0) {
      if (rj0 < L) {
        p.ddt[tr0 * p.H + h] = cs0 + e0 * z0;
        p.dcum[tr0 * p.H + h] = -d0 * ks0;
        p.tj[tr0 * p.H + h] = w0 * z0;
      }
      if (rj1 < L) {
        p.ddt[(tr0 + 8) * p.H + h] = cs1 + e1 * z1;
        p.dcum[(tr0 + 8) * p.H + h] = -d1 * ks1;
        p.tj[(tr0 + 8) * p.H + h] = w1 * z1;
      }
    }
    bf16* out = static_cast<bf16*>(p.dx) + (tr0 * p.H + h) * P + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      if (rj0 < L)
        *reinterpret_cast<__nv_bfloat162*>(out + nt * 8) =
            __floats2bfloat162_rn(dxa[nt][0], dxa[nt][1]);
      if (rj1 < L)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * row_dy + nt * 8) =
            __floats2bfloat162_rn(dxa[nt][2], dxa[nt][3]);
    }
  }

  const int rj0 = j0 + r0;
  float* out = p.dbp + ((static_cast<long long>(b) * p.S + t0 + rj0) *
                            p.nsplit + s) * N + 2 * tq;
  const long long row = static_cast<long long>(p.nsplit) * N;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    if (rj0 < L)
      *reinterpret_cast<float2*>(out + nt * 8) =
          make_float2(db[nt][0], db[nt][1]);
    if (rj0 + 8 < L)
      *reinterpret_cast<float2*>(out + 8 * row + nt * 8) =
          make_float2(db[nt][2], db[nt][3]);
  }
}

// Pass c2, block (query tile qt, chunk c, batch row and split): the split's
// dC and dcum for the 64 query rows i0 .. i0+63.  Warp w owns query rows
// i0 + 16w .. i0 + 16w + 15; a thread rows r0 and r0 + 8.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_queries_mma(Params p) {
  constexpr int LN = pad(N), LP = pad(P);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* csm = reinterpret_cast<bf16*>(smem_tc);   // (64 queries, N) C
  bf16* dys = csm + kRows * LN;                   // (64 queries, P) dy
  bf16* reg = dys + kRows * LP;
  bf16* shi = reg;                                // (P, N) S_prev hi, lo
  bf16* slo = shi + P * LN;
  bf16* bsm = reg;                                // (64 keys, N) B,
  bf16* xs = bsm + kRows * LN;                    // (64 keys, P) x
  float* cum = reinterpret_cast<float*>(reg + region(P, N));  // log2 units
  float* dts = cum + kMaxQ;
  const int qt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / p.nsplit, s = blockIdx.z - b * p.nsplit;
  const int h0 = s * p.Hs, g = h0 / (p.H / p.G);
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0), i0 = qt * kRows;
  if (i0 >= L) return;
  const int irows = min(kRows, L - i0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = lane & 3, r0 = warp * 16 + (lane >> 2);
  const int ri0 = i0 + r0, ri1 = ri0 + 8;
  const long long row_dy = static_cast<long long>(p.H) * P;
  const bool has_prev = c > 0 || p.has_init;
  const bf16* bb = static_cast<const bf16*>(p.Bm) + b * p.bs_b +
                   static_cast<long long>(t0) * p.bs_s + g * p.bs_g;
  const bf16* cb = static_cast<const bf16*>(p.Cm) + b * p.cs_b +
                   static_cast<long long>(t0) * p.cs_s + g * p.cs_g;
  load_tile<N>(csm, LN, cb + static_cast<long long>(i0) * p.cs_s, p.cs_s,
               irows);

  float dc[N / 8][4];
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dc[nt][e] = 0.f;

  for (int hh = 0; hh < p.Hs; ++hh) {
    const int h = h0 + hh;
    const bf16* xb = static_cast<const bf16*>(p.x) + b * p.xs_b +
                     static_cast<long long>(t0) * p.xs_s + h * p.xs_h;
    const bf16* dyb = static_cast<const bf16*>(p.dy) +
                      (static_cast<long long>(b) * p.S + t0) * row_dy + h * P;
    __syncthreads();
    load_tile<P>(dys, LP, dyb + i0 * row_dy, row_dy, irows);
    if (has_prev) {
      const bf16* from =
          static_cast<const bf16*>(p.enter) + 2 * state_at(p, b, c, h);
      load_tile<N, P>(shi, LN, from, N, P);
      load_tile<N, P>(slo, LN, from + P * N, N, P);
    }
    simt::load_cum_dt(p, cum, dts, b, h, c, t0, L, kThreads, kLog2e);
    cp_async_wait_all();
    __syncthreads();
    const float ci0 = cum[ri0], ci1 = cum[ri1];

    float rs0 = 0.f, rs1 = 0.f, y0 = 0.f, y1 = 0.f;
    if (has_prev) {                 // exp(cum_i) dy_i S_prev, two products
      float t[N / 8][4];
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[nt][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < P; kk += 16) {
        uint32_t a[4];              // dy[i][p] stored (i, p)
        ldsm_x4(a, dys + (warp * 16 + (lane & 15)) * LP + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < N / 8; nt += 2) {
          // S[p][n] stored (p, n): the row-major B of dy S
          const int off = (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LN +
                          nt * 8 + (lane >> 4) * 8;
          uint32_t bq[4];
          ldsm_x4_trans(bq, shi + off);
          mma16816(t[nt], a, bq[0], bq[1]);
          mma16816(t[nt + 1], a, bq[2], bq[3]);
          ldsm_x4_trans(bq, slo + off);
          mma16816(t[nt], a, bq[0], bq[1]);
          mma16816(t[nt + 1], a, bq[2], bq[3]);
        }
      }
      const float e0 = ex2(ci0), e1 = ex2(ci1);
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        const int col = nt * 8 + 2 * tq;
        const float2 c0 = bf16x2(csm + r0 * LN + col);
        const float2 c1 = bf16x2(csm + (r0 + 8) * LN + col);
        const float v0 = t[nt][0] * e0, v1 = t[nt][1] * e0;
        const float v2 = t[nt][2] * e1, v3 = t[nt][3] * e1;
        dc[nt][0] += v0;
        dc[nt][1] += v1;
        dc[nt][2] += v2;
        dc[nt][3] += v3;
        y0 += c0.x * v0 + c0.y * v1;
        y1 += c1.x * v2 + c1.y * v3;
      }
    }

    for (int jt = 0; jt <= qt; ++jt) {
      const int j0 = jt * kRows, jrows = min(kRows, L - j0);
      __syncthreads();              // S_prev or the last tile's space
      load_tile<N>(bsm, LN, bb + static_cast<long long>(j0) * p.bs_s, p.bs_s,
                   jrows);
      load_tile<P>(xs, LP, xb + static_cast<long long>(j0) * p.xs_s, p.xs_s,
                   jrows);
      cp_async_wait_all();
      __syncthreads();
      // key n8 tiles holding some j <= i of this warp's rows
      const int live = jt == qt ? 2 * warp + 2 : 8;
      float sv[8][4], dv[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[nt][e] = dv[nt][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < N; kk += 16) {
        uint32_t a[4];              // C[i][n] stored (i, n)
        ldsm_x4(a, csm + (warp * 16 + (lane & 15)) * LN + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          if (nt < live) {
            uint32_t bq[4];         // B[j][n] stored (j, n)
            ldsm_x4(bq, bsm + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LN +
                            kk + ((lane >> 3) & 1) * 8);
            mma16816(sv[nt], a, bq[0], bq[1]);
            mma16816(sv[nt + 1], a, bq[2], bq[3]);
          }
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < P; kk += 16) {
        uint32_t a[4];              // dy[i][p] stored (i, p)
        ldsm_x4(a, dys + (warp * 16 + (lane & 15)) * LP + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          if (nt < live) {
            uint32_t bq[4];         // x[j][p] stored (j, p)
            ldsm_x4(bq, xs + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LP +
                            kk + ((lane >> 3) & 1) * 8);
            mma16816(dv[nt], a, bq[0], bq[1]);
            mma16816(dv[nt + 1], a, bq[2], bq[3]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + nt * 8 + 2 * tq + u;
          const float cj = cum[j], dj = dts[j];
          const float w0 = j <= ri0 && ri0 < L ? ex2(ci0 - cj) * dj : 0.f;
          const float w1 = j <= ri1 && ri1 < L ? ex2(ci1 - cj) * dj : 0.f;
          const float q0 = dv[nt][u] * w0, q1 = dv[nt][2 + u] * w1;
          rs0 += j < ri0 ? sv[nt][u] * q0 : 0.f;
          rs1 += j < ri1 ? sv[nt][2 + u] * q1 : 0.f;
          dv[nt][u] = q0;
          dv[nt][2 + u] = q1;
        }
      // dC += (dY L dt) B_j
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (2 * k < live) {
          const uint32_t a[4] = {pack_bf16(dv[2 * k][0], dv[2 * k][1]),
                                 pack_bf16(dv[2 * k][2], dv[2 * k][3]),
                                 pack_bf16(dv[2 * k + 1][0], dv[2 * k + 1][1]),
                                 pack_bf16(dv[2 * k + 1][2], dv[2 * k + 1][3])};
#pragma unroll
          for (int nt = 0; nt < N / 8; nt += 2) {
            uint32_t bq[4];         // B[j][n] stored (j, n)
            ldsm_x4_trans(bq, bsm + (k * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LN +
                                  nt * 8 + (lane >> 4) * 8);
            mma16816(dc[nt], a, bq[0], bq[1]);
            mma16816(dc[nt + 1], a, bq[2], bq[3]);
          }
        }
      }
    }

#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rs0 += __shfl_xor_sync(kFull, rs0, o);
      rs1 += __shfl_xor_sync(kFull, rs1, o);
      y0 += __shfl_xor_sync(kFull, y0, o);
      y1 += __shfl_xor_sync(kFull, y1, o);
    }
    if (tq == 0) {
      const long long t =
          (static_cast<long long>(b) * p.S + t0 + ri0) * p.H + h;
      if (ri0 < L) p.dcum[t] += rs0 + y0;
      if (ri1 < L) p.dcum[t + 8 * p.H] += rs1 + y1;
    }
  }

  float* out = p.dcp + ((static_cast<long long>(b) * p.S + t0 + ri0) *
                            p.nsplit + s) * N + 2 * tq;
  const long long row = static_cast<long long>(p.nsplit) * N;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    if (ri0 < L)
      *reinterpret_cast<float2*>(out + nt * 8) =
          make_float2(dc[nt][0], dc[nt][1]);
    if (ri1 < L)
      *reinterpret_cast<float2*>(out + 8 * row + nt * 8) =
          make_float2(dc[nt][2], dc[nt][3]);
  }
}

template <int P, int N>
cudaError_t allow() {
  const int bytes = static_cast<int>(tiles_smem(P, N));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_keys_mma<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_queries_mma<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  return err;
}

cudaError_t init() {
  cudaError_t err = allow<64, 64>();
  if (err == cudaSuccess) err = allow<64, 128>();
  if (err == cudaSuccess) err = allow<128, 64>();
  if (err == cudaSuccess) err = allow<128, 128>();
  return err;
}

template <int P, int N>
cudaError_t launch_pn(const Params& p, int BH, cudaStream_t st) {
  ssd_bwd_states_mma<<<dim3(p.nc, P / kRows * (N / kRows), BH), kThreads,
                       states_smem(), st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_pass<true><<<dim3(p.nblk, BH), kPassThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 tiles(p.Qp / kRows, p.nc, p.Bsz * p.nsplit);
  ssd_bwd_keys_mma<P, N><<<tiles, kThreads, tiles_smem(P, N), st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_queries_mma<P, N><<<tiles, kThreads, tiles_smem(P, N), st>>>(p);
  return cudaGetLastError();
}

cudaError_t launch(const Params& p, int BH, cudaStream_t st) {
  if (p.P == 64 && p.N == 64) return launch_pn<64, 64>(p, BH, st);
  if (p.P == 64 && p.N == 128) return launch_pn<64, 128>(p, BH, st);
  if (p.P == 128 && p.N == 64) return launch_pn<128, 64>(p, BH, st);
  if (p.P == 128 && p.N == 128) return launch_pn<128, 128>(p, BH, st);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// The workspace's parts, in floats, each rounded up to 64 floats (256
// bytes) so that every part starts 16-byte aligned.
struct Workspace {
  long long cum, U, Gs, gdot, dcum, tj, dbp, dcp, dDp, dAp, total;
  Workspace(int B, int S, int H, int G, int P, int N, int Q) {
    auto up = [](long long n) { return (n + 63) / 64 * 64; };
    const long long nc = (S + Q - 1) / Q, Qp = (Q + kRows - 1) / kRows * kRows;
    const long long BH = static_cast<long long>(B) * H, PN = P * N;
    const long long nsplit = H / heads_per_split(H / G);
    const long long nblk = (PN + kPassThreads - 1) / kPassThreads;
    long long at = 0;
    auto take = [&](long long n) {
      const long long here = at;
      at += up(n);
      return here;
    };
    cum = take(BH * nc * Qp);
    U = take(BH * nc * PN);
    Gs = take(BH * nc * PN);
    gdot = take(BH * nc * nblk);
    dcum = take(static_cast<long long>(B) * S * H);
    tj = take(static_cast<long long>(B) * S * H);
    dbp = take(static_cast<long long>(B) * S * nsplit * N);
    dcp = take(static_cast<long long>(B) * S * nsplit * N);
    dDp = take(BH * nc * (Qp / kRows));
    dAp = take(BH * nc);
    total = at;
  }
};

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

// Floats of workspace one call needs.
long long ssd_bwd_workspace(int B, int S, int H, int G, int P, int N, int Q) {
  return Workspace(B, S, H, G, P, N, Q).total;
}

// The most dynamic shared memory a block of the instance (0 simt, 1 mma)
// needs at head dim P and d_state N, in bytes; 0 for a P or N it does not
// take.
int ssd_bwd_smem(int instance, int P, int N) {
  if (instance == 1) {
    if ((P != 64 && P != 128) || (N != 64 && N != 128)) return 0;
    return static_cast<int>(tc::tiles_smem(P, N));
  }
  if ((P != 16 && P != 32 && P != 64 && P != 128) || N <= 0 || N % 16 ||
      N > kMaxN)
    return 0;
  return static_cast<int>(simt::max_smem(P, N));
}

// Once per device, before its first launch: lets every template use the
// largest dynamic shared memory a block may have there, and returns that
// size in bytes (or minus a cudaError_t).
int ssd_bwd_init(int device) {
  int bytes = 0;
  DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess) err = simt::init_dtype<float>(bytes);
  if (err == cudaSuccess) err = simt::init_dtype<bf16>(bytes);
  if (err == cudaSuccess) err = tc::init();
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// The backward, its seven kernels on `stream`.  instance: 0 = simt, 1 =
// mma (bfloat16 only; the entering states as bf16 hi, lo planes).  dtype:
// 0 = float32, 1 = bfloat16 (x, Bm, Cm, dy, dx, dB and dC); dt, A, D, the
// states and ddt, dA, dD, dinit are float32.  enter_f32: the entering
// states are float32 (else bf16 hi, lo); has_init: the forward had an
// initial state (chunk 0's entering state is kept); dfinal and dinit may be
// null.  ws holds `ssd_bwd_workspace` floats, 16-byte aligned; its contents
// on entry do not matter.  Strides of x, Bm and Cm are in elements; the
// rest is contiguous.  Returns a cudaError_t (0 = launched).
int ssd_bwd_launch(int device, int instance, int dtype, const void* x,
                   const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* D, const void* dy,
                   const void* enter, int enter_f32, int has_init,
                   const void* dfinal, void* dx, void* ddt,
                   void* dA, void* dB, void* dC, void* dD, void* dinit,
                   void* ws, int B, int S, int H, int P, int G, int N, int Q,
                   long long xs_b, long long xs_s, long long xs_h,
                   long long bs_b, long long bs_s, long long bs_g,
                   long long cs_b, long long cs_s, long long cs_g,
                   void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const long long BH = static_cast<long long>(B) * H;
  const int nc = S > 0 && Q > 0 ? (S + Q - 1) / Q : 0;
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0 ||
      Q > kMaxQ || BH > 65535 || nc > 65535 ||
      ssd_bwd_smem(instance, P, N) == 0 || (instance == 1 && dtype != 1) ||
      (instance == 1 && enter_f32) || (instance != 0 && instance != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Workspace w(B, S, H, G, P, N, Q);
  float* base = static_cast<float*>(ws);
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.Cm = Cm;
  p.D = static_cast<const float*>(D);
  p.dy = dy;
  p.enter = enter;
  p.dfinal = static_cast<const float*>(dfinal);
  p.dx = dx;
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.dB = dB;
  p.dC = dC;
  p.dD = static_cast<float*>(dD);
  p.dinit = static_cast<float*>(dinit);
  p.cum = base + w.cum;
  p.U = base + w.U;
  p.Gs = base + w.Gs;
  p.gdot = base + w.gdot;
  p.dcum = base + w.dcum;
  p.tj = base + w.tj;
  p.dbp = base + w.dbp;
  p.dcp = base + w.dcp;
  p.dDp = base + w.dDp;
  p.dAp = base + w.dAp;
  p.Bsz = B;
  p.S = S;
  p.H = H;
  p.G = G;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.Qp = (Q + kRows - 1) / kRows * kRows;
  p.nc = nc;
  p.Hs = heads_per_split(H / G);
  p.nsplit = H / p.Hs;
  p.nblk = (P * N + kPassThreads - 1) / kPassThreads;
  p.has_init = has_init;
  p.enter_f32 = enter_f32;
  p.xs_b = xs_b;
  p.xs_s = xs_s;
  p.xs_h = xs_h;
  p.bs_b = bs_b;
  p.bs_s = bs_s;
  p.bs_g = bs_g;
  p.cs_b = cs_b;
  p.cs_s = cs_s;
  p.cs_g = cs_g;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (instance == 1) err = tc::launch(p, static_cast<int>(BH), st);
  else if (dtype == 0) err = simt::launch<float>(p, static_cast<int>(BH), st);
  else err = simt::launch<bf16>(p, static_cast<int>(BH), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dcum<<<dim3(nc, static_cast<unsigned>(BH)), kMaxQ, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems = static_cast<long long>(B) * S * G * N;
  const unsigned blocks =
      static_cast<unsigned>((elems + kPassThreads - 1) / kPassThreads);
  if (dtype == 0) ssd_bwd_group_sums<float><<<blocks, kPassThreads, 0, st>>>(p);
  else ssd_bwd_group_sums<bf16><<<blocks, kPassThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_sums<<<H, 32, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
