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
// bits.  No decay of a pair j > i is formed: on a diagonal tile those pairs
// are set to 0 by a select, never multiplied by a decay that may be
// infinite.  cum and tot are float32 scans without fast math.  The ragged
// tail is handled here, not padded on the host: rows past the chunk's end
// load as 0 with dt = 0 and are never stored.  x, B and C are read through
// their strides (the views of the model's fused projection); dy, dx, dB
// and dC are contiguous.  The split of heads: a block walks Hs heads of one
// group, so the per-split dB and dC partials are (H / Hs) / H of per-head
// ones (`ssd_bwd_launch` chooses Hs from the shapes).
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
//   "mma" (bfloat16, P and N 64 or 128, 16-byte aligned rows and strides;
//     the name is the forward's): pass a on mma.sync.m16n8k16, then
//     s. the scores C_i B_j^T and B_j C_i^T of each tile pair kt <= qt,
//        once per (batch row, chunk, group), into a float32 workspace
//        (fragment order, 16 KB a tile, 5.2 MB at mamba2's 8 x 512) that
//        every head of the group reads, so the tile passes do not form
//        C.B per head (2N of the 8N + 6P products a pair and head);
//     c1, c2 on wgmma (bf16 in, f32 accumulate), 256 threads, one block an
//        SM: each warpgroup owns a head (two heads a stage; one where the
//        P = 128 tiles would not fit, the second warpgroup idle), so dx,
//        the row sums of ddt and dcum and the state terms stay in it, and
//        only dB / dC meet the other warpgroup's, once, at the end.  A
//        stage is one (head pair, 64-row tile); its tiles (each head's dy_i
//        or x_j, the pair's C_i or B_j, the S^T or S tile, at a pair's start
//        x_j or dy_i and cum) come by TMA from one thread (128-byte
//        swizzle, zeros past S) on a two-slot mbarrier ring while the stage
//        before runs, and the next pair's G_c or S_prev planes as soon as
//        this pair's state terms have read the last ones; dt, strided, by
//        cp.async.  The masked, decayed products S L dt and dY L dt are
//        rounded to bf16 as the A operand of the next product straight
//        from the accumulators, 32 queries (keys) at a time, the next
//        half's dY issued with this half's products.  Below the diagonal
//        tile the decay is exp(c_i - c_r) exp(c_r - c_j) with c_r between
//        the tiles, two factors at most 1 (dt >= 0, A <= 0), formed once a
//        column and once a row, with no mask: queries and keys past L meet
//        zero rows.  G_c and S_prev enter as bf16 hi + lo (two products
//        each); w_j x_j G_c goes in as w_j x_j rounded to bf16 once, in
//        registers.  ddt and dcum are formed from the float32 accumulators.
//     What bounds them on this card: not the tensor cores (≈ 63 GFLOP a
//     call at mamba2's 8 x 512, ≈ 0.06 ms at the bf16 peak) but
//     instructions and latency: a stage's elementwise mask-and-decay, its
//     waits on wgmma and its barriers, at 8 warps an SM (the registers,
//     most of the 255 a thread may have, hold a block an SM).  Per-thread
//     cp.async of the stage tiles spent much of each stage in load-store
//     instructions; TMA, from one thread, does not.
#include <cuda.h>           // CUtensorMap; its encoder is looked up
#include <cudaTypedefs.h>   // through the runtime, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;        // steps of a key or query tile
constexpr int kMaxQ = 256;       // the longest chunk
constexpr int kMaxN = 128;       // the largest d_state
constexpr int kMaxSplit = 8;     // the most heads a SIMT block walks
constexpr int kMaxSplitTc = 16;  // ... a tensor-core block
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
  float* sc;             // (B, nc, G, T, 64 x 64) C_i B_j^T of each tile
  float* sct;            //   pair kt <= qt, and B_j C_i^T ("mma" only)
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

__host__ __device__ inline int heads_per_split(int heads_in_group,
                                               int most = kMaxSplit) {
  int hs = 1;
  for (int d = 1; d <= most; ++d)
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
// the tensor-core instance ("mma"): pass a on mma.sync
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

// ---------------------------------------------------------------------------
// the tensor-core tile passes: the scores once per group, then the key and
// query passes on wgmma
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 256;          // two warpgroups
constexpr uint32_t kBox = kRows * 128;   // a 64-row box of 64 bf16 columns

// 4 bytes global -> shared, asynchronously; bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// Orders this thread's landed cp.async writes before wgmma's reads (the
// async proxy); the barrier that follows makes them everyone's.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// The arrival that completes a phase once `bytes` more have landed.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// `bytes` more for the current phase, without an arrival.
__device__ __forceinline__ void mbar_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// One box of a tensor map (64 bf16 columns, swizzled by 128 bytes; zeros
// out of bounds) into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1) : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16), counted on
// `bar`.
__device__ __forceinline__ void bulk_1d(uint32_t dst, const void* src,
                                        uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Rows 0 .. ROWS-1 of a (rows, W) bf16 matrix whose rows are `stride`
// elements apart, by cp.async, as wgmma reads them under the 128-byte
// swizzle: W / 64 boxes of ROWS rows x 128 bytes, the 16-byte chunk k of
// row r at chunk k ^ (r % 8) (dst 1024-byte aligned); rows at or past
// `valid` are 0.  The block's THREADS threads take part, thread t chunk
// t % (W / 8) of rows t / (W / 8) + n THREADS / (W / 8), which keep one
// swizzle phase; the caller commits.
template <int W, int ROWS, int THREADS>
__device__ __forceinline__ void load_sw(bf16* dst, const bf16* src,
                                        long long stride, int valid) {
  constexpr int kPer = W / 8, kStep = THREADS / kPer;
  static_assert(kStep % 8 == 0 && ROWS % kStep == 0, "thread layout");
  const int k = threadIdx.x % kPer, r0 = threadIdx.x / kPer;
  bf16* d = dst + (k >> 3) * (ROWS * 64) + r0 * 64 +
            (((k & 7) ^ (r0 & 7)) << 3);
  const bf16* from = src + r0 * stride + k * 8;
#pragma unroll
  for (int n = 0; n < ROWS / kStep; ++n) {
    const bool ok = r0 + n * kStep < valid;
    cp_async16(d + n * kStep * 64, ok ? from + n * kStep * stride : src,
               ok ? 16 : 0);
  }
}

// The element (row, col) of such a swizzled tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ int sw(int row, int col) {
  return (col >> 6) * (ROWS * 64) + row * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

// A wgmma shared-memory descriptor under the 128-byte swizzle: start
// address, leading and stride byte offsets, layout type 1 (128B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// The k16 step kk of a K-major operand (its rows are M or N, K runs along
// them), boxes `box` bytes apart.
__device__ __forceinline__ uint64_t kmaj(uint32_t tile, int kk, uint32_t box) {
  return desc(tile + (kk >> 2) * box + (kk & 3) * 32, 16, 1024);
}

// The k16 step c of an MN-major B (its rows are K: rows 16c .. 16c + 15),
// boxes `box` bytes apart along N; read with the transpose bit.
__device__ __forceinline__ uint64_t mnmaj(uint32_t tile, int c, uint32_t box) {
  return desc(tile + c * 16 * 128, box, 1024);
}

// Pins n accumulators: the compiler may not move a read or write of them
// across this point (wgmma writes them asynchronously).
template <int n>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Pins n registers that an issued wgmma reads (A fragments): called after
// its wait, so that the compiler keeps them until then.
template <int n>
__device__ __forceinline__ void fence_frag(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x N, f32) = (acc ? d : 0) + A (64 x 16, shared, K-major) B (16 x N,
// shared: K-major, or MN-major with TB = 1).
template <int N, int TB>
__device__ __forceinline__ void wg_ss(float* d, uint64_t a, uint64_t b,
                                      int acc);
// d (64 x N, f32) += A (64 x 16, bf16 pairs in registers) B (16 x N,
// shared, MN-major).
template <int N>
__device__ __forceinline__ void wg_rs(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wg_ss<32, 0>(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_ss<64, 0>(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_ss<64, 1>(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_ss<128, 0>(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_ss<128, 1>(float* d, uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_rs<64>(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wg_rs<128>(float* d, const uint32_t* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The first 1024-byte aligned byte of the dynamic shared memory (the
// swizzle's atoms are 1024 bytes).
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  const uint32_t at = smem_u32(raw);
  return raw + (((at + 1023) & ~1023u) - at);
}

// The 16 accumulators of a 64 x 32 tile (two k16 slices of 16 columns) as
// the bf16 A fragments of two k16 steps: slice k is accumulators 8k ..
// 8k + 7 (the m16n8 accumulator map is the m16k16 A map).
__device__ __forceinline__ void to_fragments(const float* v, uint32_t* a) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[4 * k + r] = pack_bf16(v[8 * k + 2 * r], v[8 * k + 2 * r + 1]);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// The scores workspace: tile pair (qt, kt <= qt) of chunk c, batch row b
// and group g at this offset (T = nq (nq + 1) / 2 pairs of the nq = Qp /
// 64 tiles of a chunk, pair qt (qt + 1) / 2 + kt), 64 x 64 floats in
// fragment order: thread `lane` of warp w keeps its four accumulators of
// n8 tile nt at ((w * 8 + nt) * 32 + lane) * 4, so a warp reads 512
// contiguous bytes an n8 tile.
__device__ __forceinline__ long long pair_tile(const Params& p, int b, int c,
                                               int g, int qt, int kt) {
  const int nq = p.Qp / kRows, T = nq * (nq + 1) / 2;
  return (((static_cast<long long>(b) * p.nc + c) * p.G + g) * T +
          qt * (qt + 1) / 2 + kt) *
         kRows * kRows;
}

__host__ __device__ constexpr int scores_smem(int N) {
  return 3 * kRows * N * 2 + 1024;
}

// Pass s, block (query tile qt, chunk c, batch row and group bg), one
// warpgroup: S = C_i B_j^T and S^T = B_j C_i^T of the key tiles kt <= qt,
// 64 x 64 of depth N each, into the scores workspace (S for the query
// pass, S^T for the key pass), once for every head of the group; the key
// tiles through a two-stage cp.async ring.
template <int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_scores(Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* cs = reinterpret_cast<bf16*>(base);       // (64 queries, N)
  bf16* ring = cs + kRows * N;                    // 2 x (64 keys, N)
  const int qt = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0), i0 = qt * kRows;
  if (i0 >= L) return;              // a tile past the ragged last chunk
  const int b = bg / p.G, g = bg - b * p.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* bb = static_cast<const bf16*>(p.Bm) + b * p.bs_b +
                   static_cast<long long>(t0) * p.bs_s + g * p.bs_g;
  const bf16* cb = static_cast<const bf16*>(p.Cm) + b * p.cs_b +
                   static_cast<long long>(t0) * p.cs_s + g * p.cs_g;
  load_sw<N, kRows, kThreads>(cs, cb + static_cast<long long>(i0) * p.cs_s,
                              p.cs_s, min(kRows, L - i0));
  load_sw<N, kRows, kThreads>(ring, bb, p.bs_s, min(kRows, L));
  cp_async_commit();
  const uint32_t ct = smem_u32(cs);
  for (int kt = 0; kt <= qt; ++kt) {
    cp_async_wait_all();            // key tile kt, issued a tile ago
    fence_async_smem();
    __syncthreads();                // ... for every thread; kt - 1 is read
    if (kt < qt) {
      const int j0 = (kt + 1) * kRows;
      load_sw<N, kRows, kThreads>(ring + ((kt + 1) & 1) * kRows * N,
                                  bb + static_cast<long long>(j0) * p.bs_s,
                                  p.bs_s, min(kRows, L - j0));
      cp_async_commit();
    }
    const uint32_t bt = smem_u32(ring + (kt & 1) * kRows * N);
    float s[32], st[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = st[e] = 0.f;
    fence_acc<32>(s);
    fence_acc<32>(st);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wg_ss<64, 0>(s, kmaj(ct, kk, kBox), kmaj(bt, kk, kBox), kk > 0);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wg_ss<64, 0>(st, kmaj(bt, kk, kBox), kmaj(ct, kk, kBox), kk > 0);
    wg_commit_wait();
    fence_acc<32>(s);
    fence_acc<32>(st);
    const long long at = pair_tile(p, b, c, g, qt, kt);
    float4* os = reinterpret_cast<float4*>(p.sc + at) + warp * 8 * 32 + lane;
    float4* ot = reinterpret_cast<float4*>(p.sct + at) + warp * 8 * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      os[nt * 32] =
          make_float4(s[4 * nt], s[4 * nt + 1], s[4 * nt + 2], s[4 * nt + 3]);
      ot[nt * 32] = make_float4(st[4 * nt], st[4 * nt + 1], st[4 * nt + 2],
                                st[4 * nt + 3]);
    }
  }
}

constexpr int kMaxSmem = 232448;         // a block's opt-in shared memory

// Pass c1's shared memory, in bytes from a 1024-byte aligned base, for HPS
// heads a stage (one a warpgroup): the key tile's B, each head's G_c (hi
// and lo planes), x_j, cum and dt (two of each: this head pair's and the
// next's), the ring's two slots (each head's dy_i, C_i and the S^T tile,
// float32) and the warps' dD sums.
template <int P, int N, int HPS>
struct KeysSmem {
  static constexpr int kSlot = kRows * (HPS * P + N) * 2 + kRows * kRows * 4;
  static constexpr int kB = 0;
  static constexpr int kG = kB + kRows * N * 2;
  static constexpr int kX = kG + HPS * 2 * P * N * 2;
  static constexpr int kRing = kX + 2 * HPS * kRows * P * 2;
  static constexpr int kCum = kRing + 2 * kSlot;
  static constexpr int kXch = kCum + 2 * HPS * 2 * kMaxQ * 4;
  static constexpr int kBar = kXch + 8 * 4;      // full[2], planes
  static constexpr int kBytes = kBar + 3 * 8 + 1024;
  static_assert(kSlot >= kRows * N * 4, "dB exchange space");
};

// Pass c2's: the query tile's C, each head's S_prev (hi and lo planes),
// dy_i, cum and dt (two of each), the ring's two slots (each head's x_j,
// B_j and the S tile, float32).
template <int P, int N, int HPS>
struct QueriesSmem {
  static constexpr int kSlot = kRows * (HPS * P + N) * 2 + kRows * kRows * 4;
  static constexpr int kC = 0;
  static constexpr int kSp = kC + kRows * N * 2;
  static constexpr int kDy = kSp + HPS * 2 * P * N * 2;
  static constexpr int kRing = kDy + 2 * HPS * kRows * P * 2;
  static constexpr int kCum = kRing + 2 * kSlot;
  static constexpr int kBar = kCum + 2 * HPS * 2 * kMaxQ * 4;
  static constexpr int kBytes = kBar + 3 * 8 + 1024;
  static_assert(kSlot >= kRows * N * 4, "dC exchange space");
};

// Heads a stage: two (a warpgroup each) where their tiles fit a block's
// shared memory (P = 64), else one, the second warpgroup idle (P = 128:
// each head's G_c or S_prev planes alone are 32 or 64 KB).
template <int P, int N>
__host__ __device__ constexpr int pair_heads() {
  return KeysSmem<P, N, 2>::kBytes <= kMaxSmem &&
                 QueriesSmem<P, N, 2>::kBytes <= kMaxSmem
             ? 2
             : 1;
}
template <int P, int N>
using KeysLayout = KeysSmem<P, N, pair_heads<P, N>()>;
template <int P, int N>
using QueriesLayout = QueriesSmem<P, N, pair_heads<P, N>()>;

// Pass c1, block (key tile kt, chunk c, batch row and split), two
// warpgroups in step: dx, ddt's direct part, dcum's key-side part, T_j and
// the split's dB for the 64 key rows j0 .. j0+63.  Warpgroup w takes head
// h0 + HPS m + w of the m-th head pair, all of it: its state terms, and
// for each query tile i >= kt (a stage) dY^T and the masked products in
// two halves of 32 queries, so that dx and the row sums never leave it;
// the pair shares the stage's C_i and S^T tile.  The stages' dy_i, C_i and
// S^T are staged by cp.async while the stage before runs; x_j, cum and dt
// of the next pair come with its first stage, its G_c planes as soon as
// this pair's state terms have read the last ones.  Warp q of a
// warpgroup holds key rows 16q + l/4 and + 8 (lane l), columns 8n +
// 2(l%4) + e: accumulator 4n + 2i + e.
template <int P, int N>
__global__ void __launch_bounds__(kWgThreads, 1)
    ssd_bwd_keys_wgmma(__grid_constant__ const CUtensorMap x_map,
                       __grid_constant__ const CUtensorMap dy_map,
                       __grid_constant__ const CUtensorMap b_map,
                       __grid_constant__ const CUtensorMap c_map,
                       __grid_constant__ const CUtensorMap g_map,
                       const Params p) {
  constexpr int HPS = pair_heads<P, N>();
  using K = KeysLayout<P, N>;
  static_assert(K::kBytes <= kMaxSmem, "shared memory");
  constexpr uint32_t kGBox = P * 128;   // G_c's boxes: P rows of 64 columns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* bsm = reinterpret_cast<bf16*>(base + K::kB);
  float* xch = reinterpret_cast<float*>(base + K::kXch);
  const int kt = blockIdx.z, c = blockIdx.x;
  const int b = blockIdx.y / p.nsplit, s = blockIdx.y - b * p.nsplit;
  const int h0 = s * p.Hs, g = h0 / (p.H / p.G);
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0), j0 = kt * kRows;
  if (j0 >= L) return;              // a tile past the ragged last chunk
  const int n_tiles = (L + kRows - 1) / kRows;
  const int nI = n_tiles - kt, T = (p.Hs + HPS - 1) / HPS * nI;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, tq = lane & 3, r0 = warp * 16 + (lane >> 2);
  const int rj0 = j0 + r0, rj1 = rj0 + 8;
  const long long row_dy = static_cast<long long>(p.H) * P;
  const float* dtb = p.dt + (static_cast<long long>(b) * p.S + t0) * p.H;
  const uint32_t full = smem_u32(base + K::kBar), planes = full + 16;
  // head w of pair m: its slot of each kind
  auto slot = [&](int t) { return base + K::kRing + (t & 1) * K::kSlot; };
  auto xslot = [&](int m, int w) {
    return reinterpret_cast<bf16*>(base + K::kX +
                                   ((m & 1) * HPS + w) * kRows * P * 2);
  };
  auto cslot = [&](int m, int w) {
    return reinterpret_cast<float*>(base + K::kCum +
                                    ((m & 1) * HPS + w) * 2 * kMaxQ * 4);
  };
  // stage t = (pair m, query tile kt + ti)'s copies, by TMA from one
  // thread, on full[t % 2]: each head's dy_i, C_i and the S^T tile, with
  // x_j and cum when it starts a pair (rows past S arrive as zeros)
  auto load_stage = [&](int t, int m, int ti) {
    const int it = kt + ti, i0 = it * kRows;
    const int heads = min(HPS, p.Hs - HPS * m);
    const uint32_t bar = full + 8 * (t & 1), sl = smem_u32(slot(t));
    mbar_arrive_tx(bar, heads * kRows * P * 2 + kRows * N * 2 +
                            kRows * kRows * 4 +
                            (ti == 0 ? heads * (kRows * P * 2 + p.Qp * 4)
                                     : 0));
    for (int w = 0; w < heads; ++w) {
      const int h = h0 + HPS * m + w;
#pragma unroll
      for (int cc = 0; cc < P / 64; ++cc) {
        tma_4d(sl + w * kRows * P * 2 + cc * kBox, &dy_map, bar, 64 * cc, h,
               t0 + i0, b);
        if (ti == 0)
          tma_4d(smem_u32(xslot(m, w)) + cc * kBox, &x_map, bar, 64 * cc, h,
                 t0 + j0, b);
      }
      if (ti == 0)
        bulk_1d(smem_u32(cslot(m, w)),
                p.cum +
                    ((static_cast<long long>(b) * p.H + h) * p.nc + c) * p.Qp,
                p.Qp * 4, bar);
    }
#pragma unroll
    for (int cc = 0; cc < N / 64; ++cc)
      tma_4d(sl + HPS * kRows * P * 2 + cc * kBox, &c_map, bar, 64 * cc, g,
             t0 + i0, b);
    bulk_1d(sl + kRows * (HPS * P + N) * 2,
            p.sct + pair_tile(p, b, c, g, it, kt), kRows * kRows * 4, bar);
  };
  // dt of pair m's heads (strided, so by cp.async, every thread)
  auto load_dt = [&](int m) {
    for (int w = 0; w < min(HPS, p.Hs - HPS * m); ++w) {
      float* to = cslot(m, w) + kMaxQ;
      const float* from = dtb + h0 + HPS * m + w;
      for (int j = tid; j < p.Qp; j += kWgThreads)
        cp_async4(to + j, from + static_cast<long long>(j < L ? j : 0) * p.H,
                  j < L ? 4 : 0);
    }
    cp_async_commit();
  };
  // the G_c planes of pair m's heads, on `planes`
  auto load_g = [&](int m) {
    const int heads = min(HPS, p.Hs - HPS * m);
    mbar_arrive_tx(planes, heads * 2 * P * N * 2);
    for (int w = 0; w < heads; ++w) {
      const int row = static_cast<int>(2 * state_at(p, b, c, h0 + HPS * m + w) /
                                       N);
      const uint32_t to = smem_u32(base + K::kG + w * 2 * P * N * 2);
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int cc = 0; cc < N / 64; ++cc)
          tma_2d(to + pl * P * N * 2 + cc * P * 128, &g_map, planes, 64 * cc,
                 row + pl * P);
    }
  };

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init(planes, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_tx(full, kRows * N * 2);   // the key tile's B, with stage 0
#pragma unroll
    for (int cc = 0; cc < N / 64; ++cc)
      tma_4d(smem_u32(bsm) + cc * kBox, &b_map, full, 64 * cc, g, t0 + j0, b);
    load_stage(0, 0, 0);
    load_g(0);
  }
  load_dt(0);

  float db[N / 2], dx[P / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) db[e] = 0.f;
#pragma unroll
  for (int e = 0; e < P / 2; ++e) dx[e] = 0.f;
  float cj0 = 0.f, cj1 = 0.f, d0 = 0.f, d1 = 0.f, e0 = 0.f, e1 = 0.f;
  float w0 = 0.f, w1 = 0.f, z0 = 0.f, z1 = 0.f;
  float cr = 0.f, f0 = 0.f, f1 = 0.f, fd0 = 0.f, fd1 = 0.f;
  float co0 = 0.f, co1 = 0.f;       // sum_i S L dY of rows rj0, rj1 below
                                    // the diagonal tile (all i > j)
  float cs0 = 0.f, cs1 = 0.f;       // ... on it, over i >= j
  float ks0 = 0.f, ks1 = 0.f;       // ... on it, over i > j
  const uint32_t bt = smem_u32(bsm);
  const uint32_t gt = smem_u32(base + K::kG + wg * 2 * P * N * 2);
  for (int t = 0, m = 0, ti = 0; t < T; ++t) {
    const int it = kt + ti, i0 = it * kRows, hh = HPS * m + wg, h = h0 + hh;
    // this warpgroup has a head in this pair (an odd split's last pair
    // leaves the second one idle; with HPS = 1 it always is)
    const bool mine = wg < HPS && hh < p.Hs;
    // this stage's copies were issued a stage ago (and a pair's G_c
    // planes during the last pair's first stage)
    mbar_wait(full + 8 * (t & 1), (t >> 1) & 1);
    if (ti == 0) mbar_wait(planes, m & 1);
    cp_async_wait_all();            // dt
    __syncthreads();                // ... for every thread; stage t-1 is read
    if (t + 1 < T) {
      const bool next = ti + 1 == nI;
      if (tid == 0) load_stage(t + 1, m + next, next ? 0 : ti + 1);
      if (next) load_dt(m + 1);
    }
    const float* cum = cslot(m, mine ? wg : 0);
    const float* dts = cum + kMaxQ;
    const bf16* xs = xslot(m, mine ? wg : 0);
    const uint32_t xt = smem_u32(xs);
    unsigned char* sl = slot(t);
    const bf16* dys = reinterpret_cast<const bf16*>(sl + wg * kRows * P * 2);
    const uint32_t yt = smem_u32(dys);
    const uint32_t ct = smem_u32(sl + HPS * kRows * P * 2);
    const float4* stile =
        reinterpret_cast<const float4*>(sl + kRows * (HPS * P + N) * 2);

    if (ti == 0) {
      if (mine) {                   // the head's state terms
        const float tot = cum[L - 1] * kLog2e;
        cj0 = cum[rj0] * kLog2e;
        cj1 = cum[rj1] * kLog2e;
        d0 = dts[rj0];
        d1 = dts[rj1];
        e0 = ex2(tot - cj0);
        e1 = ex2(tot - cj1);
        w0 = e0 * d0;
        w1 = e1 * d1;
        // below the diagonal tile exp(c_i - c_j) = exp(c_i - c_r) exp(c_r -
        // c_j), c_r the key tile's last cum: each factor is at most 1 (dt
        // >= 0, A <= 0), so neither overflows
        cr = cum[j0 + kRows - 1] * kLog2e;
        f0 = ex2(cr - cj0);
        f1 = ex2(cr - cj1);
        fd0 = f0 * d0;
        fd1 = f1 * d1;
        // dB += (w_j x_j) G: x_j scaled by w_j in float32 and rounded to
        // bf16 once, in registers
        uint32_t a[P / 16][4];
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk) {
          const int col = kk * 16 + 2 * tq;
          const float2 x00 = bf16x2(xs + sw<kRows>(r0, col));
          const float2 x10 = bf16x2(xs + sw<kRows>(r0 + 8, col));
          const float2 x01 = bf16x2(xs + sw<kRows>(r0, col + 8));
          const float2 x11 = bf16x2(xs + sw<kRows>(r0 + 8, col + 8));
          a[kk][0] = pack_bf16(w0 * x00.x, w0 * x00.y);
          a[kk][1] = pack_bf16(w1 * x10.x, w1 * x10.y);
          a[kk][2] = pack_bf16(w0 * x01.x, w0 * x01.y);
          a[kk][3] = pack_bf16(w1 * x11.x, w1 * x11.y);
        }
        // dx starts as B_j G^T (hi, lo), in the same group
#pragma unroll
        for (int e = 0; e < P / 2; ++e) dx[e] = 0.f;
        fence_acc<N / 2>(db);
        fence_acc<P / 2>(dx);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk) {
          wg_rs<N>(db, a[kk], mnmaj(gt, kk, kGBox));
          wg_rs<N>(db, a[kk], mnmaj(gt + P * N * 2, kk, kGBox));
        }
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          wg_ss<P, 0>(dx, kmaj(bt, kk, kBox), kmaj(gt, kk, kGBox), kk > 0);
          wg_ss<P, 0>(dx, kmaj(bt, kk, kBox),
                      kmaj(gt + P * N * 2, kk, kGBox), 1);
        }
        wg_commit_wait();
        fence_frag<P / 4>(&a[0][0]);
        fence_acc<N / 2>(db);
        fence_acc<P / 2>(dx);
        // z_j = x_j.(G B_j), then dx scaled by w_j
        z0 = z1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const int col = nt * 8 + 2 * tq;
          const float2 x0 = bf16x2(xs + sw<kRows>(r0, col));
          const float2 x1 = bf16x2(xs + sw<kRows>(r0 + 8, col));
          z0 += x0.x * dx[4 * nt] + x0.y * dx[4 * nt + 1];
          z1 += x1.x * dx[4 * nt + 2] + x1.y * dx[4 * nt + 3];
          dx[4 * nt] *= w0;
          dx[4 * nt + 1] *= w0;
          dx[4 * nt + 2] *= w1;
          dx[4 * nt + 3] *= w1;
        }
        z0 = quad_sum(z0);
        z1 = quad_sum(z1);
        co0 = co1 = cs0 = cs1 = ks0 = ks1 = 0.f;
      }
      __syncthreads();              // both warpgroups are done with G_c
      if (tid == 0 && HPS * (m + 1) < p.Hs) load_g(m + 1);
    }

    if (mine) {
      // the pair (key tile kt, query tile it) in two halves of 32 queries:
      // dY^T = x_j dy_i^T of the second half is issued with the first
      // half's products
      float yv[16], sv[16];
      uint32_t sa[8], da[8];
#pragma unroll
      for (int e = 0; e < 16; ++e) yv[e] = 0.f;
      fence_acc<16>(yv);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        wg_ss<32, 0>(yv, kmaj(xt, kk, kBox), kmaj(yt, kk, kBox), kk > 0);
      wg_commit();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        wg_wait();
        if (half == 1) {
          fence_frag<8>(sa);
          fence_frag<8>(da);
        }
        fence_acc<16>(yv);
        fence_acc<P / 2>(dx);
        fence_acc<N / 2>(db);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          reinterpret_cast<float4*>(sv)[q] =
              stile[(warp * 8 + 4 * half + q) * 32 + lane];
        if (it == kt) {
          // the diagonal tile: pairs i < j (and i past L) are set to 0 by
          // a select, never multiplied by their decay, which may be
          // infinite
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = i0 + 32 * half + 8 * q + 2 * tq + u;
              const float ci = cum[i] * kLog2e;
              const float l0 = i >= rj0 && i < L ? ex2(ci - cj0) : 0.f;
              const float l1 = i >= rj1 && i < L ? ex2(ci - cj1) : 0.f;
              const int a0 = 4 * q + u, a1 = a0 + 2;
              const float s0 = sv[a0] * l0, s1 = sv[a1] * l1;
              const float m0 = s0 * yv[a0], m1 = s1 * yv[a1];
              cs0 += m0;
              cs1 += m1;
              ks0 += i > rj0 ? m0 : 0.f;
              ks1 += i > rj1 ? m1 : 0.f;
              sv[a0] = s0 * d0;
              sv[a1] = s1 * d1;
              yv[a0] *= l0 * d0;
              yv[a1] *= l1 * d1;
            }
        } else {
          // below it every pair has j < i, and queries past L meet zero
          // rows of C and dy: no mask, the decay in its two factors
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = i0 + 32 * half + 8 * q + 2 * tq + u;
              const float gi = ex2(cum[i] * kLog2e - cr);
              const float l0 = gi * f0, l1 = gi * f1;
              const float ld0 = gi * fd0, ld1 = gi * fd1;
              const int a0 = 4 * q + u, a1 = a0 + 2;
              co0 += sv[a0] * l0 * yv[a0];
              co1 += sv[a1] * l1 * yv[a1];
              sv[a0] *= ld0;
              sv[a1] *= ld1;
              yv[a0] *= ld0;
              yv[a1] *= ld1;
            }
        }
        // dx += (S^T L dt) dy_i, dB += (dY^T L dt) C_i: the masked
        // products are, packed to bf16, the A fragments of these queries
        to_fragments(sv, sa);
        to_fragments(yv, da);
        fence_acc<P / 2>(dx);
        fence_acc<N / 2>(db);
        fence_acc<16>(yv);
        wg_fence();
        wg_rs<P>(dx, sa, mnmaj(yt, 2 * half, kBox));
        wg_rs<P>(dx, sa + 4, mnmaj(yt, 2 * half + 1, kBox));
        wg_rs<N>(db, da, mnmaj(ct, 2 * half, kBox));
        wg_rs<N>(db, da + 4, mnmaj(ct, 2 * half + 1, kBox));
        if (half == 0) {
#pragma unroll
          for (int kk = 0; kk < P / 16; ++kk)
            wg_ss<32, 0>(yv, kmaj(xt, kk, kBox),
                         kmaj(yt + 32 * 128, kk, kBox), kk > 0);
        }
        wg_commit();
      }
      wg_wait();
      fence_frag<8>(sa);
      fence_frag<8>(da);
      fence_acc<P / 2>(dx);
      fence_acc<N / 2>(db);

      if (it == kt) {               // dy_i holds the key tile's own rows
        const float Dh = p.D[h];
        float dd = 0.f;
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const int col = nt * 8 + 2 * tq;
          const float2 y0 = bf16x2(dys + sw<kRows>(r0, col));
          const float2 y1 = bf16x2(dys + sw<kRows>(r0 + 8, col));
          const float2 x0 = bf16x2(xs + sw<kRows>(r0, col));
          const float2 x1 = bf16x2(xs + sw<kRows>(r0 + 8, col));
          dx[4 * nt] += Dh * y0.x;
          dx[4 * nt + 1] += Dh * y0.y;
          dx[4 * nt + 2] += Dh * y1.x;
          dx[4 * nt + 3] += Dh * y1.y;
          dd += y0.x * x0.x + y0.y * x0.y + y1.x * x1.x + y1.y * x1.y;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dd += __shfl_xor_sync(kFull, dd, o);
        if (lane == 0) xch[4 * wg + warp] = dd;
      }

      if (ti == nI - 1) {           // the head's last stage: its outputs
        co0 = quad_sum(co0);
        co1 = quad_sum(co1);
        cs0 = quad_sum(cs0) + co0;
        cs1 = quad_sum(cs1) + co1;
        ks0 = quad_sum(ks0) + co0;
        ks1 = quad_sum(ks1) + co1;
        // the warpgroup's four dD sums, in order
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if ((tid & 127) == 0)
          p.dDp[((static_cast<long long>(b) * p.H + h) * p.nc + c) *
                    (p.Qp / kRows) + kt] =
              xch[4 * wg] + xch[4 * wg + 1] + xch[4 * wg + 2] +
              xch[4 * wg + 3];
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
                __floats2bfloat162_rn(dx[4 * nt], dx[4 * nt + 1]);
          if (rj1 < L)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * row_dy + nt * 8) =
                __floats2bfloat162_rn(dx[4 * nt + 2], dx[4 * nt + 3]);
        }
      }
    }
    if (++ti == nI) {
      ti = 0;
      ++m;
    }
  }

  // the split's dB: the second warpgroup's heads meet the first's, in order
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(base + K::kRing);
  if (wg == 1) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k)
      part[k * 128 + (tid & 127)] =
          make_float4(db[4 * k], db[4 * k + 1], db[4 * k + 2], db[4 * k + 3]);
  }
  __syncthreads();
  if (wg == 1) return;
  float* out = p.dbp + ((static_cast<long long>(b) * p.S + t0 + rj0) *
                            p.nsplit + s) * N + 2 * tq;
  const long long row = static_cast<long long>(p.nsplit) * N;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const float4 v = part[nt * 128 + tid];
    if (rj0 < L)
      *reinterpret_cast<float2*>(out + nt * 8) =
          make_float2(db[4 * nt] + v.x, db[4 * nt + 1] + v.y);
    if (rj1 < L)
      *reinterpret_cast<float2*>(out + 8 * row + nt * 8) =
          make_float2(db[4 * nt + 2] + v.z, db[4 * nt + 3] + v.w);
  }
}

// Pass c2, block (query tile qt, chunk c, batch row and split), two
// warpgroups in step: the split's dC and dcum's query-side part for the 64
// query rows i0 .. i0+63.  Warpgroup w takes head h0 + HPS m + w of the
// m-th head pair, all of it: exp(cum_i) dy_i S_prev, then for each key
// tile j <= qt (a stage) dY and the masked products in two halves of 32
// keys; the pair shares the stage's B_j and S tile.  The stages' x_j, B_j
// and S are staged by cp.async while the stage before runs; dy_i, cum and
// dt of the next pair come with its first stage, its S_prev planes as
// soon as this pair's state terms have read the last ones.  The
// accumulator map is the key pass's.
template <int P, int N>
__global__ void __launch_bounds__(kWgThreads, 1)
    ssd_bwd_queries_wgmma(__grid_constant__ const CUtensorMap x_map,
                          __grid_constant__ const CUtensorMap dy_map,
                          __grid_constant__ const CUtensorMap b_map,
                          __grid_constant__ const CUtensorMap c_map,
                          __grid_constant__ const CUtensorMap e_map,
                          const Params p) {
  constexpr int HPS = pair_heads<P, N>();
  using Q = QueriesLayout<P, N>;
  static_assert(Q::kBytes <= kMaxSmem, "shared memory");
  constexpr uint32_t kSBox = P * 128;   // S_prev's boxes: P rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* csm = reinterpret_cast<bf16*>(base + Q::kC);
  const int qt = gridDim.z - 1 - blockIdx.z, c = blockIdx.x;
  const int b = blockIdx.y / p.nsplit, s = blockIdx.y - b * p.nsplit;
  const int h0 = s * p.Hs, g = h0 / (p.H / p.G);
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0), i0 = qt * kRows;
  if (i0 >= L) return;
  const int nJ = qt + 1, T = (p.Hs + HPS - 1) / HPS * nJ;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, tq = lane & 3, r0 = warp * 16 + (lane >> 2);
  const int ri0 = i0 + r0, ri1 = ri0 + 8;
  const bool has_prev = c > 0 || p.has_init;
  const float* dtb = p.dt + (static_cast<long long>(b) * p.S + t0) * p.H;
  const uint32_t full = smem_u32(base + Q::kBar), planes = full + 16;
  auto slot = [&](int t) { return base + Q::kRing + (t & 1) * Q::kSlot; };
  auto dslot = [&](int m, int w) {
    return reinterpret_cast<bf16*>(base + Q::kDy +
                                   ((m & 1) * HPS + w) * kRows * P * 2);
  };
  auto cslot = [&](int m, int w) {
    return reinterpret_cast<float*>(base + Q::kCum +
                                    ((m & 1) * HPS + w) * 2 * kMaxQ * 4);
  };
  // stage t = (pair m, key tile jt)'s copies, by TMA from one thread, on
  // full[t % 2]: each head's x_j, B_j and the S tile, with dy_i and cum
  // when it starts a pair (rows past S arrive as zeros)
  auto load_stage = [&](int t, int m, int jt) {
    const int j0 = jt * kRows;
    const int heads = min(HPS, p.Hs - HPS * m);
    const uint32_t bar = full + 8 * (t & 1), sl = smem_u32(slot(t));
    mbar_arrive_tx(bar, heads * kRows * P * 2 + kRows * N * 2 +
                            kRows * kRows * 4 +
                            (jt == 0 ? heads * (kRows * P * 2 + p.Qp * 4)
                                     : 0));
    for (int w = 0; w < heads; ++w) {
      const int h = h0 + HPS * m + w;
#pragma unroll
      for (int cc = 0; cc < P / 64; ++cc) {
        tma_4d(sl + w * kRows * P * 2 + cc * kBox, &x_map, bar, 64 * cc, h,
               t0 + j0, b);
        if (jt == 0)
          tma_4d(smem_u32(dslot(m, w)) + cc * kBox, &dy_map, bar, 64 * cc, h,
                 t0 + i0, b);
      }
      if (jt == 0)
        bulk_1d(smem_u32(cslot(m, w)),
                p.cum +
                    ((static_cast<long long>(b) * p.H + h) * p.nc + c) * p.Qp,
                p.Qp * 4, bar);
    }
#pragma unroll
    for (int cc = 0; cc < N / 64; ++cc)
      tma_4d(sl + HPS * kRows * P * 2 + cc * kBox, &b_map, bar, 64 * cc, g,
             t0 + j0, b);
    bulk_1d(sl + kRows * (HPS * P + N) * 2,
            p.sc + pair_tile(p, b, c, g, qt, jt), kRows * kRows * 4, bar);
  };
  // dt of pair m's heads (strided, so by cp.async, every thread)
  auto load_dt = [&](int m) {
    for (int w = 0; w < min(HPS, p.Hs - HPS * m); ++w) {
      float* to = cslot(m, w) + kMaxQ;
      const float* from = dtb + h0 + HPS * m + w;
      for (int j = tid; j < p.Qp; j += kWgThreads)
        cp_async4(to + j, from + static_cast<long long>(j < L ? j : 0) * p.H,
                  j < L ? 4 : 0);
    }
    cp_async_commit();
  };
  // the S_prev planes of pair m's heads, on `planes`
  auto load_sp = [&](int m) {
    const int heads = min(HPS, p.Hs - HPS * m);
    mbar_arrive_tx(planes, heads * 2 * P * N * 2);
    for (int w = 0; w < heads; ++w) {
      const int row = static_cast<int>(2 * state_at(p, b, c, h0 + HPS * m + w) /
                                       N);
      const uint32_t to = smem_u32(base + Q::kSp + w * 2 * P * N * 2);
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int cc = 0; cc < N / 64; ++cc)
          tma_2d(to + pl * P * N * 2 + cc * P * 128, &e_map, planes, 64 * cc,
                 row + pl * P);
    }
  };

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    mbar_init(planes, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_tx(full, kRows * N * 2);   // the query tile's C, with stage 0
#pragma unroll
    for (int cc = 0; cc < N / 64; ++cc)
      tma_4d(smem_u32(csm) + cc * kBox, &c_map, full, 64 * cc, g, t0 + i0, b);
    load_stage(0, 0, 0);
    if (has_prev) load_sp(0);
  }
  load_dt(0);

  float dc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) dc[e] = 0.f;
  float ci0 = 0.f, ci1 = 0.f, y0 = 0.f, y1 = 0.f, rs0 = 0.f, rs1 = 0.f;
  float cr = 0.f, g0 = 0.f, g1 = 0.f;
  const uint32_t spt = smem_u32(base + Q::kSp + wg * 2 * P * N * 2);
  for (int t = 0, m = 0, jt = 0; t < T; ++t) {
    const int j0 = jt * kRows, hh = HPS * m + wg, h = h0 + hh;
    const bool mine = wg < HPS && hh < p.Hs;
    mbar_wait(full + 8 * (t & 1), (t >> 1) & 1);
    if (jt == 0 && has_prev) mbar_wait(planes, m & 1);
    cp_async_wait_all();            // dt
    __syncthreads();
    if (t + 1 < T) {
      const bool next = jt == qt;
      if (tid == 0) load_stage(t + 1, m + next, next ? 0 : jt + 1);
      if (next) load_dt(m + 1);
    }
    const float* cum = cslot(m, mine ? wg : 0);
    const float* dts = cum + kMaxQ;
    const uint32_t dyt = smem_u32(dslot(m, mine ? wg : 0));
    unsigned char* sl = slot(t);
    const uint32_t xt = smem_u32(sl + wg * kRows * P * 2);
    const uint32_t bt = smem_u32(sl + HPS * kRows * P * 2);
    const float4* stile =
        reinterpret_cast<const float4*>(sl + kRows * (HPS * P + N) * 2);

    if (jt == 0) {
      if (mine) {                   // the head's state term
        ci0 = cum[ri0] * kLog2e;
        ci1 = cum[ri1] * kLog2e;
        // before the diagonal tile exp(c_i - c_j) = exp(c_i - c_r) exp(c_r
        // - c_j), c_r the query tile's first cum: each factor at most 1
        cr = cum[i0] * kLog2e;
        g0 = ex2(ci0 - cr);
        g1 = ex2(ci1 - cr);
        y0 = y1 = rs0 = rs1 = 0.f;
        if (has_prev) {             // dC += exp(cum_i) dy_i S_prev (hi, lo)
          float ta[N / 2];
#pragma unroll
          for (int e = 0; e < N / 2; ++e) ta[e] = 0.f;
          fence_acc<N / 2>(ta);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < P / 16; ++kk) {
            wg_ss<N, 1>(ta, kmaj(dyt, kk, kBox), mnmaj(spt, kk, kSBox),
                        kk > 0);
            wg_ss<N, 1>(ta, kmaj(dyt, kk, kBox),
                        mnmaj(spt + P * N * 2, kk, kSBox), 1);
          }
          wg_commit_wait();
          fence_acc<N / 2>(ta);
          const float ea = ex2(ci0), eb = ex2(ci1);
#pragma unroll
          for (int nt = 0; nt < N / 8; ++nt) {
            const int col = nt * 8 + 2 * tq;
            const float2 c0 = bf16x2(csm + sw<kRows>(r0, col));
            const float2 c1 = bf16x2(csm + sw<kRows>(r0 + 8, col));
            const float v0 = ta[4 * nt] * ea, v1 = ta[4 * nt + 1] * ea;
            const float v2 = ta[4 * nt + 2] * eb, v3 = ta[4 * nt + 3] * eb;
            dc[4 * nt] += v0;
            dc[4 * nt + 1] += v1;
            dc[4 * nt + 2] += v2;
            dc[4 * nt + 3] += v3;
            y0 += c0.x * v0 + c0.y * v1;   // C_i . its dC term: y_inter
            y1 += c1.x * v2 + c1.y * v3;
          }
          y0 = quad_sum(y0);
          y1 = quad_sum(y1);
        }
      }
      __syncthreads();              // both warpgroups are done with S_prev
      if (tid == 0 && has_prev && HPS * (m + 1) < p.Hs) load_sp(m + 1);
    }

    if (mine) {
      // dY = dy_i x_j^T in two halves of 32 keys, the second issued with
      // the first half's product
      float yv[16], sv[16];
      uint32_t dw[8];
#pragma unroll
      for (int e = 0; e < 16; ++e) yv[e] = 0.f;
      fence_acc<16>(yv);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        wg_ss<32, 0>(yv, kmaj(dyt, kk, kBox), kmaj(xt, kk, kBox), kk > 0);
      wg_commit();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        wg_wait();
        if (half == 1) fence_frag<8>(dw);
        fence_acc<16>(yv);
        fence_acc<N / 2>(dc);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          reinterpret_cast<float4*>(sv)[q] =
              stile[(warp * 8 + 4 * half + q) * 32 + lane];
        if (jt == qt) {             // the diagonal tile: masked
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int j = j0 + 32 * half + 8 * q + 2 * tq + u;
              const float cj = cum[j] * kLog2e, dj = dts[j];
              const float wa = j <= ri0 && ri0 < L ? ex2(ci0 - cj) * dj : 0.f;
              const float wb = j <= ri1 && ri1 < L ? ex2(ci1 - cj) * dj : 0.f;
              const int a0 = 4 * q + u, a1 = a0 + 2;
              const float q0 = yv[a0] * wa, q1 = yv[a1] * wb;
              rs0 += j < ri0 ? sv[a0] * q0 : 0.f;
              rs1 += j < ri1 ? sv[a1] * q1 : 0.f;
              yv[a0] = q0;
              yv[a1] = q1;
            }
        } else {                    // before it: j < i, rows past L are 0
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int j = j0 + 32 * half + 8 * q + 2 * tq + u;
              const float fd = ex2(cr - cum[j] * kLog2e) * dts[j];
              const int a0 = 4 * q + u, a1 = a0 + 2;
              const float q0 = yv[a0] * (g0 * fd), q1 = yv[a1] * (g1 * fd);
              rs0 += sv[a0] * q0;
              rs1 += sv[a1] * q1;
              yv[a0] = q0;
              yv[a1] = q1;
            }
        }
        // dC += (dY L dt) B_j
        to_fragments(yv, dw);
        fence_acc<N / 2>(dc);
        fence_acc<16>(yv);
        wg_fence();
        wg_rs<N>(dc, dw, mnmaj(bt, 2 * half, kBox));
        wg_rs<N>(dc, dw + 4, mnmaj(bt, 2 * half + 1, kBox));
        if (half == 0) {
#pragma unroll
          for (int kk = 0; kk < P / 16; ++kk)
            wg_ss<32, 0>(yv, kmaj(dyt, kk, kBox),
                         kmaj(xt + 32 * 128, kk, kBox), kk > 0);
        }
        wg_commit();
      }
      wg_wait();
      fence_frag<8>(dw);
      fence_acc<N / 2>(dc);

      if (jt == qt) {               // the head's last stage: dcum
        rs0 = quad_sum(rs0);
        rs1 = quad_sum(rs1);
        if (tq == 0) {
          const long long at =
              (static_cast<long long>(b) * p.S + t0 + ri0) * p.H + h;
          if (ri0 < L) p.dcum[at] += rs0 + y0;
          if (ri1 < L) p.dcum[at + 8 * p.H] += rs1 + y1;
        }
      }
    }
    if (++jt == nJ) {
      jt = 0;
      ++m;
    }
  }

  // the split's dC: the second warpgroup's heads meet the first's, in order
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(base + Q::kRing);
  if (wg == 1) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k)
      part[k * 128 + (tid & 127)] =
          make_float4(dc[4 * k], dc[4 * k + 1], dc[4 * k + 2], dc[4 * k + 3]);
  }
  __syncthreads();
  if (wg == 1) return;
  float* out = p.dcp + ((static_cast<long long>(b) * p.S + t0 + ri0) *
                            p.nsplit + s) * N + 2 * tq;
  const long long row = static_cast<long long>(p.nsplit) * N;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const float4 v = part[nt * 128 + tid];
    if (ri0 < L)
      *reinterpret_cast<float2*>(out + nt * 8) =
          make_float2(dc[4 * nt] + v.x, dc[4 * nt + 1] + v.y);
    if (ri1 < L)
      *reinterpret_cast<float2*>(out + 8 * row + nt * 8) =
          make_float2(dc[4 * nt + 2] + v.z, dc[4 * nt + 3] + v.w);
  }
}

template <int P, int N>
cudaError_t allow() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_keys_wgmma<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KeysLayout<P, N>::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_queries_wgmma<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               QueriesLayout<P, N>::kBytes);
  return err;
}

cudaError_t init() {
  cudaError_t err = allow<64, 64>();
  if (err == cudaSuccess) err = allow<64, 128>();
  if (err == cudaSuccess) err = allow<128, 64>();
  if (err == cudaSuccess) err = allow<128, 128>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_scores<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               scores_smem(64));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_scores<128>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               scores_smem(128));
  return err;
}

// The most dynamic shared memory a block of the instance takes.
template <int P, int N>
constexpr int smem_pn() {
  constexpr int k = KeysLayout<P, N>::kBytes, q = QueriesLayout<P, N>::kBytes;
  return k > q ? k : q;
}

int max_smem(int P, int N) {
  const int s = static_cast<int>(states_smem());
  int t = 0;
  if (P == 64 && N == 64) t = smem_pn<64, 64>();
  if (P == 64 && N == 128) t = smem_pn<64, 128>();
  if (P == 128 && N == 64) t = smem_pn<128, 64>();
  if (P == 128 && N == 128) t = smem_pn<128, 128>();
  return s > t ? s : t;
}

// a refused tensor map returns kEncodeError + its CUresult, apart from
// the cudaError_t codes
constexpr int kEncodeError = 100000;

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A bfloat16 tensor map over `ptr` with dims[0] contiguous and strides[k]
// elements between steps of dims[k + 1], boxes of 64 columns and box[1 ..]
// more, 128-byte swizzle and zeros out of bounds.
int encode(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
           const long long* strides, const int* box) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], unit[4];
  for (int k = 0; k < rank; ++k) {
    d[k] = static_cast<cuuint64_t>(dims[k]);
    bx[k] = static_cast<cuuint32_t>(box[k]);
    unit[k] = 1;
    if (k + 1 < rank) st[k] = static_cast<cuuint64_t>(strides[k]) * 2;
  }
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d,
      st, bx, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

// (B, S, heads, cols) with the given strides: 64 columns of 64 steps of
// one head of one batch row a box.
int encode_steps(CUtensorMap* map, const void* ptr, int cols, int heads,
                 int S, int B, long long s_h, long long s_s, long long s_b) {
  const long long dims[4] = {cols, heads, S, B}, strides[3] = {s_h, s_s, s_b};
  const int box[4] = {64, 1, kRows, 1};
  return encode(map, ptr, 4, dims, strides, box);
}

// The kept states' bf16 hi, lo planes (B, nc, H, 2, P, N) as N columns of
// B nc H 2 P rows: 64 columns of one (P, N) plane a box.
template <int P, int N>
int encode_planes(CUtensorMap* map, const void* ptr, const Params& p) {
  const long long dims[2] = {N, 2LL * p.Bsz * p.nc * p.H * P},
                  strides[1] = {N};
  const int box[2] = {64, P};
  return encode(map, ptr, 2, dims, strides, box);
}

template <int P, int N>
int launch_pn(const Params& p, int BH, cudaStream_t st) {
  CUtensorMap xm, dym, bm, cm, gm, em;
  const long long HP = static_cast<long long>(p.H) * P;
  int res = encode_steps(&xm, p.x, P, p.H, p.S, p.Bsz, p.xs_h, p.xs_s,
                         p.xs_b);
  if (res == 0)
    res = encode_steps(&dym, p.dy, P, p.H, p.S, p.Bsz, P, HP, HP * p.S);
  if (res == 0)
    res = encode_steps(&bm, p.Bm, N, p.G, p.S, p.Bsz, p.bs_g, p.bs_s, p.bs_b);
  if (res == 0)
    res = encode_steps(&cm, p.Cm, N, p.G, p.S, p.Bsz, p.cs_g, p.cs_s, p.cs_b);
  if (res == 0) res = encode_planes<P, N>(&gm, p.Gs, p);
  if (res == 0) res = encode_planes<P, N>(&em, p.enter, p);
  if (res != 0) return res;
  ssd_bwd_states_mma<<<dim3(p.nc, P / kRows * (N / kRows), BH), kThreads,
                       states_smem(), st>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err != cudaSuccess) return err;
  ssd_bwd_pass<true><<<dim3(p.nblk, BH), kPassThreads, 0, st>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != cudaSuccess) return err;
  const int nq = p.Qp / kRows;
  ssd_bwd_scores<N><<<dim3(nq, p.nc, p.Bsz * p.G), kThreads, scores_smem(N),
                      st>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != cudaSuccess) return err;
  // the tile index is the slowest grid axis, so the blocks that walk the
  // most tiles (key tile 0, the last query tile) start first
  const dim3 tiles(p.nc, p.Bsz * p.nsplit, nq);
  ssd_bwd_keys_wgmma<P, N>
      <<<tiles, kWgThreads, KeysLayout<P, N>::kBytes, st>>>(xm, dym, bm, cm,
                                                              gm, p);
  err = static_cast<int>(cudaGetLastError());
  if (err != cudaSuccess) return err;
  ssd_bwd_queries_wgmma<P, N>
      <<<tiles, kWgThreads, QueriesLayout<P, N>::kBytes, st>>>(xm, dym, bm,
                                                                 cm, em, p);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Params& p, int BH, cudaStream_t st) {
  if (p.P == 64 && p.N == 64) return launch_pn<64, 64>(p, BH, st);
  if (p.P == 64 && p.N == 128) return launch_pn<64, 128>(p, BH, st);
  if (p.P == 128 && p.N == 64) return launch_pn<128, 64>(p, BH, st);
  if (p.P == 128 && p.N == 128) return launch_pn<128, 128>(p, BH, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

// The workspace's parts, in floats, each rounded up to 64 floats (256
// bytes) so that every part starts 16-byte aligned.
struct Workspace {
  long long cum, U, Gs, gdot, dcum, tj, dbp, dcp, dDp, dAp, sc, sct, total;
  Workspace(int B, int S, int H, int G, int P, int N, int Q) {
    auto up = [](long long n) { return (n + 63) / 64 * 64; };
    const long long nc = (S + Q - 1) / Q, Qp = (Q + kRows - 1) / kRows * kRows;
    const long long BH = static_cast<long long>(B) * H, PN = P * N;
    const long long nsplit = H / heads_per_split(H / G);
    const long long nblk = (PN + kPassThreads - 1) / kPassThreads;
    const long long nq = Qp / kRows;
    const long long pairs = static_cast<long long>(B) * nc * G * nq *
                            (nq + 1) / 2 * kRows * kRows;
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
    sc = take(pairs);
    sct = take(pairs);
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
    return tc::max_smem(P, N);
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

// The backward on `stream`: seven kernels (simt), eight (mma: the scores
// pass too).  instance: 0 = simt, 1 = mma (bfloat16 only; the entering
// states as bf16 hi, lo planes).  dtype:
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
  p.sc = base + w.sc;
  p.sct = base + w.sct;
  p.Bsz = B;
  p.S = S;
  p.H = H;
  p.G = G;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.Qp = (Q + kRows - 1) / kRows * kRows;
  p.nc = nc;
  // The split: a block walks Hs heads of one group, from the shapes alone.
  // More heads a block write fewer dB and dC partials (each B S (H / Hs) N
  // floats) and open fewer blocks; fewer keep more blocks for the card's
  // 132 SMs.  The tensor-core passes take up to 16 (mamba2 at 8 x 512: 256
  // blocks a pass, one block an SM, 8.4 MB of partials each; 16 against 8
  // was measured faster on an H100), the SIMT ones up to 8.  The
  // workspace holds the SIMT split's partials, the larger.
  p.Hs = heads_per_split(H / G, instance == 1 ? kMaxSplitTc : kMaxSplit);
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
  int code;
  if (instance == 1) code = tc::launch(p, static_cast<int>(BH), st);
  else if (dtype == 0)
    code = static_cast<int>(simt::launch<float>(p, static_cast<int>(BH), st));
  else code = static_cast<int>(simt::launch<bf16>(p, static_cast<int>(BH), st));
  if (code != 0) return code;
  cudaError_t err;
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
  if (err >= tc::kEncodeError) return "tensor map encoding failed";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
