// Hopper flash-attention backward: the gradients dq, dk, dv of
// position-masked GQA attention, from q, k, v, the output, its gradient and
// the log-sum-exp that the forward saved.
//
// The JAX package has no Pallas backward: it differentiates the jnp path
// of `flash_attention` (src/repro/kernels/flash_attention/ops.py:74, the
// chunked attention of ops.py:44-71).  This is the kernel that the port's
// `FlashAttentionFn` launches for that gradient; the plain PyTorch
// versions it is held against are `ref.py::attention_backward_reference`
// (float32 math) and `ref.py::attention_backward_passes` (the tensor-core
// instance's bf16 roundings).
//
// What it computes, for each (batch b, query row i, query head hq) with
// kv head h = hq / G (group-major GQA) and key j, with the forward's mask
// (valid(i, j) from q_pos, kv_pos, causal and window) and its log-sum-exp
// lse_i = m_i + log l_i of the valid logits (+inf for a row that sees no
// key):
//
//   s_ij  = scale * q_i . k_j,   c_ij = s_ij, or cap * tanh(s_ij / cap)
//   P_ij  = exp(c_ij - lse_i) over the valid keys, 0 elsewhere
//   D_i   = sum_d dO_id * O_id
//   dS_ij = P_ij * (dO_i . v_j - D_i) * (1 - tanh^2(s_ij / cap) with a cap)
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_(i, hq in group h) dS_ij q_i
//   dv_j  = sum_(i, hq in group h) P_ij dO_i
//
// with f32 sums whatever the input dtype (f32 or bf16), each gradient
// rounded once to its input's dtype.  A row that sees no key has lse = +inf,
// so exp(c - lse) = 0 for every key: P = dS = 0, dq = 0 exactly, and nothing
// reaches dk or dv.
//
// Bound: by operations at long sequences, by bytes at qwen2's 8 x 512
// (FlashAttention-2's count: 2.5 x the forward's QK^T and PV work, which
// only the tensor cores deliver at 989 TFLOP/s in bf16).  The tensor-core
// instance reaches about a tenth of it: on an H100 80GB HBM3 at 700 W,
// 0.19 ms of device time at qwen2's 8 x 512 against a 0.0176 ms bound
// (bytes) and 0.58 ms at 2 x 2048 against 0.065 ms (operations), about
// 1.8x and 2.7x SDPA's backward (`chip_smoke.py`, `study.py`).  What
// holds it there (`study.py`): the dk/dv kernel takes as long causal as
// without the mask, so its longest block (key tile 0, which every query
// tile reaches) sets its time; and within a block each warpgroup's tile
// is a dependent chain (products, softmax, products) that the other
// warpgroup hides only in part.  Three kernels a call, chosen by
// `ops.bwd_route` from dtype, head dim and alignment:
//
// flash_bwd_dot (both instances): D_i = dO_i . O_i in f32, one row per
//   Dh / (16 bytes) lanes; bytes-bound.  No pass recomputes the rows' max
//   and normaliser: the forward writes lse.
//
// "wgmma" (bf16, Dh 64 or 128): two FA3-shaped kernels, simple first.  The
//   query rows of a kv head are packed as in the forward, (position, head)
//   pairs position-major, 64 rows = floor(64 / G) positions x G heads, and
//   arrive by TMA through the forward's 4-D tensor map over (Dh, Hq, Sq, B).
//   * flash_bwd_dkdv_wgmma, one block per (64 keys, kv head, batch row):
//     its K and V tiles arrive once; a producer warp streams the packed
//     query tiles that some pair of the block can reach (marked up front
//     from q_pos and kv_pos, as the forward marks its key tiles) through a
//     4-stage mbarrier ring: each stage a Q tile, its dO tile and the rows'
//     lse (log2 domain), D and q_pos.  Two consumer warpgroups take
//     alternate tiles, and per tile: S^T = K Q^T and dP^T = V dO^T (wgmma,
//     both operands from shared memory, K-major), P^T and dS^T in
//     registers, then dV += P^T dO and dK += dS^T Q (wgmma with P^T and
//     dS^T as bf16 A fragments straight from the accumulators, FA3's
//     register reuse; dO and Q the MN-major B operand with the transpose
//     bit, as V in the forward's P V).  The packed rows are the reduction
//     dimension, so the sum over the group's heads happens inside the
//     block; the two warpgroups' sums meet in shared memory in a fixed
//     order at the end: no atomics, two calls give the same bits.
//   * flash_bwd_dq_wgmma, one block per (2 x 64 packed query rows, kv
//     head, batch row), shaped like the forward: each consumer warpgroup
//     loads its Q and dO once, the K/V tiles that some row of the block can
//     reach stream on a 2-stage ring, and per tile S = Q K^T, dP = dO V^T
//     (both shared-memory operands), P and dS in registers, dQ += dS K
//     (dS from registers, K MN-major); the scale is applied once at the end.
//     Keeping dq in its own kernel recomputes two products: that buys
//     determinism without atomics.
//   Registers are the constraint: at Dh 128 a dk/dv thread holds 64 f32 of
//   dK and 64 of dV, and 32 each of S^T and dP^T; with two consumer
//   warpgroups the producer warpgroup drops to 40 registers (setmaxnreg)
//   and the consumers rise to 232.  P and dS are rounded to bf16 before
//   their products, as the forward rounds P; dS is formed from the f32 P.
//   Rows past Sq and keys past Skv are zero-filled by TMA; such rows
//   carry lse = +inf and such keys kv position -1.  The per-element mask
//   runs only on tiles that some pair does not wholly attend.
//
// "simt" (f32, and Dh 32): a dk/dv and a dq pass reading lse and D,
//   every product an f32 FMA from padded f32 tiles in shared
//   memory (TF32 would miss the f32 gate of 1e-4):
//   * flash_bwd_dkdv, one block per (64 keys, kv head, batch row), holds
//     its K and V tiles and its dK and dV sums (a 4-key x Dh/16-column
//     patch a thread, in registers) and loops over the group's G heads and
//     the query tiles, recomputing P and dS per tile;
//   * flash_bwd_dq, one block per (64 query rows, query head, batch row),
//     holds its Q and dO tiles and its dq sums and loops over the key
//     tiles.
//   A (query tile, key tile) pair is skipped before its tiles are read when
//   no pair in it can be valid.  At Dh 128 the dk/dv block needs 163 KB of
//   shared memory, the dq block 146 KB: one block an SM.
//
// The tensor maps are made per call by the C launcher; nothing is cached
// across calls but the driver's tensor-map encoder.
#include <cuda.h>           // CUtensorMap; its encoder is looked up
#include <cudaTypedefs.h>   // through the runtime, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kBQ = 64;          // query rows a tile
constexpr int kBK = 64;          // keys a tile
constexpr int kThreads = 256;    // 16 x 16: a 4 x 4 patch of a 64 x 64 tile
constexpr int kLDP = kBK + 1;    // row stride of the P and dS tiles
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  const float* lse;   // (B, Sq, Hq): the forward's log-sum-exp
  const float* dsum;  // (B, Sq, Hq): D = dO . O, from flash_bwd_dot
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, Hq, Hkv, G;
  int pw;             // "wgmma": positions a packed tile, floor(64 / G)
  int causal, window;
  float scale, softcap;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// ---------------------------------------------------------------------------
// flash_bwd_dot: D = dO . O per (row, head), both instances
// ---------------------------------------------------------------------------

// 16 loaded bytes, widened to f32 (the tag picks the element type).
__device__ __forceinline__ void unpack(const uint4& x, float* d, float) {
  d[0] = __uint_as_float(x.x);
  d[1] = __uint_as_float(x.y);
  d[2] = __uint_as_float(x.z);
  d[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(const uint4& x, float* d,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

// Thread t takes 16 bytes of row t / L (L = DH / (16 bytes) lanes a row,
// a power of two up to 32); the row's lanes sum by shuffles in a fixed
// order.
template <typename T, int DH>
__global__ void __launch_bounds__(256)
    flash_bwd_dot(const T* o, const T* dout, float* dsum, long long rows) {
  constexpr int E = 16 / sizeof(T);
  constexpr int L = DH / E;
  const long long gt = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const long long row = gt / L;
  const int part = static_cast<int>(gt % L);
  float acc = 0.f;
  if (row < rows) {
    float a[E], c[E];
    const size_t at = static_cast<size_t>(row) * DH + part * E;
    unpack(__ldg(reinterpret_cast<const uint4*>(o + at)), a, T());
    unpack(__ldg(reinterpret_cast<const uint4*>(dout + at)), c, T());
#pragma unroll
    for (int e = 0; e < E; ++e) acc = fmaf(a[e], c[e], acc);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (part == 0 && row < rows) dsum[row] = acc;
}

// ---------------------------------------------------------------------------
// "simt": f32 FMAs from shared memory
// ---------------------------------------------------------------------------

template <int DH>
struct Tile {
  static constexpr int LD = DH + 1;        // padded row stride, floats
  static constexpr int kFloats = 64 * LD;  // one 64-row tile
  static constexpr int DC = DH / 16;       // columns a thread, stride 16
};

// Shared memory of each kernel, in bytes: the f32 tiles, the P/dS tiles,
// the rows' lse and D, the two position vectors and the live flag.
template <int DH>
constexpr int dq_smem() {
  return (4 * Tile<DH>::kFloats + kBQ * kLDP + 2 * kBQ + kBQ + kBK + 4) * 4;
}
template <int DH>
constexpr int dkdv_smem() {
  return (4 * Tile<DH>::kFloats + 2 * kBQ * kLDP + 2 * kBQ + kBQ + kBK + 4) *
         4;
}

// Rows [r0, r0 + 64) of head h of a (B, S, H, DH) tensor into a padded
// f32 tile; rows past S are zero.  Neighbouring threads read neighbouring
// elements of a row.
template <typename T, int DH>
__device__ void load_tile(float* dst, const T* src, int b, int r0, int S,
                          int H, int h) {
  for (int idx = threadIdx.x; idx < 64 * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, row = r0 + r;
    float x = 0.f;
    if (row < S)
      x = load_f(src + ((static_cast<size_t>(b) * S + row) * H + h) * DH + d);
    dst[r * Tile<DH>::LD + d] = x;
  }
}

// Positions [r0, r0 + 64) of batch row b; `fill` past S.
__device__ void load_pos(int* dst, const int* src, int b, int r0, int S,
                         int fill) {
  for (int r = threadIdx.x; r < 64; r += kThreads)
    dst[r] = r0 + r < S ? src[static_cast<size_t>(b) * S + r0 + r] : fill;
}

// The rows' lse and D of head h (rows past Sq: +inf and 0; they are
// masked anyway).
__device__ void load_row_stats(float* rlse, float* rD, const Params& p,
                               int b, int h, int i0) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int i = i0 + r;
    if (i < p.Sq) {
      const size_t at = (static_cast<size_t>(b) * p.Sq + i) * p.Hq + h;
      rlse[r] = p.lse[at];
      rD[r] = p.dsum[at];
    } else {
      rlse[r] = INFINITY;
      rD[r] = 0.f;
    }
  }
}

// Whether some (query, key) pair of the two tiles can be valid (the first
// n_rows query rows against the keys whose position is >= 0).  A pair of
// tiles that fails this has every pair masked, so skipping it changes
// nothing.  Warp 0 decides; ends with a barrier.
__device__ bool tiles_live(const int* qp, int n_rows, const int* kp,
                           const Params& p, int* flag) {
  if (threadIdx.x < 32) {
    int qmin = INT_MAX, qmax = INT_MIN, kmin = INT_MAX, kmax = INT_MIN;
    for (int r = threadIdx.x; r < 64; r += 32) {
      if (r < n_rows) {
        qmin = min(qmin, qp[r]);
        qmax = max(qmax, qp[r]);
      }
      if (kp[r] >= 0) {
        kmin = min(kmin, kp[r]);
        kmax = max(kmax, kp[r]);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(kFull, qmin, off));
      qmax = max(qmax, __shfl_xor_sync(kFull, qmax, off));
      kmin = min(kmin, __shfl_xor_sync(kFull, kmin, off));
      kmax = max(kmax, __shfl_xor_sync(kFull, kmax, off));
    }
    if (threadIdx.x == 0) {
      bool live = kmin <= kmax;  // some valid key
      if (p.causal) live = live && kmin <= qmax;
      if (p.window > 0)
        live = live && static_cast<long long>(qmin) - kmax < p.window;
      *flag = live;
    }
  }
  __syncthreads();
  return *flag != 0;
}

// acc[r][c] += A[ty*4 + r] . Bt[tx + 16c] over DH: a 4 x 4 patch of the
// 64 x 64 product of two row-major tiles.
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bt,
                                         float (&acc)[4][4], int ty, int tx) {
  constexpr int LD = Tile<DH>::LD;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty * 4 + r) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Bt[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__device__ __forceinline__ bool valid(const Params& p, int qi, int kj) {
  return kj >= 0 && (!p.causal || kj <= qi) &&
         (p.window <= 0 || qi - kj < p.window);
}

// The logit c of a raw dot product q . k, and tanh(s / cap) for the
// softcap chain (0 without a cap).
__device__ __forceinline__ float logit(const Params& p, float dot,
                                       float* tanh_out) {
  const float s = dot * p.scale;
  if (p.softcap > 0.f) {
    const float t = tanhf(s / p.softcap);
    *tanh_out = t;
    return p.softcap * t;
  }
  *tanh_out = 0.f;
  return s;
}

// P and dS of the thread's patch (query rows ty*4 + r, keys tx + 16c)
// from the raw products Q.K^T and dO.V^T; 0 where masked.
__device__ __forceinline__ void probs_and_grads(
    const Params& p, const float (&qk)[4][4], const float (&dp)[4][4],
    const int* qp, int n_rows, const int* kp, const float* rlse,
    const float* rD, int ty, int tx, float (&P)[4][4], float (&dS)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    const float lse = rlse[i], D = rD[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float t;
      const float x = logit(p, qk[r][c], &t);
      const bool ok = i < n_rows && valid(p, qp[i], kp[tx + 16 * c]);
      const float pr = ok ? expf(x - lse) : 0.f;
      float g = pr * (dp[r][c] - D);
      if (p.softcap > 0.f) g *= 1.f - t * t;
      P[r][c] = pr;
      dS[r][c] = g;
    }
  }
}

// dk and dv of 64 keys, summed over the group's heads and every query tile
// that can see them.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const Params p) {
  constexpr int LD = Tile<DH>::LD, DC = Tile<DH>::DC;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + Tile<DH>::kFloats;
  float* Qs = Vs + Tile<DH>::kFloats;
  float* dOs = Qs + Tile<DH>::kFloats;
  float* Ps = dOs + Tile<DH>::kFloats;
  float* dSs = Ps + kBQ * kLDP;
  float* rlse = dSs + kBQ * kLDP;
  float* rD = rlse + kBQ;
  int* qp = reinterpret_cast<int*>(rD + kBQ);
  int* kp = qp + kBQ;
  int* flag = kp + kBK;
  const int j0 = blockIdx.x * kBK, kvh = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_pos(kp, p.kv_pos, b, j0, p.Skv, -1);
  load_tile<T, DH>(Ks, static_cast<const T*>(p.k), b, j0, p.Skv, p.Hkv, kvh);
  load_tile<T, DH>(Vs, static_cast<const T*>(p.v), b, j0, p.Skv, p.Hkv, kvh);
  float dk[4][DC] = {}, dv[4][DC] = {};
  for (int g = 0; g < p.G; ++g) {
    const int h = kvh * p.G + g;
    for (int i0 = 0; i0 < p.Sq; i0 += kBQ) {
      const int n_rows = min(kBQ, p.Sq - i0);
      __syncthreads();
      load_pos(qp, p.q_pos, b, i0, p.Sq, 0);
      __syncthreads();
      if (!tiles_live(qp, n_rows, kp, p, flag)) continue;
      load_row_stats(rlse, rD, p, b, h, i0);
      load_tile<T, DH>(Qs, static_cast<const T*>(p.q), b, i0, p.Sq, p.Hq, h);
      load_tile<T, DH>(dOs, static_cast<const T*>(p.dout), b, i0, p.Sq, p.Hq,
                       h);
      __syncthreads();
      float qk[4][4] = {}, dp[4][4] = {}, P[4][4], dS[4][4];
      tile_dot<DH>(Qs, Ks, qk, ty, tx);
      tile_dot<DH>(dOs, Vs, dp, ty, tx);
      probs_and_grads(p, qk, dp, qp, n_rows, kp, rlse, rD, ty, tx, P, dS);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Ps[(ty * 4 + r) * kLDP + tx + 16 * c] = P[r][c];
          dSs[(ty * 4 + r) * kLDP + tx + 16 * c] = dS[r][c];
        }
      __syncthreads();
      // keys ty*4 + r, columns tx + 16c: dv += P^T dO, dk += dS^T Q
#pragma unroll 2
      for (int i = 0; i < kBQ; ++i) {
        float pc[4], sc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pc[r] = Ps[i * kLDP + ty * 4 + r];
          sc[r] = dSs[i * kLDP + ty * 4 + r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float o = dOs[i * LD + tx + 16 * c];
          const float qv = Qs[i * LD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dv[r][c] = fmaf(pc[r], o, dv[r][c]);
            dk[r][c] = fmaf(sc[r], qv, dk[r][c]);
          }
        }
      }
    }
  }
  T* DK = static_cast<T*>(p.dk);
  T* DV = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty * 4 + r;
    if (j >= p.Skv) continue;
    const size_t row = ((static_cast<size_t>(b) * p.Skv + j) * p.Hkv + kvh) * DH;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store_f(DK + row + tx + 16 * c, dk[r][c] * p.scale);
      store_f(DV + row + tx + 16 * c, dv[r][c]);
    }
  }
}

// dq of 64 query rows of one head, over every key tile they can see.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const Params p) {
  constexpr int LD = Tile<DH>::LD, DC = Tile<DH>::DC;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + Tile<DH>::kFloats;
  float* Ks = dOs + Tile<DH>::kFloats;
  float* Vs = Ks + Tile<DH>::kFloats;
  float* dSs = Vs + Tile<DH>::kFloats;
  float* rlse = dSs + kBQ * kLDP;
  float* rD = rlse + kBQ;
  int* qp = reinterpret_cast<int*>(rD + kBQ);
  int* kp = qp + kBQ;
  int* flag = kp + kBK;
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G, n_rows = min(kBQ, p.Sq - i0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, DH>(Qs, static_cast<const T*>(p.q), b, i0, p.Sq, p.Hq, h);
  load_tile<T, DH>(dOs, static_cast<const T*>(p.dout), b, i0, p.Sq, p.Hq, h);
  load_pos(qp, p.q_pos, b, i0, p.Sq, 0);
  load_row_stats(rlse, rD, p, b, h, i0);
  float dq[4][DC] = {};
  for (int j0 = 0; j0 < p.Skv; j0 += kBK) {
    __syncthreads();
    load_pos(kp, p.kv_pos, b, j0, p.Skv, -1);
    __syncthreads();
    if (!tiles_live(qp, n_rows, kp, p, flag)) continue;
    load_tile<T, DH>(Ks, static_cast<const T*>(p.k), b, j0, p.Skv, p.Hkv, kvh);
    load_tile<T, DH>(Vs, static_cast<const T*>(p.v), b, j0, p.Skv, p.Hkv, kvh);
    __syncthreads();
    float qk[4][4] = {}, dp[4][4] = {}, P[4][4], dS[4][4];
    tile_dot<DH>(Qs, Ks, qk, ty, tx);
    tile_dot<DH>(dOs, Vs, dp, ty, tx);
    probs_and_grads(p, qk, dp, qp, n_rows, kp, rlse, rD, ty, tx, P, dS);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dSs[(ty * 4 + r) * kLDP + tx + 16 * c] = dS[r][c];
    __syncthreads();
    // rows ty*4 + r, columns tx + 16c: dq += dS K
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float sc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[r] = dSs[(ty * 4 + r) * kLDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) dq[r][c] = fmaf(sc[r], kv, dq[r][c]);
      }
    }
  }
  T* DQ = static_cast<T*>(p.dq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= p.Sq) continue;
    const size_t row = ((static_cast<size_t>(b) * p.Sq + i) * p.Hq + h) * DH;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_f(DQ + row + tx + 16 * c, dq[r][c] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// "wgmma": bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBoxBytes = 64 * 128;   // 64 rows of one 64-column bf16 box
constexpr int kDkdvStages = 4;        // two a consumer warpgroup
constexpr int kDqStages = 2;
constexpr int kWgThreads = 384;       // two consumer warpgroups, a producer
constexpr int kMaxQTiles = 8192;      // packed query tiles a dk/dv block marks
constexpr int kMaxKTiles = 4096;      // key tiles a dq block marks (262,144)
constexpr float kLog2e = 1.4426950408889634f;

// The dk/dv block's shared memory from a 1024-aligned base: its K and V
// tiles, the ring's stages (Q tile, dO tile, the rows' lse2, D and q_pos),
// the barriers and the query tiles' marks.
template <int DH>
struct Dkdv {
  static constexpr int kHalves = DH / 64;            // 64-column boxes
  static constexpr int kTile = kHalves * kBoxBytes;  // 64 rows of DH
  static constexpr int kMeta = 1024;                 // 3 x 64 words
  static constexpr int kStage = 2 * kTile + kMeta;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kBars = kRing + kDkdvStages * kStage;
  static constexpr int kMarks = kBars + 8 * (2 * kDkdvStages + 1);
  static constexpr int kSmem = 1024 + kMarks + kMaxQTiles;
  static_assert(kSmem <= 232448, "shared memory");
  // the second warpgroup's dK and dV meet the first's in the stages
  static_assert(kDkdvStages * kStage >= 128 * DH * 4, "reduction space");
};

// The dq block's: each consumer warpgroup's Q and dO, the ring's stages
// (K tile, V tile, their kv positions), the barriers and the key tiles'
// marks (live; partly masked).
template <int DH>
struct Dq {
  static constexpr int kHalves = DH / 64;
  static constexpr int kTile = kHalves * kBoxBytes;
  static constexpr int kStage = 2 * kTile + 1024;
  static constexpr int kRing = 2 * 2 * kTile;        // two warpgroups
  static constexpr int kBars = kRing + kDqStages * kStage;
  static constexpr int kMarks = kBars + 8 * (2 * kDqStages + 1);
  static constexpr int kSmem = 1024 + kMarks + 2 * kMaxKTiles;
  static_assert(kSmem <= 232448, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// A shared-memory matrix descriptor for wgmma under 128-byte swizzle:
// start address, leading and stride byte offsets in 16-byte units, layout
// type 1 (128B).  The atoms are 1024-aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// The k16 step kk of a K-major 64-row tile stored as 64-column boxes: 32
// bytes into box kk / 4.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
}

// The k16 step c of an MN-major 64-row tile (rows are the reduction):
// rows 16c .. 16c + 15; its 64-column boxes are kBoxBytes apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int c) {
  return smem_desc(tile + c * 16 * 128, kBoxBytes, 1024);
}

// Pins N accumulators: the compiler may not move a read or write of them
// across this point (wgmma writes them asynchronously).
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A (64 x 16, K-major) *
// B (16 x 64, K-major), both from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, bf16 pairs in registers) * B (16 x 128,
// MN-major in shared memory, transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) * B (16 x 64,
// MN-major in shared memory, transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DH == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The 64 x 64 accumulators (4j + 2i + e) as four k16 A fragments, bf16
// pairs: slice c is accumulators 8c .. 8c + 7 (the forward's P reuse).
__device__ __forceinline__ void to_fragments(const float* x, uint32_t* a) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[4 * c + r] = pack_bf16(x[8 * c + 2 * r], x[8 * c + 2 * r + 1]);
}

// P and dS of one element from its raw product s = q . k, its dP, the
// row's lse (log2 domain) and D, and whether the pair is valid: P =
// exp2(c log2e - lse2) (0 when masked or when lse2 = +inf), dS = P (dP -
// D), times 1 - tanh^2 under a softcap.
__device__ __forceinline__ void p_ds(const Params& p, float scale2, float s,
                                     float dp, float lse2, float D, bool ok,
                                     float* pr, float* ds) {
  float t = 0.f, x;
  if (p.softcap > 0.f) {
    t = tanhf(s * p.scale / p.softcap);
    x = p.softcap * t * kLog2e;
  } else {
    x = s * scale2;
  }
  const float e = ok ? exp2f(x - lse2) : 0.f;
  float g = e * (dp - D);
  if (p.softcap > 0.f) g *= 1.f - t * t;
  *pr = e;
  *ds = g;
}

// One block: keys j0 = 64 blockIdx.x .. + 63 of kv head blockIdx.y, batch
// row blockIdx.z.  Warpgroups 0 and 1 are the consumers (both hold all 64
// keys; they take alternate live query tiles), warpgroup 2 the producer, of
// which one warp works.  Thread (warp wq of a consumer, lane l) holds keys
// 16 wq + l/4 + 8i (i = 0, 1) and, of S^T and dP^T, the packed rows
// 8j + 2(l%4) + e: accumulator 4j + 2i + e; of dK and dV the columns
// 8j + 2(l%4) + e.
template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkdv_wgmma(__grid_constant__ const CUtensorMap q_map,
                         __grid_constant__ const CUtensorMap do_map,
                         __grid_constant__ const CUtensorMap k_map,
                         __grid_constant__ const CUtensorMap v_map,
                         const Params p) {
  using C = Dkdv<DH>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int k_lo, k_hi, k_all;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t kt = base, vt = base + C::kTile, ring = base + C::kRing;
  const uint32_t full = base + C::kBars;                // full[s]: +8s
  const uint32_t empty = full + 8 * kDkdvStages;        // empty[s]: +8s
  const uint32_t kvbar = empty + 8 * kDkdvStages;
  uint8_t* marks = base_ptr + C::kMarks;

  const int kvh = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * 64;
  const int G = p.G, pw = p.pw;
  const int n_qt = (p.Sq + pw - 1) / pw;
  const int* kvp = p.kv_pos + static_cast<size_t>(b) * p.Skv;
  const int* qpp = p.q_pos + static_cast<size_t>(b) * p.Sq;

  if (threadIdx.x == 0) {
    k_lo = INT_MAX;
    k_hi = INT_MIN;
    k_all = 1;
    for (int s = 0; s < kDkdvStages; ++s) {
      mbar_init(full + 8 * s, 32);               // each producer lane
      mbar_init(empty + 8 * s, 4);               // the consuming warpgroup
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // zero the stages (a tile's rows past pw * G are never loaded), then
  // order these generic stores before the TMA writes and wgmma reads
  for (int c = threadIdx.x; c < kDkdvStages * C::kStage / 16; c += kWgThreads)
    reinterpret_cast<uint4*>(base_ptr + C::kRing)[c] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x < 64) {
    const int key = j0 + threadIdx.x;
    const int kp = key < p.Skv ? kvp[key] : -1;
    if (kp >= 0) {
      atomicMin(&k_lo, kp);
      atomicMax(&k_hi, kp);
    } else {
      k_all = 0;
    }
  }
  __syncthreads();
  // A query tile is live if some pair of its positions and the block's
  // keys may be valid (a superset); it is partly masked unless every pair
  // is valid (its rows past Sq carry lse = +inf and need no mask).
  // Producer and consumers walk these marks alike.
  {
    const int lo = k_lo, hi = k_hi, all = k_all;
    for (int t = threadIdx.x; t < n_qt; t += kWgThreads) {
      int qmin = INT_MAX, qmax = INT_MIN;
      for (int i = t * pw; i < min(p.Sq, t * pw + pw); ++i) {
        qmin = min(qmin, qpp[i]);
        qmax = max(qmax, qpp[i]);
      }
      const bool live = lo <= hi && (!p.causal || qmax >= lo) &&
                        (p.window <= 0 ||
                         static_cast<long long>(qmin) - hi < p.window);
      const bool whole = all && (!p.causal || qmin >= hi) &&
                         (p.window <= 0 ||
                          static_cast<long long>(qmax) - lo < p.window);
      marks[t] = live ? (whole ? 1 : 3) : 0;       // bit 0 live, 1 partly
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {                               // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp != 8) return;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * C::kTile);
      for (int c = 0; c < C::kHalves; ++c) {
        tma_load_4d(kt + c * kBoxBytes, &k_map, kvbar, 64 * c, kvh, j0, b);
        tma_load_4d(vt + c * kBoxBytes, &v_map, kvbar, 64 * c, kvh, j0, b);
      }
    }
    int n = 0;
    for (int t = 0; t < n_qt; ++t) {
      if (!(marks[t] & 1)) continue;
      const int stage = n % kDkdvStages;
      mbar_wait(empty + 8 * stage, ((n / kDkdvStages) & 1) ^ 1);
      const uint32_t qs = ring + stage * C::kStage, ds = qs + C::kTile;
      float* lse2 = reinterpret_cast<float*>(base_ptr + (ds + C::kTile - base));
      float* dd = lse2 + 64;
      int* qp = reinterpret_cast<int*>(dd + 64);
      for (int r = lane; r < 64; r += 32) {
        const int pos = t * pw + r / G, g = r % G;
        const bool ok = r < pw * G && pos < p.Sq;
        const size_t at = (static_cast<size_t>(b) * p.Sq + (ok ? pos : 0)) *
                              p.Hq + kvh * G + g;
        lse2[r] = ok ? p.lse[at] * kLog2e : INFINITY;
        dd[r] = ok ? p.dsum[at] : 0.f;
        qp[r] = ok ? qpp[pos] : 0;
      }
      const uint32_t bar = full + 8 * stage;
      if (lane == 0) {
        // past Sq TMA fills zeros (and counts their bytes)
        mbar_expect_tx(bar, 2 * C::kHalves * pw * G * 128);
        for (int c = 0; c < C::kHalves; ++c) {
          tma_load_4d(qs + c * kBoxBytes, &q_map, bar, 64 * c, kvh * G,
                      t * pw, b);
          tma_load_4d(ds + c * kBoxBytes, &do_map, bar, 64 * c, kvh * G,
                      t * pw, b);
        }
      } else {
        mbar_arrive(bar);
      }
      ++n;
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = warp / 4, wq = warp % 4;
  // key i of this thread is attended by the query positions in [qlo, qhi)
  int qlo[2], qhi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = j0 + 16 * wq + lane / 4 + 8 * i;
    const int kp = key < p.Skv ? kvp[key] : -1;
    const long long top = p.window > 0
                              ? static_cast<long long>(kp) + p.window
                              : static_cast<long long>(INT_MAX);
    qlo[i] = kp < 0 ? INT_MAX : p.causal ? kp : INT_MIN;
    qhi[i] = kp < 0 ? INT_MIN : static_cast<int>(top < INT_MAX ? top : INT_MAX);
  }
  const float scale2 = p.scale * kLog2e;
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kvbar, 0);

  int n = 0;
  for (int t = 0; t < n_qt; ++t) {
    const int mk = marks[t];
    if (!(mk & 1)) continue;
    if (n % 2 != wg) {
      ++n;
      continue;
    }
    const int stage = n % kDkdvStages;
    mbar_wait(full + 8 * stage, (n / kDkdvStages) & 1);
    const uint32_t qs = ring + stage * C::kStage, ds = qs + C::kTile;
    const float* lse2 =
        reinterpret_cast<const float*>(base_ptr + (ds + C::kTile - base));
    const float* dd = lse2 + 64;
    const int* qp = reinterpret_cast<const int*>(dd + 64);

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 packed rows each
    float s[32], dp[32];
    fence_acc<32>(s);
    fence_acc<32>(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(s, kmajor(kt, kk), kmajor(qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(dp, kmajor(vt, kk), kmajor(ds, kk), kk > 0);
    wgmma_commit_wait();
    fence_acc<32>(s);
    fence_acc<32>(dp);

    // P^T into s, dS^T into dp; the packed row of accumulator 4j + 2i + e
    // is 8j + 2(l%4) + e
    const bool part = mk & 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 L = *reinterpret_cast<const float2*>(lse2 + col);
      const float2 Dd = *reinterpret_cast<const float2*>(dd + col);
      int2 qq = make_int2(0, 0);
      if (part) qq = *reinterpret_cast<const int2*>(qp + col);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 4 * j + 2 * i;
        const bool ok0 = !part || (qq.x >= qlo[i] && qq.x < qhi[i]);
        const bool ok1 = !part || (qq.y >= qlo[i] && qq.y < qhi[i]);
        p_ds(p, scale2, s[x], dp[x], L.x, Dd.x, ok0, &s[x], &dp[x]);
        p_ds(p, scale2, s[x + 1], dp[x + 1], L.y, Dd.y, ok1, &s[x + 1],
             &dp[x + 1]);
      }
    }
    uint32_t pa[16], sa[16];
    to_fragments(s, pa);
    to_fragments(dp, sa);

    // dV += P^T dO, dK += dS^T Q: k16 step c is packed rows 16c .. 16c + 15
    fence_acc<DH / 2>(dv);
    fence_acc<DH / 2>(dk);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_rs<DH>(dv, pa + 4 * c, mnmajor(ds, c));
#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_rs<DH>(dk, sa + 4 * c, mnmajor(qs, c));
    wgmma_commit_wait();
    fence_acc<DH / 2>(dv);
    fence_acc<DH / 2>(dk);

    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    ++n;
  }

  // the second warpgroup's sums into the stages (every load has landed and
  // been read), then the first adds them to its own: a fixed order
  float* red = reinterpret_cast<float*>(base_ptr + C::kRing);
  const int tid = threadIdx.x % 128;
  asm volatile("bar.sync 1, 256;" ::: "memory");
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      red[i * 128 + tid] = dk[i];
      red[(DH / 2 + i) * 128 + tid] = dv[i];
    }
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");
  if (wg == 1) return;
  __nv_bfloat16* DK = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* DV = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = j0 + 16 * wq + lane / 4 + 8 * i;
    if (key >= p.Skv) continue;
    const size_t row =
        ((static_cast<size_t>(b) * p.Skv + key) * p.Hkv + kvh) * DH +
        2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int x = 4 * j + 2 * i;
      const float k0 = dk[x] + red[x * 128 + tid];
      const float k1 = dk[x + 1] + red[(x + 1) * 128 + tid];
      const float v0 = dv[x] + red[(DH / 2 + x) * 128 + tid];
      const float v1 = dv[x + 1] + red[(DH / 2 + x + 1) * 128 + tid];
      *reinterpret_cast<__nv_bfloat162*>(DK + row + 8 * j) =
          __floats2bfloat162_rn(k0 * p.scale, k1 * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(DV + row + 8 * j) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// One block: packed query tile (gridDim.x - 1 - blockIdx.x) of 2 pw
// positions (warpgroup w: positions q0 + w pw .. + pw - 1, as rows
// iq * G + g), kv head blockIdx.y, batch row blockIdx.z; the last
// warpgroup is the producer, of which one warp works.  Thread (warp wq,
// lane l) holds rows 16 wq + l/4 + 8i of its warpgroup and, of S, dP and
// dQ, the columns 8j + 2(l%4) + e: accumulator 4j + 2i + e.
template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma(__grid_constant__ const CUtensorMap q_map,
                       __grid_constant__ const CUtensorMap do_map,
                       __grid_constant__ const CUtensorMap k_map,
                       __grid_constant__ const CUtensorMap v_map,
                       const Params p) {
  using C = Dq<DH>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int q_lo, q_hi;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t ring = base + C::kRing;
  const uint32_t full = base + C::kBars;
  const uint32_t empty = full + 8 * kDqStages;
  const uint32_t qbar = empty + 8 * kDqStages;
  uint8_t* live_tile = base_ptr + C::kMarks;
  uint8_t* part_tile = live_tile + kMaxKTiles;

  const int h = blockIdx.y, b = blockIdx.z, G = p.G, pw = p.pw;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 2 * pw;
  const int nq = min(2 * pw, p.Sq - q0);
  const int n_tiles = (p.Skv + 63) / 64;
  const int* kvp = p.kv_pos + static_cast<size_t>(b) * p.Skv;
  const int* qpp = p.q_pos + static_cast<size_t>(b) * p.Sq;

  if (threadIdx.x == 0) {
    q_lo = INT_MAX;
    q_hi = INT_MIN;
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 8);               // each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int t = threadIdx.x; t < n_tiles; t += kWgThreads)
    live_tile[t] = part_tile[t] = 0;
  for (int c = threadIdx.x; c < C::kRing / 16; c += kWgThreads)
    reinterpret_cast<uint4*>(base_ptr)[c] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  for (int c = threadIdx.x; c < nq; c += kWgThreads) {
    atomicMin(&q_lo, qpp[q0 + c]);
    atomicMax(&q_hi, qpp[q0 + c]);
  }
  __syncthreads();
  // A key tile is live if it holds a key that some row of the block may
  // attend (exact without a window, a superset with one), partly masked
  // unless every row attends every one of its 64 keys.
  {
    const int lo = q_lo, hi = q_hi;
    for (int j = threadIdx.x; j < n_tiles * 64; j += kWgThreads) {
      const int kp = j < p.Skv ? kvp[j] : -1;
      if (kp >= 0 && (!p.causal || kp <= hi) &&
          (p.window <= 0 || static_cast<long long>(lo) - kp < p.window))
        live_tile[j / 64] = 1;
      if (!(kp >= 0 && (!p.causal || kp <= lo) &&
            (p.window <= 0 || static_cast<long long>(hi) - kp < p.window)))
        part_tile[j / 64] = 1;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp != 8) return;
    if (lane == 0) {
      uint32_t bytes = 0;
      for (int w = 0; w < 2; ++w)
        if (q0 + w * pw < p.Sq) bytes += 2 * C::kHalves * pw * G * 128;
      mbar_expect_tx(qbar, bytes);
      for (int w = 0; w < 2; ++w) {
        if (q0 + w * pw >= p.Sq) continue;
        const uint32_t qa = base + w * 2 * C::kTile, da = qa + C::kTile;
        for (int c = 0; c < C::kHalves; ++c) {
          tma_load_4d(qa + c * kBoxBytes, &q_map, qbar, 64 * c, h * G,
                      q0 + w * pw, b);
          tma_load_4d(da + c * kBoxBytes, &do_map, qbar, 64 * c, h * G,
                      q0 + w * pw, b);
        }
      }
    }
    int slot = 0;
    uint32_t parity = 0;
    for (int t = 0; t < n_tiles; ++t) {
      if (!live_tile[t]) continue;
      mbar_wait(empty + 8 * slot, parity ^ 1);
      const uint32_t kt = ring + slot * C::kStage, vt = kt + C::kTile;
      int* kp = reinterpret_cast<int*>(base_ptr + (vt + C::kTile - base));
      for (int j = lane; j < 64; j += 32) {
        const int key = t * 64 + j;
        kp[j] = key < p.Skv ? kvp[key] : -1;
      }
      const uint32_t bar = full + 8 * slot;
      if (lane == 0) {
        mbar_expect_tx(bar, 2 * C::kTile);
        for (int c = 0; c < C::kHalves; ++c) {
          tma_load_4d(kt + c * kBoxBytes, &k_map, bar, 64 * c, h, t * 64, b);
          tma_load_4d(vt + c * kBoxBytes, &v_map, bar, 64 * c, h, t * 64, b);
        }
      } else {
        mbar_arrive(bar);
      }
      if (++slot == kDqStages) {
        slot = 0;
        parity ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = warp / 4, wq = warp % 4;
  const bool live = q0 + wg * pw < p.Sq;         // the producer's test
  // row i attends exactly the kv positions in (lo[i], hi[i]]; its lse
  // (log2 domain) and D; nothing for a row that is not stored
  int lo[2], hi[2];
  float lse2[2], D[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * wq + lane / 4 + 8 * i;
    const int pos = q0 + wg * pw + row / G, g = row % G;
    row_ok[i] = live && row < pw * G && pos < p.Sq;
    const int qp = row_ok[i] ? qpp[pos] : 0;
    const long long wlo = p.window > 0
                              ? static_cast<long long>(qp) - p.window
                              : -1ll;
    lo[i] = row_ok[i] ? static_cast<int>(wlo > -1 ? wlo : -1) : 0;
    hi[i] = !row_ok[i] ? -1 : p.causal ? qp : INT_MAX;
    const size_t at =
        (static_cast<size_t>(b) * p.Sq + (row_ok[i] ? pos : 0)) * p.Hq +
        h * G + g;
    lse2[i] = row_ok[i] ? p.lse[at] * kLog2e : INFINITY;
    D[i] = row_ok[i] ? p.dsum[at] : 0.f;
  }
  const float scale2 = p.scale * kLog2e;
  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
  const uint32_t qa = base + wg * 2 * C::kTile, da = qa + C::kTile;
  if (live) mbar_wait(qbar, 0);

  int slot = 0;
  uint32_t parity = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (!live_tile[t]) continue;
    mbar_wait(full + 8 * slot, parity);
    if (live) {
      const uint32_t kt = ring + slot * C::kStage, vt = kt + C::kTile;
      const int* kps =
          reinterpret_cast<const int*>(base_ptr + (vt + C::kTile - base));
      // S = Q K^T and dP = dO V^T, 64 rows x 64 keys each
      float s[32], dp[32];
      fence_acc<32>(s);
      fence_acc<32>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_n64(s, kmajor(qa, kk), kmajor(kt, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_n64(dp, kmajor(da, kk), kmajor(vt, kk), kk > 0);
      wgmma_commit_wait();
      fence_acc<32>(s);
      fence_acc<32>(dp);

      const bool part = part_tile[t];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int2 kk = make_int2(0, 0);
        if (part)
          kk = *reinterpret_cast<const int2*>(kps + 8 * j + 2 * (lane % 4));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i;
          const bool ok0 = !part || (kk.x > lo[i] && kk.x <= hi[i]);
          const bool ok1 = !part || (kk.y > lo[i] && kk.y <= hi[i]);
          float pr;
          p_ds(p, scale2, s[x], dp[x], lse2[i], D[i], ok0, &pr, &dp[x]);
          p_ds(p, scale2, s[x + 1], dp[x + 1], lse2[i], D[i], ok1, &pr,
               &dp[x + 1]);
        }
      }
      uint32_t sa[16];
      to_fragments(dp, sa);

      // dQ += dS K: k16 step c is keys 16c .. 16c + 15
      fence_acc<DH / 2>(dq);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_rs<DH>(dq, sa + 4 * c, mnmajor(kt, c));
      wgmma_commit_wait();
      fence_acc<DH / 2>(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    if (++slot == kDqStages) {
      slot = 0;
      parity ^= 1;
    }
  }
  if (!live) return;

  __nv_bfloat16* DQ = static_cast<__nv_bfloat16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const int row = 16 * wq + lane / 4 + 8 * i;
    const int pos = q0 + wg * pw + row / G, g = row % G;
    __nv_bfloat16* dst =
        DQ + ((static_cast<size_t>(b) * p.Sq + pos) * p.Hq +
              static_cast<size_t>(h) * G + g) * DH + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          dq[4 * j + 2 * i] * p.scale, dq[4 * j + 2 * i + 1] * p.scale);
  }
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

// A bfloat16 tensor map over a contiguous (B, S, H, DH) tensor, axes
// innermost first (DH, H, S, B), with (64, box_h, box_s, 1) boxes,
// 128-byte swizzle and zero fill out of bounds.
int encode(CUtensorMap* map, const void* ptr, int B, int S, int H, int dh,
           int box_h, int box_s) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(dh) * 2;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_h),
                             static_cast<cuuint32_t>(box_s), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

// ---------------------------------------------------------------------------
// set-up and launches
// ---------------------------------------------------------------------------

template <typename T, int DH>
cudaError_t init_simt() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkdv_smem<DH>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem<DH>());
  return err;
}

template <int DH>
cudaError_t init_wgmma() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Dkdv<DH>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Dq<DH>::kSmem);
  return err;
}

template <typename T>
cudaError_t init_dtype() {
  cudaError_t err = init_simt<T, 32>();
  if (err == cudaSuccess) err = init_simt<T, 64>();
  if (err == cudaSuccess) err = init_simt<T, 128>();
  return err;
}

template <typename T, int DH>
cudaError_t launch_dot(const void* o, const void* dout, float* dsum,
                       long long rows, cudaStream_t s) {
  constexpr int L = DH / (16 / static_cast<int>(sizeof(T)));
  const long long threads = rows * L;
  flash_bwd_dot<T, DH><<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                         s>>>(static_cast<const T*>(o),
                              static_cast<const T*>(dout), dsum, rows);
  return cudaGetLastError();
}

// D, then the dk/dv and dq passes, in order on one stream; each launch
// checked.
template <typename T, int DH>
cudaError_t launch_simt(const Params& p, const void* o, float* dsum,
                        cudaStream_t s) {
  cudaError_t err = launch_dot<T, DH>(
      o, p.dout, dsum, static_cast<long long>(p.B) * p.Sq * p.Hq, s);
  if (err != cudaSuccess) return err;
  const dim3 qgrid((p.Sq + kBQ - 1) / kBQ, p.Hq, p.B);
  const dim3 kgrid((p.Skv + kBK - 1) / kBK, p.Hkv, p.B);
  flash_bwd_dkdv<T, DH><<<kgrid, kThreads, dkdv_smem<DH>(), s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, DH><<<qgrid, kThreads, dq_smem<DH>(), s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt_dtype(int dh, const Params& p, const void* o,
                              float* dsum, cudaStream_t s) {
  switch (dh) {
    case 32: return launch_simt<T, 32>(p, o, dsum, s);
    case 64: return launch_simt<T, 64>(p, o, dsum, s);
    case 128: return launch_simt<T, 128>(p, o, dsum, s);
    default: return cudaErrorInvalidValue;
  }
}

// Encodes the four tensor maps, then launches D, dk/dv and dq.
template <int DH>
int launch_wgmma(const Params& p, const void* o, float* dsum,
                 cudaStream_t s) {
  CUtensorMap qm, dm, km, vm;
  int res = encode(&qm, p.q, p.B, p.Sq, p.Hq, DH, p.G, p.pw);
  if (res == 0) res = encode(&dm, p.dout, p.B, p.Sq, p.Hq, DH, p.G, p.pw);
  if (res == 0) res = encode(&km, p.k, p.B, p.Skv, p.Hkv, DH, 1, 64);
  if (res == 0) res = encode(&vm, p.v, p.B, p.Skv, p.Hkv, DH, 1, 64);
  if (res != 0) return res;
  cudaError_t err = launch_dot<__nv_bfloat16, DH>(
      o, p.dout, dsum, static_cast<long long>(p.B) * p.Sq * p.Hq, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_wgmma<DH>
      <<<dim3((p.Skv + 63) / 64, p.Hkv, p.B), kWgThreads, Dkdv<DH>::kSmem,
         s>>>(qm, dm, km, vm, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma<DH>
      <<<dim3((p.Sq + 2 * p.pw - 1) / (2 * p.pw), p.Hkv, p.B), kWgThreads,
         Dq<DH>::kSmem, s>>>(qm, dm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
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

constexpr int max_smem() {
  int m = dkdv_smem<128>();
  m = m > dq_smem<128>() ? m : dq_smem<128>();
  m = m > Dkdv<128>::kSmem ? m : Dkdv<128>::kSmem;
  m = m > Dq<128>::kSmem ? m : Dq<128>::kSmem;
  return m;
}

}  // namespace

extern "C" {

// Once per device, before its first launch: lets each kernel use the
// shared memory it needs (the tensor-core dk/dv block's at Dh 128 is the
// most), and returns the device's opt-in limit in bytes (or minus a
// cudaError_t).
int flash_attention_bwd_init(int device) {
  int bytes = 0;
  DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess && bytes < max_smem())
    err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) err = init_dtype<float>();
  if (err == cudaSuccess) err = init_dtype<__nv_bfloat16>();
  if (err == cudaSuccess) err = init_wgmma<64>();
  if (err == cudaSuccess) err = init_wgmma<128>();
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// instance: 0 = simt, 1 = wgmma (bfloat16, dh 64 or 128, 16-byte aligned
// q, k, v, dout).  dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq,
// dk, dv all of it); lse: the forward's (B, Sq, Hq) float32 log-sum-exp;
// dsum: a workspace of B * Sq * Hq floats.  window <= 0 and softcap <= 0
// mean none.  Returns 0, a cudaError_t, or kEncodeError + the CUresult of
// a refused tensor map.
int flash_attention_bwd_launch(int device, int instance, int dtype, int dh,
                               const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, const void* q_pos,
                               const void* kv_pos, void* dq, void* dk,
                               void* dv, void* dsum, int B, int Sq, int Skv,
                               int Hq, int Hkv, int causal, int window,
                               float scale, float softcap, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 32 || Sq <= 0 || Skv <= 0 ||
      B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.pw = 64 / p.G;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(dsum);
  if (instance == 1) {
    if (dtype != 1 || (dh != 64 && dh != 128) ||
        (Sq + p.pw - 1) / p.pw > kMaxQTiles ||
        (Skv + 63) / 64 > kMaxKTiles || !aligned16(q) || !aligned16(k) ||
        !aligned16(v) || !aligned16(dout))
      return static_cast<int>(cudaErrorInvalidValue);
    return dh == 128 ? launch_wgmma<128>(p, o, ws, s)
                     : launch_wgmma<64>(p, o, ws, s);
  }
  if (instance != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dtype == 0
                        ? launch_simt_dtype<float>(dh, p, o, ws, s)
                        : launch_simt_dtype<__nv_bfloat16>(dh, p, o, ws, s);
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
