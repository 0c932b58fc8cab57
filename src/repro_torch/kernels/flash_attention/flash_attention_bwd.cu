// Hopper flash-attention backward: the gradients dq, dk, dv of
// position-masked GQA attention, recomputed from q, k, v and the output.
//
// The JAX package has no Pallas backward: it differentiates the jnp path
// of `flash_attention` (src/repro/kernels/flash_attention/ops.py:74, the
// chunked attention of ops.py:44-71).  This is the kernel that the port's
// `FlashAttentionFn` launches for that gradient; the plain PyTorch
// version it is held against is `ref.py::attention_backward_reference`.
//
// What it computes, for each (batch b, query row i, query head hq) with
// kv head h = hq / G (group-major GQA) and key j, with the forward's mask
// and softmax (valid(i, j) from q_pos, kv_pos, causal and window):
//
//   s_ij  = scale * q_i . k_j,   c_ij = s_ij, or cap * tanh(s_ij / cap)
//   P_ij  = exp(c_ij - m_i) / l_i over the valid keys, 0 elsewhere
//   D_i   = sum_d dO_id * O_id
//   dS_ij = P_ij * (dO_i . v_j - D_i) * (1 - tanh^2(s_ij / cap) with a cap)
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_(i, hq in group h) dS_ij q_i
//   dv_j  = sum_(i, hq in group h) P_ij dO_i
//
// in f32 whatever the input dtype (f32 or bf16), each gradient rounded
// once to its input's dtype.  A fully masked row has l = 0 and no valid
// key, so P = dS = 0 there: dq is 0 and nothing reaches dk or dv.
//
// Bound: by operations.  The three passes do about 2.5x the forward's
// matmul work (QK^T twice, dO V^T twice, P^T dO, dS^T Q, dS K), all here
// as SIMT f32 FMAs from shared memory, against the 989 TFLOP/s that only
// the tensor cores deliver in bf16; this first kernel is simple and
// right, and the redesign onto wgmma (and the forward saving its
// log-sum-exp, which drops pass 1) is a later change.  The design:
//
//   1. flash_bwd_stats, one block per (64 query rows, query head, batch
//      row): streams the kv head's key tiles through shared memory and
//      recomputes each row's max m and normaliser l with an online softmax,
//      as the forward does, and D from O and dO; writes them to a
//      workspace of 3 * B * Hq * Sq floats.  The forward's three
//      instances stay as they are.
//   2. flash_bwd_dkdv, one block per (64 keys, kv head, batch row): holds
//      its K and V tiles and its dK and dV sums (a 4-key x Dh/16-column
//      patch a thread, in registers) and loops over the group's G heads
//      and the query tiles, recomputing P and dS per tile.  The sum over
//      the group's heads stays inside the block: no atomics, so two calls
//      give the same bits.
//   3. flash_bwd_dq, one block per (64 query rows, query head, batch row):
//      holds its Q and dO tiles and its dq sums and loops over the key
//      tiles.
//
// Every tile product is a 64 x 64 (or 64 x Dh) patch, 4 x 4 (or 4 x
// Dh/16) values a thread from f32 tiles in shared memory whose rows are
// padded to Dh + 1 floats (no bank conflicts down a column).  A (query
// tile, key tile) pair is skipped before its K/V or Q/dO tiles are read
// when no pair in it can be valid: no valid key, every key after every
// query (causal), or every key beyond the window; that is where the
// causal half of the work goes.  Ragged Sq and Skv are masked here.
// At Dh 128 the dk/dv block needs 163 KB of shared memory, the dq block
// 147 KB, the stats block 65 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kBQ = 64;          // query rows a tile
constexpr int kBK = 64;          // keys a tile
constexpr int kThreads = 256;    // 16 x 16: a 4 x 4 patch of a 64 x 64 tile
constexpr int kLDP = kBK + 1;    // row stride of the P and dS tiles
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const int* q_pos;
  const int* kv_pos;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // m, l, D: three arrays of B * Hq * Sq floats
  int B, Sq, Skv, Hq, Hkv, G;
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

template <int DH>
struct Tile {
  static constexpr int LD = DH + 1;        // padded row stride, floats
  static constexpr int kFloats = 64 * LD;  // one 64-row tile
  static constexpr int DC = DH / 16;       // columns a thread, stride 16
};

// Shared memory of each kernel, in bytes: the f32 tiles, the P/dS tiles,
// the rows' m, l and D, the two position vectors and the live flag.
template <int DH>
constexpr int stats_smem() {
  return (2 * Tile<DH>::kFloats + kBQ + kBK + 4) * 4;
}
template <int DH>
constexpr int dq_smem() {
  return (4 * Tile<DH>::kFloats + kBQ * kLDP + 3 * kBQ + kBQ + kBK + 4) * 4;
}
template <int DH>
constexpr int dkdv_smem() {
  return (4 * Tile<DH>::kFloats + 2 * kBQ * kLDP + 3 * kBQ + kBQ + kBK + 4) *
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

// The rows' m, l and D from pass 1 (rows past Sq: 0, 1, 0).
__device__ void load_row_stats(float* rm, float* rl, float* rD,
                               const Params& p, int b, int h, int i0) {
  const size_t n = static_cast<size_t>(p.B) * p.Hq * p.Sq;
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int i = i0 + r;
    if (i < p.Sq) {
      const size_t at = (static_cast<size_t>(b) * p.Hq + h) * p.Sq + i;
      rm[r] = p.stats[at];
      rl[r] = p.stats[n + at];
      rD[r] = p.stats[2 * n + at];
    } else {
      rm[r] = 0.f;
      rl[r] = 1.f;
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
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
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
    const int* qp, int n_rows, const int* kp, const float* rm,
    const float* rl, const float* rD, int ty, int tx, float (&P)[4][4],
    float (&dS)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    const float m = rm[i], l = fmaxf(rl[i], 1e-30f), D = rD[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float t;
      const float x = logit(p, qk[r][c], &t);
      const bool ok = i < n_rows && valid(p, qp[i], kp[tx + 16 * c]);
      const float pr = ok ? expf(x - m) / l : 0.f;
      float g = pr * (dp[r][c] - D);
      if (p.softcap > 0.f) g *= 1.f - t * t;
      P[r][c] = pr;
      dS[r][c] = g;
    }
  }
}

// Pass 1: each row's m and l over its valid keys, and D = dO . O.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_stats(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Tile<DH>::kFloats;
  int* qp = reinterpret_cast<int*>(Ks + Tile<DH>::kFloats);
  int* kp = qp + kBQ;
  int* flag = kp + kBK;
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G, n_rows = min(kBQ, p.Sq - i0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, DH>(Qs, static_cast<const T*>(p.q), b, i0, p.Sq, p.Hq, h);
  load_pos(qp, p.q_pos, b, i0, p.Sq, 0);
  float m_run[4], l_run[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }
  for (int j0 = 0; j0 < p.Skv; j0 += kBK) {
    __syncthreads();
    load_pos(kp, p.kv_pos, b, j0, p.Skv, -1);
    __syncthreads();
    if (!tiles_live(qp, n_rows, kp, p, flag)) continue;
    load_tile<T, DH>(Ks, static_cast<const T*>(p.k), b, j0, p.Skv, p.Hkv,
                     kvh);
    __syncthreads();
    float qk[4][4] = {};
    tile_dot<DH>(Qs, Ks, qk, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
      float x[4], tmax = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t;
        x[c] = logit(p, qk[r][c], &t);
        if (!(i < n_rows && valid(p, qp[i], kp[tx + 16 * c]))) x[c] = kNegInf;
        tmax = fmaxf(tmax, x[c]);
      }
      // the 16 lanes of a row are one half of the warp
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_run[r], tmax);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (x[c] > kNegInf) sum += expf(x[c] - m_new);
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[r] = l_run[r] * expf(m_run[r] - m_new) + sum;
      m_run[r] = m_new;
    }
  }

  const size_t n = static_cast<size_t>(p.B) * p.Hq * p.Sq;
  const T* O = static_cast<const T*>(p.o);
  const T* dO = static_cast<const T*>(p.dout);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    float dsum = 0.f;
    if (i < p.Sq) {
      const size_t row = ((static_cast<size_t>(b) * p.Sq + i) * p.Hq + h) * DH;
#pragma unroll
      for (int c = 0; c < Tile<DH>::DC; ++c)
        dsum += load_f(dO + row + tx + 16 * c) * load_f(O + row + tx + 16 * c);
    }
    for (int off = 8; off > 0; off >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (tx == 0 && i < p.Sq) {
      const size_t at = (static_cast<size_t>(b) * p.Hq + h) * p.Sq + i;
      p.stats[at] = fmaxf(m_run[r], kNegInf / 2);
      p.stats[n + at] = l_run[r];
      p.stats[2 * n + at] = dsum;
    }
  }
}

// Pass 2: dk and dv of 64 keys, summed over the group's heads and every
// query tile that can see them.
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
  float* rm = dSs + kBQ * kLDP;
  float* rl = rm + kBQ;
  float* rD = rl + kBQ;
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
      load_row_stats(rm, rl, rD, p, b, h, i0);
      load_tile<T, DH>(Qs, static_cast<const T*>(p.q), b, i0, p.Sq, p.Hq, h);
      load_tile<T, DH>(dOs, static_cast<const T*>(p.dout), b, i0, p.Sq, p.Hq,
                       h);
      __syncthreads();
      float qk[4][4] = {}, dp[4][4] = {}, P[4][4], dS[4][4];
      tile_dot<DH>(Qs, Ks, qk, ty, tx);
      tile_dot<DH>(dOs, Vs, dp, ty, tx);
      probs_and_grads(p, qk, dp, qp, n_rows, kp, rm, rl, rD, ty, tx, P, dS);
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

// Pass 3: dq of 64 query rows of one head, over every key tile they can
// see.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const Params p) {
  constexpr int LD = Tile<DH>::LD, DC = Tile<DH>::DC;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + Tile<DH>::kFloats;
  float* Ks = dOs + Tile<DH>::kFloats;
  float* Vs = Ks + Tile<DH>::kFloats;
  float* dSs = Vs + Tile<DH>::kFloats;
  float* rm = dSs + kBQ * kLDP;
  float* rl = rm + kBQ;
  float* rD = rl + kBQ;
  int* qp = reinterpret_cast<int*>(rD + kBQ);
  int* kp = qp + kBQ;
  int* flag = kp + kBK;
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G, n_rows = min(kBQ, p.Sq - i0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, DH>(Qs, static_cast<const T*>(p.q), b, i0, p.Sq, p.Hq, h);
  load_tile<T, DH>(dOs, static_cast<const T*>(p.dout), b, i0, p.Sq, p.Hq, h);
  load_pos(qp, p.q_pos, b, i0, p.Sq, 0);
  load_row_stats(rm, rl, rD, p, b, h, i0);
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
    probs_and_grads(p, qk, dp, qp, n_rows, kp, rm, rl, rD, ty, tx, P, dS);
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

template <typename T, int DH>
cudaError_t init_instance() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_stats<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      stats_smem<DH>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkdv_smem<DH>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem<DH>());
  return err;
}

template <typename T>
cudaError_t init_dtype() {
  cudaError_t err = init_instance<T, 32>();
  if (err == cudaSuccess) err = init_instance<T, 64>();
  if (err == cudaSuccess) err = init_instance<T, 128>();
  return err;
}

// The three passes in order on one stream; each launch checked.
template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t s) {
  const dim3 qgrid((p.Sq + kBQ - 1) / kBQ, p.Hq, p.B);
  const dim3 kgrid((p.Skv + kBK - 1) / kBK, p.Hkv, p.B);
  flash_bwd_stats<T, DH><<<qgrid, kThreads, stats_smem<DH>(), s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<T, DH><<<kgrid, kThreads, dkdv_smem<DH>(), s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, DH><<<qgrid, kThreads, dq_smem<DH>(), s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int dh, const Params& p, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32>(p, s);
    case 64: return launch<T, 64>(p, s);
    case 128: return launch<T, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
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

// Once per device, before its first launch: lets each kernel use the
// shared memory it needs (the dk/dv pass's at Dh 128 is the most), and
// returns the device's opt-in limit in bytes (or minus a cudaError_t).
int flash_attention_bwd_init(int device) {
  int bytes = 0;
  DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess && bytes < dkdv_smem<128>())
    err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) err = init_dtype<float>();
  if (err == cudaSuccess) err = init_dtype<__nv_bfloat16>();
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv all of
// it); stats: a workspace of 3 * B * Hq * Sq floats.  window <= 0 and
// softcap <= 0 mean none.  Returns 0 or a cudaError_t.
int flash_attention_bwd_launch(int device, int dtype, int dh, const void* q,
                               const void* k, const void* v, const void* o,
                               const void* dout, const void* q_pos,
                               const void* kv_pos, void* dq, void* dk,
                               void* dv, void* stats, int B, int Sq, int Skv,
                               int Hq, int Hkv, int causal, int window,
                               float scale, float softcap, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.stats = static_cast<float*>(stats);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_dtype<float>(dh, p, s)
                               : launch_dtype<__nv_bfloat16>(dh, p, s);
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
