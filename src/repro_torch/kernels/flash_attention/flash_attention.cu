// Hopper flash attention: position-masked GQA attention with an online
// softmax, for prefill and for decode against a KV cache.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` / `_attn_kernel`
// (src/repro/kernels/flash_attention/kernel.py:136) of the JAX package;
// the plain PyTorch version it is held against is
// `ref.py::attention_reference`.
//
// What it computes, for each (batch b, query position i, query head hq)
// with kv head h = hq / G (group-major GQA, G = Hq / Hkv):
//
//   valid(j) = kv_pos[b,j] >= 0 && (!causal || kv_pos[b,j] <= q_pos[b,i])
//              && (window <= 0 || q_pos[b,i] - kv_pos[b,j] < window)
//   s_j      = scale * q . k_j  (then softcap * tanh(s_j / softcap))
//   out      = sum_j softmax_valid(s)_j v_j     (0 for a fully masked row)
//
// with the Pallas kernel's online softmax in f32: running max m (floored
// at NEG_INF/2 so a fully masked row never gives NaN), running sum l
// (clamped at 1e-30 at the end), f32 accumulator, output in the input
// dtype.  Ragged Sq and Skv are masked here, not padded on the host.
// Every instance packs the query rows of one kv head as (position, head)
// pairs, position-major (row r = iq * G + g), as the Pallas kernel does
// (BQ * G rows), so each K/V row read feeds all G heads of its group.
// Given a non-null `lse`, every instance also writes each row's
// log-sum-exp, m + log l of its valid logits (natural log; +inf for a row
// that sees no key), as f32 (B, Sq, Hq): the training forward asks for it,
// so that the backward (`flash_attention_bwd.cu`) recomputes no
// statistics; serving passes null and nothing more is written.
//
// Three instances, chosen by `ops.route` from dtype, shape and alignment
// alone (one ctypes call, one launch count per call):
//
// flash_attention_kernel_split + flash_attention_kernel_merge ("split"):
//   every call with at most 32 query rows per kv head (Sq * G <= 32):
//   every decode tick, in either dtype and any head dim.  Bound by bytes:
//   each query row meets the whole cache once, about 2 FLOPs per byte of
//   bf16 K/V against the ~295 the H100 needs to be compute-bound, and at
//   the serving shapes (a few MB) by latency: the design keeps the chain
//   of dependent steps short and spreads the cache over the SMs:
//   * flash-decoding: the grid is (n_splits, Hkv, B) and each block takes
//     its group's rows against one contiguous range of cache slots;
//     n_splits comes from the host (`ops.split_plan`, shapes only) so that
//     some 2 x 132 blocks run (qwen2's 8 slots x 2 kv heads: 256 blocks,
//     not the 16 of one block per (b, h)), each split at least one tile;
//   * 8 warps of 4 rows: warp w takes row group w % n_groups and every
//     ksplit-th 32-key slice of the split; q, q_pos and the first key's
//     kv_pos are loaded at once, before the block's only barrier ahead of
//     the keys;
//   * K and V are read as stored, with 16-byte loads, never staged in
//     shared memory: lane j scores key j of the slice for the warp's rows
//     (q rows from shared memory as f32, broadcast), then lanes take the
//     slice's V rows DH/(16 bytes) lanes a row; a slice's K and V loads
//     are all issued before its arithmetic;
//   * FP32 FMAs: tensor cores buy nothing at 2 FLOPs a byte, and f32
//     keeps the 2e-5 gate for float32 inputs;
//   * a split that no row attends (the empty end of a decode cache) reads
//     no K or V and writes only m = -1e30, l = 0; a 32-key slice whose
//     slots are all masked is skipped before K or V is read, and within a
//     live slice the V rows of keys no row attends are not read;
//   * the warps of a row group merge their (m, l, acc) in shared memory,
//     and the block writes one part per row to a workspace the wrapper
//     allocates per call; the merge kernel, launched from the same C entry
//     point on the same stream, combines the parts in a fixed order (no
//     atomics: deterministic), skipping the acc of a part of weight 0.  A
//     fully masked row or split gives 0, never NaN.
//
// flash_attention_kernel_wgmma ("wgmma"): bf16 prefill with Dh 64 or 128
//   and more than 32 rows per kv head.  Bound by operations at prefill
//   2048 (4 Dh FLOPs per unmasked (query, key) pair and head, which only
//   the tensor cores deliver at 989 TFLOP/s), by bytes at short prefill.
//   An FA3-shaped kernel, simple first:
//   * one block per (query tile, kv head, batch row): W consumer
//     warpgroups of 64 (position, head) rows each (floor(64 / G) positions
//     a warpgroup: 10 positions and 4 idle rows at G = 6, so one K/V tile
//     in shared memory feeds all G heads rather than G blocks re-reading
//     it from L2), and a producer warpgroup of which one warp works; W = 2,
//     or 1 where two would leave some of the 132 SMs without a block
//     (qwen2's 512-token prefill: 104 blocks of one, not 52 of two);
//   * registers are the scarce resource (64 f32 of S, DH/2 of O and 32 of
//     P a thread): with two consumers the producer warpgroup drops to 40
//     registers and the consumers rise to 232 (setmaxnreg), where the
//     launch's 168 spilled;
//   * Q arrives once by TMA through a 4-D tensor map over (Dh, Hq, Sq, B):
//     a (64-column, G heads, positions) box is exactly the warpgroup's
//     packed rows, zero-filled past Sq (the idle rows are zeroed first);
//   * a ring of 2 stages of (K tile, V tile: 128 keys, 64-column TMA
//     boxes, 128-byte swizzle; the tile's kv positions, -1 past Skv)
//     with full and empty mbarriers, as in gmm.cu: the producer keeps the
//     next tile's loads in flight while the consumers compute;
//   * S = Q K^T by wgmma m64n128k16, Q (A) and K (B) from shared memory,
//     K K-major (no transpose bit); online softmax on the f32
//     accumulators in registers (row 16w + l/4 (+8), column 8j + 2(l%4))
//     in the log2 domain, row max over the 4 lanes of a row by shuffles;
//   * O += P V by wgmma m64nDHk16 with P as A from registers: the S
//     accumulators, rounded to bf16 pairs, are already in the A-fragment
//     layout (FA3's register reuse); V is the MN-major B operand with the
//     transpose bit, as gmm's weight tile;
//   * tile marks: before the loop the whole block marks, from kv_pos and
//     the min and max of its query positions, the KV tiles that some row
//     may attend (exact without a window, a superset with one) and those
//     that every row attends wholly; producer and consumers walk the same
//     marks, so the ring's phases cannot drift apart, causal prefill does
//     about half the work, as the Pallas kernel does with pl.when, and
//     only the partly masked tiles (the diagonal, empty slots) pay for the
//     per-element mask (each row's valid positions are an interval
//     (lo, hi], two compares);
//   * the epilogue stores O / l from registers, masked to real rows:
//     rows past Sq, or past a warpgroup's G * floor(64 / G), are computed
//     but never stored; the query tiles are launched last first, so the
//     causal tiles with the most keys start first.
//   P is rounded to bf16 before PV (the 2e-2 gate holds it).
//
// flash_attention_kernel ("simt", the first version, kept for the rest:
//   f32 prefill, where TF32 would miss 2e-5, and bf16 with Dh = 32): a
//   scalar FP32 FMA kernel, described below.
//
// The tensor maps and the workspace are made per call, by the C launcher
// and the wrapper; nothing is cached across calls but the driver's
// tensor-map encoder.  A CUDA-graph capture of the serving tick will have
// to keep the tensors at fixed addresses (the maps hold them as kernel
// arguments) and take the workspace from the graph's memory pool.
//
// The SIMT instance: one block per (query tile, kv head, batch row):
//
//   * the tile's BQ query positions times the G heads of the group (at
//     most 32 rows) share each K/V tile, staged in shared memory as f32,
//     so K/V is read from device memory once per block and query tile,
//     not once per head;
//   * a loop over KV tiles inside the block takes the place of the Pallas
//     grid's sequential kv axis;
//   * any G up to 32 (G = 6 for qwen2): rows are (position, head) pairs
//     numbered position-major, four rows to a warp;
//   * a KV tile whose mask is empty for every (row, key) pair of the block
//     is skipped before it is loaded (causal prefill then does about half
//     the work), and a warp skips a 32-key slice that is empty for its
//     rows;
//   * when the block has fewer than eight row groups, warps split each KV
//     tile's keys between them and merge their (m, l, acc) states at the
//     end, so all eight warps work.
//
// Lane j of a warp scores key j of its 32-key slice for the warp's four
// rows (q rows broadcast from shared memory, k row read as float4 from a
// padded, conflict-free stride); the probabilities then reach every lane
// by shuffle, and lane l accumulates dims l, l+32, ... of each row.
#include <cuda.h>           // CUtensorMap; its encoder is looked up
#include <cudaTypedefs.h>   // through the runtime, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kMaxSplit = 4;                      // warps per row group
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;        // (B, Sq, Hq, DH)
  const void* k;        // (B, Skv, Hkv, DH)
  const void* v;        // (B, Skv, Hkv, DH)
  const int* q_pos;     // (B, Sq)
  const int* kv_pos;    // (B, Skv)
  void* out;            // (B, Sq, Hq, DH)
  float* lse;           // (B, Sq, Hq) or null: the rows' log-sum-exp
  int Sq, Skv, Hq, Hkv, G;
  int bq;               // query positions per block
  int n_groups;         // row groups of kRowsPerWarp rows
  int ksplit;           // warps per row group; KV tile = 32 * ksplit keys
  int causal, window;   // window <= 0: none
  float scale, softcap; // softcap <= 0: none
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ bool attends(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// A row's natural-log log-sum-exp from its running max m and sum l (of
// exp(c - m)): m + log l, or +inf for a row that saw no key (l = 0), so
// that the backward's exp(c - lse) is 0 for every key.
__device__ __forceinline__ float log_sum_exp(float m, float l) {
  return l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);
}

// Copies `n` rows of DH elements, row r at src + r * src_stride, into
// shared memory as f32 with row stride `dst_stride`; rows >= n_valid are
// zero.  16-byte loads: DH is a multiple of 8, and the wrapper checks
// that every base pointer is 16-byte aligned.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride,
                                           const T* src, size_t src_stride,
                                           int n, int n_valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DH / kVec;
  for (int c = threadIdx.x; c < n * kPerRow; c += kThreads) {
    const int r = c / kPerRow, d = (c % kPerRow) * kVec;
    float* o = dst + r * dst_stride + d;
    if (r < n_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * src_stride + d);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = 0.f;
    }
  }
}

// Row stride of the K/V tiles in shared memory, in floats: the pad of 4
// keeps a warp's float4 reads of 32 different rows free of bank conflicts.
__host__ __device__ constexpr int kv_stride(int dh) { return dh + 4; }

template <int DH>
size_t smem_bytes(int ksplit) {
  const int bk = kWarp * ksplit;
  return sizeof(float) * (static_cast<size_t>(kMaxRows) * DH
                          + 2 * static_cast<size_t>(bk) * kv_stride(DH))
         + sizeof(int) * (bk + kMaxRows);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int KS = kv_stride(DH);
  constexpr int NI = DH / kWarp;                  // dims per lane
  constexpr int R = kRowsPerWarp;
  extern __shared__ float4 smem4[];
  const int bk = kWarp * p.ksplit;
  float* sQ = reinterpret_cast<float*>(smem4);    // kMaxRows x DH
  float* sK = sQ + kMaxRows * DH;                 // bk x KS
  float* sV = sK + bk * KS;                       // bk x KS
  int* sKpos = reinterpret_cast<int*>(sV + bk * KS);   // bk
  int* sQpos = sKpos + bk;                        // bq

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * p.bq;
  const int nq = min(p.bq, p.Sq - q0);            // query positions here
  const int rows = nq * p.G;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  // Query rows: row r = iq * G + g is head h*G + g at position q0 + iq;
  // the G heads of one position are contiguous in memory.
  for (int c = threadIdx.x; c < nq; c += kThreads)
    sQpos[c] = p.q_pos[static_cast<size_t>(b) * p.Sq + q0 + c];
  for (int iq = 0; iq < nq; ++iq)
    stage_rows<T, DH>(sQ + iq * p.G * DH, DH,
                      q + ((static_cast<size_t>(b) * p.Sq + q0 + iq) * p.Hq
                           + static_cast<size_t>(h) * p.G) * DH,
                      DH, p.G, p.G);

  const int group = warp % p.n_groups, split = warp / p.n_groups;
  const bool active = split < p.ksplit;
  const int r0 = group * R;
  float m[R], l[R], acc[R][NI];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }
  __syncthreads();
  int qp[R];
  bool row_ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row_ok[r] = active && r0 + r < rows;
    qp[r] = row_ok[r] ? sQpos[(r0 + r) / p.G] : 0;
  }

  const size_t kv_row = static_cast<size_t>(p.Hkv) * DH;
  const size_t kv_base = (static_cast<size_t>(b) * p.Skv * p.Hkv + h) * DH;
  for (int t0 = 0; t0 < p.Skv; t0 += bk) {
    __syncthreads();                              // last tile consumed
    for (int j = threadIdx.x; j < bk; j += kThreads)
      sKpos[j] = t0 + j < p.Skv
                     ? p.kv_pos[static_cast<size_t>(b) * p.Skv + t0 + j]
                     : -1;
    __syncthreads();
    int any = 0;
    for (int c = threadIdx.x; c < nq * bk; c += kThreads)
      any |= attends(sQpos[c / bk], sKpos[c % bk], p.causal, p.window);
    if (!__syncthreads_or(any)) continue;         // block-uniform skip
    const int n_valid = min(bk, p.Skv - t0);
    stage_rows<T, DH>(sK, KS, k + kv_base + t0 * kv_row, kv_row, bk, n_valid);
    stage_rows<T, DH>(sV, KS, v + kv_base + t0 * kv_row, kv_row, bk, n_valid);
    __syncthreads();
    if (!active) continue;

    const int kj = split * kWarp + lane;          // this lane's key
    const int kp = sKpos[kj];
    bool val[R];
    bool any_row = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      val[r] = row_ok[r] && attends(qp[r], kp, p.causal, p.window);
      any_row |= val[r];
    }
    if (!__any_sync(kFull, any_row)) continue;    // warp-uniform skip

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float* kr = sK + kj * KS;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(sQ + (r0 + r) * DH + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }
    float pr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = s[r] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      x = val[r] ? x : kNegInf;
      const float m_new =
          fmaxf(fmaxf(m[r], warp_max(x)), 0.5f * kNegInf);
      const float alpha = expf(m[r] - m_new);
      pr[r] = val[r] ? expf(x - m_new) : 0.f;
      l[r] = alpha * l[r] + warp_sum(pr[r]);
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
    }
    const float* vt = sV + split * kWarp * KS + lane;
#pragma unroll 4
    for (int j = 0; j < kWarp; ++j) {
      float vv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) vv[i] = vt[j * KS + i * kWarp];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(kFull, pr[r], j);
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

  if (p.ksplit > 1) {
    // Merge the splits' states through shared memory (the K/V tiles'
    // space): split 0 of each group rescales and sums the others'.
    constexpr int kState = R * (DH + 2);
    __syncthreads();
    float* mine = sK + warp * kState;
    if (active) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int i = 0; i < NI; ++i) mine[r * DH + lane + i * kWarp] = acc[r][i];
        if (lane == 0) {
          mine[R * DH + r] = m[r];
          mine[R * DH + R + r] = l[r];
        }
      }
    }
    __syncthreads();
    if (!active || split != 0) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mt = 0.5f * kNegInf;
      for (int s = 0; s < p.ksplit; ++s)
        mt = fmaxf(mt, sK[(warp + s * p.n_groups) * kState + R * DH + r]);
      float lt = 0.f, at[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) at[i] = 0.f;
      for (int s = 0; s < p.ksplit; ++s) {
        const float* st = sK + (warp + s * p.n_groups) * kState;
        const float w = expf(st[R * DH + r] - mt);
        lt += w * st[R * DH + R + r];
#pragma unroll
        for (int i = 0; i < NI; ++i) at[i] += w * st[r * DH + lane + i * kWarp];
      }
      m[r] = mt;
      l[r] = lt;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] = at[i];
    }
  } else if (!active) {
    return;
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!row_ok[r]) continue;
    const int row = r0 + r, iq = row / p.G, g = row % p.G;
    const size_t at = (static_cast<size_t>(b) * p.Sq + q0 + iq) * p.Hq
                      + static_cast<size_t>(h) * p.G + g;
    T* o = out + at * DH + lane;
    const float denom = fmaxf(l[r], 1e-30f);
    if (p.lse != nullptr && lane == 0) p.lse[at] = log_sum_exp(m[r], l[r]);
#pragma unroll
    for (int i = 0; i < NI; ++i) store(o + i * kWarp, acc[r][i] / denom);
  }
}

// ---------------------------------------------------------------------------
// flash_attention_kernel_split + flash_attention_kernel_merge: decode
// ---------------------------------------------------------------------------

constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = kSplitWarps * kWarp;
constexpr int kSplitRowsPerWarp = 4;
constexpr int kSplitMaxRows = kSplitWarps * kSplitRowsPerWarp;   // 32

struct SplitParams {
  const void* q;        // (B, Sq, Hq, DH)
  const void* k;        // (B, Skv, Hkv, DH)
  const void* v;        // (B, Skv, Hkv, DH)
  const int* q_pos;     // (B, Sq)
  const int* kv_pos;    // (B, Skv)
  void* out;            // (B, Sq, Hq, DH)
  float* lse;           // (B, Sq, Hq) or null: the rows' log-sum-exp
  float* ws_acc;        // (B, Hkv, n_splits, rows, DH): each part's acc
  float* ws_ml;         // (B, Hkv, n_splits, rows, 2): its m and l
  int Sq, Skv, Hq, Hkv, G;
  int rows;             // Sq * G query rows per kv head, at most 32
  int n_groups;         // row groups of kSplitRowsPerWarp rows
  int ksplit;           // warps per row group
  int n_splits, keys_per_split;   // one part per split
  int causal, window;
  float scale, softcap;
};

// The warps of a block for `rows` query rows: row groups of 4 rows, and as
// many warps per group as the block's eight allow.
void split_shape(int rows, int* n_groups, int* ksplit) {
  *n_groups = (rows + kSplitRowsPerWarp - 1) / kSplitRowsPerWarp;
  *ksplit = kSplitWarps / *n_groups;
}

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

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One block: split blockIdx.x of the cache slots, kv head blockIdx.y,
// batch row blockIdx.z.  Warp w takes row group w % n_groups (rows
// 4g .. 4g + 3) and every ksplit-th 32-key slice of the split from slice
// w / n_groups; the group's warps then merge their states in shared
// memory, in a fixed order, and the block writes one part per row.
template <typename T, int DH>
__global__ void __launch_bounds__(kSplitThreads)
flash_attention_kernel_split(const SplitParams p) {
  constexpr int E = 16 / sizeof(T);        // elements in a 16-byte load
  constexpr int NK = DH / E;               // 16-byte loads of a row
  constexpr int LPR = DH / E;              // lanes over one V row
  constexpr int KPI = kWarp / LPR;         // V rows a warp reads at once
  constexpr int NV = kWarp / KPI;          // V rows of a slice per lane
  // a slice's K row and V rows all in flight at once where they fit in
  // 128 registers (not float32 at Dh 128: its V rows load in the loop)
  constexpr bool kHoistV = NK + NV <= 32;
  constexpr int RW = kSplitRowsPerWarp;
  __shared__ __align__(16) float sQ[kSplitMaxRows * DH];
  __shared__ __align__(16) float sP[kSplitWarps][RW][kWarp];
  __shared__ __align__(16) float sAcc[kSplitWarps][RW][DH];
  __shared__ float sML[kSplitWarps][RW][2];
  __shared__ int sQpos[kSplitMaxRows];

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  // q as f32 in shared memory (row r = iq * G + g is head h*G + g at
  // position iq; the groups' rows past p.rows are zero), the query
  // positions, and the kv position of this lane's first key, all loaded
  // at once
  for (int c = threadIdx.x; c < p.n_groups * RW * NK; c += kSplitThreads) {
    const int r = c / NK, d = (c % NK) * E;
    float x[E];
    if (r < p.rows) {
      const int iq = r / p.G, g = r % p.G;
      unpack(load16(q + ((static_cast<size_t>(b) * p.Sq + iq) * p.Hq +
                         static_cast<size_t>(h) * p.G + g) * DH + d),
             x, T());
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(sQ + r * DH + d + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }
  for (int c = threadIdx.x; c < p.Sq; c += kSplitThreads)
    sQpos[c] = p.q_pos[static_cast<size_t>(b) * p.Sq + c];
  const int group = warp % p.n_groups, ks = warp / p.n_groups;
  const bool active = ks < p.ksplit;       // an idle warp has no keys
  const int begin = split * p.keys_per_split;
  const int end = active ? min(p.Skv, begin + p.keys_per_split) : begin;
  const int* kvp = p.kv_pos + static_cast<size_t>(b) * p.Skv;
  const int first = begin + ks * kWarp + lane;
  const int kp_first = first < end ? kvp[first] : -1;
  __syncthreads();

  const int r0 = group * RW;
  int qp[RW];
  bool row_ok[RW];
  float m[RW], l[RW], acc[RW][E];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    row_ok[r] = r0 + r < p.rows;
    qp[r] = row_ok[r] ? sQpos[(r0 + r) / p.G] : 0;
    m[r] = kNegInf;
    l[r] = 0.f;                            // this lane's share of l
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }
  const size_t kv_row = static_cast<size_t>(p.Hkv) * DH;
  const size_t kv_base = (static_cast<size_t>(b) * p.Skv * p.Hkv + h) * DH;
  const size_t part =
      (static_cast<size_t>(b) * p.Hkv + h) * p.n_splits + split;

  // a split that no row attends (the empty end of a decode cache) writes
  // m = -1e30 and l = 0 and no acc: the merge gives it weight 0 and never
  // reads its acc
  bool any_key = false;
  for (int t = first; t < end; t += kWarp * p.ksplit) {
    const int kp = t == first ? kp_first : kvp[t];
#pragma unroll
    for (int r = 0; r < RW; ++r)
      any_key |= row_ok[r] && attends(qp[r], kp, p.causal, p.window);
  }
  if (!__syncthreads_or(any_key)) {
    for (int r = threadIdx.x; r < p.rows; r += kSplitThreads)
      *reinterpret_cast<float2*>(p.ws_ml + 2 * (part * p.rows + r)) =
          make_float2(kNegInf, 0.f);
    return;
  }

  // lane j scores key j of a 32-key slice; lane (kq, c) = (lane / LPR,
  // lane % LPR) then adds dims c E .. c E + E - 1 of V rows kq, kq + KPI,
  // ... of the slice
  const int kq = lane / LPR, d0 = (lane % LPR) * E;
  for (int t0 = begin + ks * kWarp; t0 < end; t0 += kWarp * p.ksplit) {
    const int t = t0 + lane;                          // this lane's key
    const int kp = t < end ? kvp[t] : -1;
    bool val[RW];
    bool any = false;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      val[r] = row_ok[r] && attends(qp[r], kp, p.causal, p.window);
      any |= val[r];
    }
    const unsigned live = __ballot_sync(kFull, any);
    if (live == 0) continue;                          // warp-uniform skip

    // the loads first: this lane's K row, and (kHoistV) its V rows of the
    // slice; a key no row attends is not read
    uint4 kraw[NK];
    const T* kr = k + kv_base + static_cast<size_t>(t) * kv_row;
#pragma unroll
    for (int i = 0; i < NK; ++i)
      kraw[i] = any ? load16(kr + i * E) : make_uint4(0, 0, 0, 0);
    uint4 vraw[kHoistV ? NV : 1];
    if constexpr (kHoistV) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = kq + i * KPI;
        const T* vr = v + kv_base + static_cast<size_t>(t0 + j) * kv_row;
        vraw[i] = live >> j & 1u ? load16(vr + d0) : make_uint4(0, 0, 0, 0);
      }
    }

    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      float kk[E];
      unpack(kraw[i], kk, T());
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float* qr = sQ + (r0 + r) * DH + i * E;
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qr + e);
          s[r] = fmaf(qq.x, kk[e], s[r]);
          s[r] = fmaf(qq.y, kk[e + 1], s[r]);
          s[r] = fmaf(qq.z, kk[e + 2], s[r]);
          s[r] = fmaf(qq.w, kk[e + 3], s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float x = s[r] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      x = val[r] ? x : kNegInf;
      const float m_new = fmaxf(fmaxf(m[r], warp_max(x)), 0.5f * kNegInf);
      const float alpha = expf(m[r] - m_new);
      const float pr = val[r] ? expf(x - m_new) : 0.f;
      l[r] = alpha * l[r] + pr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
      m[r] = m_new;
      sP[warp][r][lane] = pr;
    }
    __syncwarp();
    // P V over V rows t0 + j, j = kq, kq + KPI, ...
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = kq + i * KPI;
      if (!(live >> j & 1u)) continue;
      float vv[E];
      if constexpr (kHoistV)
        unpack(vraw[i], vv, T());
      else
        unpack(load16(v + kv_base + static_cast<size_t>(t0 + j) * kv_row +
                      d0), vv, T());
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float pj = sP[warp][r][j];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
      }
    }
    __syncwarp();
  }

  // the warp's l, and the V row groups' sums in lanes 0 .. LPR-1, into
  // shared memory
  if (active) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      l[r] = warp_sum(l[r]);
#pragma unroll
      for (int o = LPR; o < kWarp; o <<= 1)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] += __shfl_xor_sync(kFull, acc[r][e], o);
      if (lane < LPR) {
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(&sAcc[warp][r][d0 + e]) = make_float4(
              acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
      }
      if (lane == 0) {
        sML[warp][r][0] = m[r];
        sML[warp][r][1] = l[r];
      }
    }
  }
  __syncthreads();
  if (!active || ks != 0) return;

  // warp `group` merges its group's ksplit states (warps group + s
  // n_groups) in order, and writes the block's part of each row
  for (int r = 0; r < RW && r0 + r < p.rows; ++r) {
    float mt = 0.5f * kNegInf;
    for (int s = 0; s < p.ksplit; ++s)
      mt = fmaxf(mt, sML[group + s * p.n_groups][r][0]);
    float w[kSplitWarps], lt = 0.f;
#pragma unroll
    for (int s = 0; s < kSplitWarps; ++s) {
      const int ws = group + s * p.n_groups;
      w[s] = s < p.ksplit ? expf(sML[ws][r][0] - mt) : 0.f;
      if (s < p.ksplit) lt += w[s] * sML[ws][r][1];
    }
    const size_t row = part * p.rows + r0 + r;
    for (int d = lane; d < DH; d += kWarp) {
      float at = 0.f;
#pragma unroll
      for (int s = 0; s < kSplitWarps; ++s)
        if (s < p.ksplit) at += w[s] * sAcc[group + s * p.n_groups][r][d];
      p.ws_acc[row * DH + d] = at;
    }
    if (lane == 0)
      *reinterpret_cast<float2*>(p.ws_ml + 2 * row) = make_float2(mt, lt);
  }
}

// Combines the n_splits parts of each query row in a fixed order: grid
// (rows, Hkv, B), thread d < DH for output element d.  The parts' weights
// exp(m_i - max m) go through shared memory 128 at a time.  A part of
// weight 0 adds nothing, so its acc is not read (an empty split wrote
// none).
template <typename T, int DH>
__global__ void __launch_bounds__(kSplitThreads)
flash_attention_kernel_merge(const SplitParams p) {
  __shared__ float sW[kSplitThreads], sL[kSplitThreads];
  __shared__ float sMax[kSplitWarps];
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const size_t first = ((static_cast<size_t>(b) * p.Hkv + h) * p.n_splits) *
                           p.rows + r;       // part i's row: first + i rows
  float mt = 0.5f * kNegInf;
  for (int i = threadIdx.x; i < p.n_splits; i += kSplitThreads)
    mt = fmaxf(mt, p.ws_ml[2 * (first + static_cast<size_t>(i) * p.rows)]);
  mt = warp_max(mt);
  if (lane == 0) sMax[warp] = mt;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kSplitWarps; ++w) mt = fmaxf(mt, sMax[w]);

  float lt = 0.f, at = 0.f;
  for (int i0 = 0; i0 < p.n_splits; i0 += kSplitThreads) {
    const int i = i0 + threadIdx.x;
    if (i < p.n_splits) {
      const float2 ml = *reinterpret_cast<const float2*>(
          p.ws_ml + 2 * (first + static_cast<size_t>(i) * p.rows));
      sW[threadIdx.x] = expf(ml.x - mt);
      sL[threadIdx.x] = ml.y;
    }
    __syncthreads();
    const int n = min(kSplitThreads, p.n_splits - i0);
    const float* src =
        p.ws_acc + (first + static_cast<size_t>(i0) * p.rows) * DH;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      lt += sW[j] * sL[j];
      // weight 0: a part with no valid key, whose acc was never written
      if (threadIdx.x < DH && sW[j] != 0.f)
        at += sW[j] * src[static_cast<size_t>(j) * p.rows * DH + threadIdx.x];
    }
    __syncthreads();
  }
  if (threadIdx.x >= DH) return;
  const int iq = r / p.G, g = r % p.G;
  const size_t row = (static_cast<size_t>(b) * p.Sq + iq) * p.Hq +
                     static_cast<size_t>(h) * p.G + g;
  if (p.lse != nullptr && threadIdx.x == 0) p.lse[row] = log_sum_exp(mt, lt);
  T* out = static_cast<T*>(p.out);
  store(out + row * DH + threadIdx.x, at / fmaxf(lt, 1e-30f));
}

template <typename T, int DH>
cudaError_t launch_split(const SplitParams& p, int B, cudaStream_t s) {
  flash_attention_kernel_split<T, DH>
      <<<dim3(p.n_splits, p.Hkv, B), kSplitThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_kernel_merge<T, DH>
      <<<dim3(p.rows, p.Hkv, B), kSplitThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_split_dtype(int dh, const SplitParams& p, int B,
                               cudaStream_t s) {
  switch (dh) {
    case 32: return launch_split<T, 32>(p, B, s);
    case 64: return launch_split<T, 64>(p, B, s);
    case 128: return launch_split<T, 128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// flash_attention_kernel_wgmma: bf16 prefill on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgBN = 128;               // keys per KV tile: S is 64 x 128
constexpr int kWgStages = 2;
constexpr int kSMs = 132;                // the H100's, for the block shape
constexpr int kWgMaxTiles = 2048;        // Skv up to 262,144
constexpr int kBoxBytes = 64 * 64 * 2;   // 64 rows of one 64-column box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct WgParams {
  const int* q_pos;     // (B, Sq)
  const int* kv_pos;    // (B, Skv)
  void* out;            // (B, Sq, Hq, DH) bfloat16
  float* lse;           // (B, Sq, Hq) or null: the rows' log-sum-exp
  int Sq, Skv, Hq, Hkv, G;
  int pw;               // positions per warpgroup: floor(64 / G)
  int causal, window;
  float scale, softcap;
};

// A block of W consumer warpgroups and one producer warpgroup, and its
// shared memory: the consumers' Q regions (64 rows of DH),
// the ring's stages (K tile, V tile, the tile's kv positions), the
// barriers and the tiles' marks (live; partly masked), from a 1024-aligned
// base.
template <int DH, int W>
struct Wg {
  static constexpr int kThreads = 128 * (W + 1);     // W consumers, producer
  static constexpr int kHalves = DH / 64;            // 64-column boxes
  static constexpr int kQBytes = kHalves * kBoxBytes;
  static constexpr int kHalfTile = kWgBN * 128;      // a box of 128 keys
  static constexpr int kTile = kHalves * kHalfTile;
  static constexpr int kStage = 2 * kTile + 1024;    // K, V, kv_pos
  static constexpr int kRing = W * kQBytes;
  static constexpr int kBars = kRing + kWgStages * kStage;
  static constexpr int kFlags = kBars + 8 * (2 * kWgStages + 1);
  static constexpr int kSmem = 1024 + kFlags + 2 * kWgMaxTiles;
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

// Pins N accumulators: the compiler may not move a read or write of them
// across this point (wgmma writes them asynchronously).
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16, K-major) *
// B (16 x 128, K-major), both from shared memory: Q K^T, with K
// stored [key][dh] (no transpose bit).
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, bf16 pairs in registers: the P
// fragment) * B (16 x 128, MN-major in shared memory, transpose bit):
// P V, with V stored [key][dh].
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

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers: the P
// fragment) * B (16 x 64, MN-major in shared memory, transpose bit):
// P V, with V stored [key][dh].
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One block: query tile (gridDim.x - 1 - blockIdx.x) of W * pw positions,
// kv head blockIdx.y, batch row blockIdx.z.  Threads 0 .. 128 W - 1 are
// the consumer warpgroups (warpgroup w: positions q0 + w pw .. + pw - 1,
// as rows iq * G + g), the last warpgroup the producer, of which one warp
// works.  With two consumers the producer gives up registers (setmaxnreg)
// so that each consumer thread may hold 232.
template <int DH, int W>
__global__ void __launch_bounds__(Wg<DH, W>::kThreads, 1)
    flash_attention_kernel_wgmma(__grid_constant__ const CUtensorMap q_map,
                                 __grid_constant__ const CUtensorMap k_map,
                                 __grid_constant__ const CUtensorMap v_map,
                                 const WgParams p) {
  using C = Wg<DH, W>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int q_lo, q_hi;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t ring = base + C::kRing;
  const uint32_t full = base + C::kBars;                // full[s]: +8s
  const uint32_t empty = full + 8 * kWgStages;          // empty[s]: +8s
  const uint32_t qbar = empty + 8 * kWgStages;
  uint8_t* live_tile = base_ptr + C::kFlags;
  uint8_t* part_tile = live_tile + kWgMaxTiles;

  const int h = blockIdx.y, b = blockIdx.z, G = p.G, pw = p.pw;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * W * pw;
  const int nq = min(W * pw, p.Sq - q0);
  const int n_tiles = (p.Skv + kWgBN - 1) / kWgBN;
  const int* kvp = p.kv_pos + static_cast<size_t>(b) * p.Skv;
  const int* qpp = p.q_pos + static_cast<size_t>(b) * p.Sq;

  if (threadIdx.x == 0) {
    q_lo = 0x7fffffff;
    q_hi = -0x7fffffff - 1;
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 32);               // each producer lane
      mbar_init(empty + 8 * s, 4 * W);        // each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int t = threadIdx.x; t < n_tiles; t += C::kThreads)
    live_tile[t] = part_tile[t] = 0;
  // zero Q's rows (those past pw * G are never loaded), then order these
  // generic stores before the TMA writes and wgmma reads (async proxy)
  for (int c = threadIdx.x; c < C::kRing / 16; c += C::kThreads)
    reinterpret_cast<uint4*>(base_ptr)[c] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  for (int c = threadIdx.x; c < nq; c += C::kThreads) {
    atomicMin(&q_lo, qpp[q0 + c]);
    atomicMax(&q_hi, qpp[q0 + c]);
  }
  __syncthreads();
  // A tile is live if it holds a key that some row of the block may
  // attend: exact without a window (the row at q_hi), a superset with one.
  // Producer and consumers walk these marks alike.  It is partly masked
  // unless every row attends every one of its kWgBN keys; only then do
  // the consumers skip the per-element mask.
  {
    const int lo = q_lo, hi = q_hi;
    for (int j = threadIdx.x; j < n_tiles * kWgBN; j += C::kThreads) {
      const int kp = j < p.Skv ? kvp[j] : -1;
      if (kp >= 0 && (!p.causal || kp <= hi) &&
          (p.window <= 0 || lo - kp < p.window))
        live_tile[j / kWgBN] = 1;
      if (!(kp >= 0 && (!p.causal || kp <= lo) &&
            (p.window <= 0 || hi - kp < p.window)))
        part_tile[j / kWgBN] = 1;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * W) {                           // the producer warpgroup
    if constexpr (W == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp != 4 * W) return;
    if (lane == 0) {
      // Q: each warpgroup with a position before Sq, as (64 columns,
      // G heads, pw positions) boxes; zero past Sq
      uint32_t bytes = 0;
      for (int w = 0; w < W; ++w)
        if (q0 + w * pw < p.Sq) bytes += C::kHalves * pw * G * 128;
      mbar_expect_tx(qbar, bytes);
      for (int w = 0; w < W; ++w) {
        if (q0 + w * pw >= p.Sq) continue;
        for (int c = 0; c < C::kHalves; ++c)
          tma_load_4d(base + w * C::kQBytes + c * kBoxBytes, &q_map, qbar,
                      64 * c, h * G, q0 + w * pw, b);
      }
    }
    int slot = 0;
    uint32_t parity = 0;
    for (int t = 0; t < n_tiles; ++t) {
      if (!live_tile[t]) continue;
      mbar_wait(empty + 8 * slot, parity ^ 1);
      const uint32_t kt = ring + slot * C::kStage, vt = kt + C::kTile;
      int* kp = reinterpret_cast<int*>(base_ptr + (vt + C::kTile - base));
      for (int j = lane; j < kWgBN; j += 32) {
        const int key = t * kWgBN + j;
        kp[j] = key < p.Skv ? kvp[key] : -1;
      }
      const uint32_t bar = full + 8 * slot;
      if (lane == 0) {
        // past Skv TMA fills zeros (and counts their bytes)
        mbar_expect_tx(bar, 2 * C::kTile);
        for (int c = 0; c < C::kHalves; ++c) {
          tma_load_4d(kt + c * C::kHalfTile, &k_map, bar, 64 * c, h,
                      t * kWgBN, b);
          tma_load_4d(vt + c * C::kHalfTile, &v_map, bar, 64 * c, h,
                      t * kWgBN, b);
        }
      } else {
        mbar_arrive(bar);
      }
      if (++slot == kWgStages) {
        slot = 0;
        parity ^= 1;
      }
    }
    return;
  }

  if constexpr (W == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  // the consumer warpgroups.  Thread (warp wq of warpgroup wg, lane l)
  // holds rows 16 wq + l/4 + 8i (i = 0, 1) of its warpgroup, and of S and
  // O the columns 8j + 2(l%4) + e: accumulator 4j + 2i + e.
  const int wg = warp / 4, wq = warp % 4;
  const bool live = q0 + wg * pw < p.Sq;         // the producer's test
  // row i attends exactly the kv positions in (lo[i], hi[i]]: kp >= 0,
  // kp <= q_pos if causal, q_pos - kp < window; nothing for a row that is
  // not stored
  int lo[2], hi[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * wq + lane / 4 + 8 * i;
    const int pos = q0 + wg * pw + row / G;
    row_ok[i] = live && row < pw * G && pos < p.Sq;
    const int qp = row_ok[i] ? qpp[pos] : 0;
    const long long wlo = p.window > 0
                              ? static_cast<long long>(qp) - p.window
                              : -1ll;
    lo[i] = row_ok[i] ? static_cast<int>(wlo > -1 ? wlo : -1) : 0;
    hi[i] = !row_ok[i] ? -1 : p.causal ? qp : 0x7fffffff;
  }
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = p.scale * kLog2e;
  const uint32_t qa = base + wg * C::kQBytes;
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
      // S = Q K^T: k16 step kk is 32 B into box kk / 4 of Q's and K's rows
      float s[64];
      fence_acc<64>(s);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_n128(s,
                      smem_desc(qa + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16,
                                1024),
                      smem_desc(kt + (kk / 4) * C::kHalfTile + (kk % 4) * 32,
                                16, 1024),
                      kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmma_wait<0>();
      fence_acc<64>(s);

      // scores in the log2 domain (softcap first), masked per element on
      // a tile that some row does not wholly attend
      if (p.softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          s[i] = p.softcap * tanhf(s[i] * p.scale / p.softcap) * kLog2e;
      }
      const float mul = p.softcap > 0.f ? 1.f : scale2;
      if (part_tile[t]) {
#pragma unroll
        for (int j = 0; j < kWgBN / 8; ++j) {
          const int2 kk = *reinterpret_cast<const int2*>(kps + 8 * j +
                                                         2 * (lane % 4));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float* x = s + 4 * j + 2 * i;
            x[0] = kk.x > lo[i] && kk.x <= hi[i] ? x[0] * mul : kNegInf;
            x[1] = kk.y > lo[i] && kk.y <= hi[i] ? x[1] * mul : kNegInf;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] *= mul;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mx[i] = fmaxf(mx[i], fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        mx[i] = fmaxf(mx[i], 0.5f * kNegInf);
        alpha[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
      // P in the A-fragment layout: k16 slice c is accumulators
      // 8c .. 8c + 7, as bf16 pairs (a masked score gives exp2 of about
      // -5e29, which is 0)
      uint32_t pa[kWgBN / 4];
#pragma unroll
      for (int c = 0; c < kWgBN / 16; ++c) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r % 2;
          const float p0 = exp2f(s[8 * c + 2 * r] - m[i]);
          const float p1 = exp2f(s[8 * c + 2 * r + 1] - m[i]);
          l[i] += p0 + p1;
          pa[4 * c + r] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // O += P V: k16 step c is 16 key rows (2 KB) into each box; the
      // boxes of V's two 64-column halves are kHalfTile apart
      fence_acc<DH / 2>(o);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int c = 0; c < kWgBN / 16; ++c) {
        const uint64_t dv = smem_desc(vt + c * 16 * 128, C::kHalfTile, 1024);
        if constexpr (DH == 128)
          wgmma_rs_n128(o, pa + 4 * c, dv);
        else
          wgmma_rs_n64(o, pa + 4 * c, dv);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmma_wait<0>();
      fence_acc<DH / 2>(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    if (++slot == kWgStages) {
      slot = 0;
      parity ^= 1;
    }
  }
  if (!live) return;

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(kFull, li, 1);
    li += __shfl_xor_sync(kFull, li, 2);
    if (!row_ok[i]) continue;
    const int row = 16 * wq + lane / 4 + 8 * i;
    const int pos = q0 + wg * pw + row / G, g = row % G;
    const size_t at = (static_cast<size_t>(b) * p.Sq + pos) * p.Hq +
                      static_cast<size_t>(h) * G + g;
    __nv_bfloat16* dst = out + at * DH + 2 * (lane % 4);
    const float denom = fmaxf(li, 1e-30f);
    // m is in the log2 domain with the scale folded in: back to the
    // natural log
    if (p.lse != nullptr && lane % 4 == 0)
      p.lse[at] = log_sum_exp(m[i] * kLn2, li);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * i] / denom, o[4 * j + 2 * i + 1] / denom);
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

template <int DH, int W>
int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km,
                 const CUtensorMap& vm, const WgParams& p, int B,
                 cudaStream_t s) {
  using C = Wg<DH, W>;
  auto kernel = flash_attention_kernel_wgmma<DH, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.Sq + W * p.pw - 1) / (W * p.pw);
  kernel<<<dim3(tiles, p.Hkv, B), C::kThreads, C::kSmem, s>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

// Encodes the three tensor maps and launches with two consumer warpgroups
// a block, or with one where two would leave some of the H100's 132 SMs
// without a block (a shape, so nothing is read from the device).
template <int DH>
int launch_wgmma_dh(const void* q, const void* k, const void* v,
                    const WgParams& p, int B, cudaStream_t s) {
  CUtensorMap qm, km, vm;
  int res = encode(&qm, q, B, p.Sq, p.Hq, DH, p.G, p.pw);
  if (res == 0) res = encode(&km, k, B, p.Skv, p.Hkv, DH, 1, kWgBN);
  if (res == 0) res = encode(&vm, v, B, p.Skv, p.Hkv, DH, 1, kWgBN);
  if (res != 0) return res;
  const long long blocks2 =
      static_cast<long long>((p.Sq + 2 * p.pw - 1) / (2 * p.pw)) * p.Hkv * B;
  return blocks2 < kSMs ? launch_wgmma<DH, 1>(qm, km, vm, p, B, s)
                        : launch_wgmma<DH, 2>(qm, km, vm, p, B, s);
}

template <typename T, int DH>
cudaError_t init_one(int max_smem) {
  return cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              max_smem);
}

template <typename T>
cudaError_t init_dtype(int max_smem) {
  cudaError_t err = init_one<T, 32>(max_smem);
  if (err == cudaSuccess) err = init_one<T, 64>(max_smem);
  if (err == cudaSuccess) err = init_one<T, 128>(max_smem);
  return err;
}

template <typename T, int DH>
cudaError_t launch_one(Params p, int B, cudaStream_t stream) {
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.Hkv, B);
  flash_attention_kernel<T, DH>
      <<<grid, kThreads, smem_bytes<DH>(p.ksplit), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int dh, const Params& p, int B, cudaStream_t s) {
  switch (dh) {
    case 32: return launch_one<T, 32>(p, B, s);
    case 64: return launch_one<T, 64>(p, B, s);
    case 128: return launch_one<T, 128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// Makes `device` current for one call, and the caller's device current
// again after it; costs one cudaGetDevice when they are the same.
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

// The SIMT block shape for G heads per kv head and Sq query positions: as
// many positions as fill 32 rows, and as many warps per row group as
// leave none of the eight idle (a power of two, at most kMaxSplit).
void block_shape(int G, int Sq, int* bq, int* n_groups, int* ksplit) {
  *bq = kMaxRows / G < Sq ? kMaxRows / G : Sq;
  *n_groups = (*bq * G + kRowsPerWarp - 1) / kRowsPerWarp;
  int s = 1;
  while (s < kMaxSplit && *n_groups * s * 2 <= kWarps) s *= 2;
  *ksplit = s;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory one SIMT launch of these shapes needs, in bytes.
int flash_attention_smem(int dh, int G, int Sq) {
  int bq, n_groups, ksplit;
  block_shape(G, Sq, &bq, &n_groups, &ksplit);
  switch (dh) {
    case 32: return static_cast<int>(smem_bytes<32>(ksplit));
    case 64: return static_cast<int>(smem_bytes<64>(ksplit));
    case 128: return static_cast<int>(smem_bytes<128>(ksplit));
    default: return -1;
  }
}

// Dynamic shared memory of one block of the wgmma instance with w
// consumer warpgroups (1 or 2), in bytes.
int flash_attention_wgmma_smem(int dh, int w) {
  if (w != 1 && w != 2) return -1;
  switch (dh) {
    case 64: return w == 1 ? Wg<64, 1>::kSmem : Wg<64, 2>::kSmem;
    case 128: return w == 1 ? Wg<128, 1>::kSmem : Wg<128, 2>::kSmem;
    default: return -1;
  }
}

// Once per device, before its first launch: lets every SIMT template use
// the largest dynamic shared memory a block may have there, and returns
// that size in bytes (or minus a cudaError_t).
int flash_attention_init(int device) {
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

// instance: 0 = simt, 1 = split (then n_splits, keys_per_split and the
// workspace `ws` of B * Hkv * n_splits * Sq * G * (dh + 2) floats),
// 2 = wgmma (bfloat16, dh 64 or 128).  dtype: 0 = float32, 1 = bfloat16.
// lse: null, or (B, Sq, Hq) floats that get each row's log-sum-exp (the
// backward's input; serving passes null and nothing more is written).
// window <= 0 and softcap <= 0 mean none.  Returns 0, a cudaError_t, or
// kEncodeError + the CUresult of a refused tensor map.
int flash_attention_launch(int device, int instance, int dtype, int dh,
                           const void* q, const void* k, const void* v,
                           const void* q_pos, const void* kv_pos, void* out,
                           void* ws, void* lse, int B, int Sq, int Skv,
                           int Hq, int Hkv,
                           int causal, int window, float scale, float softcap,
                           int n_splits, int keys_per_split, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxRows || Sq <= 0 ||
      Skv <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == 1) {
    SplitParams p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.q_pos = static_cast<const int*>(q_pos);
    p.kv_pos = static_cast<const int*>(kv_pos);
    p.out = out;
    p.lse = static_cast<float*>(lse);
    p.Sq = Sq;
    p.Skv = Skv;
    p.Hq = Hq;
    p.Hkv = Hkv;
    p.G = G;
    p.rows = Sq * G;
    if (p.rows > kSplitMaxRows) return static_cast<int>(cudaErrorInvalidValue);
    split_shape(p.rows, &p.n_groups, &p.ksplit);
    const int tile = kWarp * p.ksplit;
    if (keys_per_split <= 0 || keys_per_split % tile != 0 ||
        n_splits != (Skv + keys_per_split - 1) / keys_per_split)
      return static_cast<int>(cudaErrorInvalidValue);
    p.n_splits = n_splits;
    p.keys_per_split = keys_per_split;
    p.ws_acc = static_cast<float*>(ws);
    p.ws_ml =
        p.ws_acc + static_cast<size_t>(B) * Hkv * n_splits * p.rows * dh;
    p.causal = causal;
    p.window = window;
    p.scale = scale;
    p.softcap = softcap;
    cudaError_t err =
        dtype == 0 ? launch_split_dtype<float>(dh, p, B, s)
                   : launch_split_dtype<__nv_bfloat16>(dh, p, B, s);
    return static_cast<int>(err);
  }
  if (instance == 2) {
    if (dtype != 1 || (dh != 64 && dh != 128) ||
        (Skv + kWgBN - 1) / kWgBN > kWgMaxTiles || !aligned16(q) ||
        !aligned16(k) || !aligned16(v))
      return static_cast<int>(cudaErrorInvalidValue);
    WgParams p;
    p.q_pos = static_cast<const int*>(q_pos);
    p.kv_pos = static_cast<const int*>(kv_pos);
    p.out = out;
    p.lse = static_cast<float*>(lse);
    p.Sq = Sq;
    p.Skv = Skv;
    p.Hq = Hq;
    p.Hkv = Hkv;
    p.G = G;
    p.pw = 64 / G;
    p.causal = causal;
    p.window = window;
    p.scale = scale;
    p.softcap = softcap;
    return dh == 128 ? launch_wgmma_dh<128>(q, k, v, p, B, s)
                     : launch_wgmma_dh<64>(q, k, v, p, B, s);
  }
  if (instance != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = G;
  block_shape(p.G, Sq, &p.bq, &p.n_groups, &p.ksplit);
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaError_t err = dtype == 0 ? launch_dtype<float>(dh, p, B, s)
                               : launch_dtype<__nv_bfloat16>(dh, p, B, s);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
