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
//
// What bounds it on this card: at decode, the bytes of the KV cache (one
// query row per head against the whole cache: 2 FLOPs per byte of bf16
// K/V, far under the ~295 FLOP/byte the H100 needs to be compute-bound);
// at long prefill, the QK^T and PV FLOPs, which only the tensor cores can
// deliver at 989 TFLOP/s.  This first version is a scalar FP32 FMA kernel
// (true f32, no TF32, so f32 inputs hold the reference's 2e-5): right
// first, fast in a later change.  What its design does:
//
//   * one block per (query tile, kv head, batch row): the tile's BQ query
//     positions times the G heads of the group (at most 32 rows) share
//     each K/V tile, staged in shared memory as f32, so K/V is read from
//     device memory once per block and query tile, not once per head;
//   * a loop over KV tiles inside the block takes the place of the Pallas
//     grid's sequential kv axis;
//   * any G up to 32 (G = 6 for qwen2): rows are (position, head) pairs
//     numbered position-major, four rows to a warp;
//   * a KV tile whose mask is empty for every (row, key) pair of the block
//     is skipped before it is loaded (causal prefill then does about half
//     the work), and a warp skips a 32-key slice that is empty for its
//     rows;
//   * when the block has fewer than eight row groups (decode: Sq = 1,
//     six rows), warps split each KV tile's keys between them and merge
//     their (m, l, acc) states at the end, so all eight warps work.  The
//     grid is still B x Hkv blocks at decode (16 for 8 qwen2 slots on 132
//     SMs); splitting the cache across blocks is later work.
//
// Lane j of a warp scores key j of its 32-key slice for the warp's four
// rows (q rows broadcast from shared memory, k row read as float4 from a
// padded, conflict-free stride); the probabilities then reach every lane
// by shuffle, and lane l accumulates dims l, l+32, ... of each row.
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
    T* o = out + ((static_cast<size_t>(b) * p.Sq + q0 + iq) * p.Hq
                  + static_cast<size_t>(h) * p.G + g) * DH + lane;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NI; ++i) store(o + i * kWarp, acc[r][i] / denom);
  }
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

// The block shape for G heads per kv head and Sq query positions: as
// many positions as fill 32 rows, and as many warps per row group as
// leave none of the eight idle (a power of two, at most kMaxSplit).
void block_shape(int G, int Sq, int* bq, int* n_groups, int* ksplit) {
  *bq = kMaxRows / G < Sq ? kMaxRows / G : Sq;
  *n_groups = (*bq * G + kRowsPerWarp - 1) / kRowsPerWarp;
  int s = 1;
  while (s < kMaxSplit && *n_groups * s * 2 <= kWarps) s *= 2;
  *ksplit = s;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch of these shapes needs, in bytes.
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

// Once per device, before its first launch: lets every template use the
// largest dynamic shared memory a block may have there, and returns that
// size in bytes (or minus a cudaError_t).
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

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 and softcap <= 0 mean
// none.  Returns a cudaError_t (0 = launched).
int flash_attention_launch(int device, int dtype, int dh, const void* q,
                           const void* k, const void* v, const void* q_pos,
                           const void* kv_pos, void* out, int B, int Sq,
                           int Skv, int Hq, int Hkv, int causal, int window,
                           float scale, float softcap, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxRows || Sq <= 0 ||
      Skv <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.out = out;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  block_shape(p.G, Sq, &p.bq, &p.n_groups, &p.ksplit);
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_dtype<float>(dh, p, B, s)
                               : launch_dtype<__nv_bfloat16>(dh, p, B, s);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
