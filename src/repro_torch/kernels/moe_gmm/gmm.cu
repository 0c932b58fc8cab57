// Hopper grouped matmul: the expert products of a mixture-of-experts layer.
//
// Replaces the Pallas TPU kernel `gmm_pallas` / `_gmm_kernel`
// (src/repro/kernels/moe_gmm/kernel.py:76) of the JAX package; the plain
// PyTorch version it is held against is `ops.py::gmm_plain`, and both are
// held against the oracle `ref.py::gmm_reference`.
//
// What it computes: the rows of lhs (T, K) are sorted by expert, group e
// owning rows [offsets[e-1], offsets[e]) with offsets = cumsum(group_sizes);
// out[t] = lhs[t] @ rhs[e(t)] for rhs (E, K, N), accumulated in float32
// (FP32 FMAs, no TF32), and rows past sum(group_sizes) are zero.  Inputs are
// float32 or bfloat16 (widened on load); the output is float32 or the
// input dtype (rounded on store).  Group sizes may be any non-negative
// integers, zero and ragged ones included; a group that would reach past
// row T is cut there.
//
// What bounds it on this card, at jamba-v0.1-52b's shapes (16 experts,
// d_model 4096, d_ff 14336): at decode each group has C = 2 rows, so a call
// streams all 16 experts' weights (1.88 GB in bfloat16) for ~1 GFLOP: bytes,
// ~0.56 ms at HBM bandwidth.  At a 1024-token prefill a group has C = 160
// rows and a gate or up call is 300 GFLOP against ~2 GB: operations, ~0.3 ms
// at the tensor-core bf16 rate.  This first version is a tiled SIMT kernel
// with FP32 FMAs fed from shared memory: right first, fast in a later change
// (mma/wgmma tensor cores, TMA, a persistent schedule).  What its design
// does:
//
//   * the Pallas kernel's grid walks BT-aligned row tiles whose expert id is
//     prefetched as a scalar.  Here groups need not be aligned: the row
//     tiles are the (expert, tile-within-group) pairs, MegaBlocks style, so
//     a tile never spans two experts and a group's ragged last tile is
//     masked (rows past the group's end load as zero and are never
//     stored): padding costs at most one partial tile per group and never
//     a tile of zeros.  Each block finds its own pair from the E group
//     sizes on the device (an O(E) walk by one thread), so the host never
//     reads group_sizes and never synchronises; the grid is sized to the
//     bound ceil(T/BM) + E + 1 and the blocks past the last real tile
//     write the zero tail rows or exit;
//   * each block computes a BM x 128 output tile over the whole K loop in
//     registers, so nothing is accumulated across blocks: no atomics, and
//     the sum's order is fixed (greedy decoding stays deterministic);
//   * each expert's (32 x 128) weight tile is read from device memory once
//     per row tile, in 16-byte loads along N, widened to float32 into
//     shared memory, and used by every row of the tile there; blocks of
//     one weight tile's row tiles are adjacent in the grid, so a group of
//     several row tiles finds it in L2;
//   * two instantiations of one template: BM = 64 rows (4 x 8 outputs per
//     thread, for prefill-sized groups) and BM = 8 rows (1 x 4, for the
//     decode's groups of a few rows, where a 64-row tile would multiply 62
//     rows of nothing).  The wrapper picks by the mean group size T / E,
//     a shape, so the choice needs no group size from the device;
//   * each thread's 4 or 8 columns are groups of 4 adjacent ones (the two
//     groups of 8 are BN/2 apart), so its float4 reads of a shared row are
//     conflict-free.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;         // output columns per block
constexpr int kBK = 32;          // depth of a shared tile

struct Params {
  const void* lhs;     // (T, K) contiguous
  const void* rhs;     // (E, K, N) contiguous
  const int* gs;       // (E,) int32 group sizes
  void* out;           // (T, N) contiguous
  int T, K, N, E;
  bool vec_lhs, vec_rhs, vec_out;   // 16-byte loads / 4-wide stores allowed
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void narrow(float v, float* p) { *p = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// 16 aligned bytes at p, widened to float.
__device__ __forceinline__ void load16(const float* p, float* d) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* d) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

// Elements col .. col + V - 1 of a row (V = 16 bytes' worth), zero past
// `limit`.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int col, int limit,
                                           bool vec, float* d) {
  constexpr int V = 16 / sizeof(T);
  if (vec && col + V <= limit) {
    load16(row + col, d);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      d[i] = col + i < limit ? widen(row[col + i]) : 0.f;
  }
}

// Four adjacent outputs of a row, those at or past `limit` left out.
template <typename TO>
__device__ __forceinline__ void store4(TO* row, int col, int limit, bool vec,
                                       const float* v) {
  if (vec && col + 4 <= limit) {
    if constexpr (sizeof(TO) == 4) {
      *reinterpret_cast<float4*>(row + col) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                             __floats2bfloat162_rn(v[2], v[3])};
      *reinterpret_cast<uint2*>(row + col) = *reinterpret_cast<uint2*>(h);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < limit) narrow(v[i], row + col + i);
  }
}

// One block: rows [r0, r1) of one expert (or of the zero tail) times the
// 128 columns from blockIdx.y * 128.  BM rows per tile, each thread TM rows
// by TN columns.
template <typename T, typename TO, int BM, int TM, int TN>
__global__ void __launch_bounds__(kThreads) gmm_kernel(Params p) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kColThreads = kBN / TN;
  constexpr int kGroups = TN / 4;              // groups of 4 columns
  constexpr int kGroupStride = kBN / kGroups;
  static_assert((BM / TM) * kColThreads == kThreads, "thread layout");
  static_assert(TN % 4 == 0 && kBK % V == 0, "tile shapes");

  __shared__ __align__(16) float As[kBK][BM];   // lhs tile, transposed
  __shared__ __align__(16) float Bs[kBK][kBN];  // weight tile
  __shared__ int tile[3];                       // expert, r0, r1

  if (threadIdx.x == 0) {
    // the blockIdx.x-th (expert, row tile) pair; -1: a tile of the zero
    // tail; -2: past the end
    int t = blockIdx.x, start = 0, expert = -2, r0 = 0, r1 = 0;
    for (int e = 0; e < p.E; ++e) {
      const int g = min(max(p.gs[e], 0), p.T - start);
      const int nt = (g + BM - 1) / BM;
      if (t < nt) {
        expert = e;
        r0 = start + t * BM;
        r1 = min(start + g, r0 + BM);
        break;
      }
      t -= nt;
      start += g;
    }
    if (expert == -2) {
      r0 = start + t * BM;
      r1 = min(p.T, r0 + BM);
      if (r0 < p.T) expert = -1;
    }
    tile[0] = expert;
    tile[1] = r0;
    tile[2] = r1;
  }
  __syncthreads();
  const int expert = tile[0], r0 = tile[1], rows = tile[2] - tile[1];
  if (expert == -2) return;

  const int n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (expert >= 0) {
    const T* A = static_cast<const T*>(p.lhs) + static_cast<long long>(r0) * p.K;
    const T* W = static_cast<const T*>(p.rhs) +
                 static_cast<long long>(expert) * p.K * p.N;
    for (int k0 = 0; k0 < p.K; k0 += kBK) {
      for (int c = threadIdx.x; c < BM * kBK / V; c += kThreads) {
        const int m = c / (kBK / V), kk = (c % (kBK / V)) * V;
        float v[V];
        if (m < rows) {
          load_chunk(A + static_cast<long long>(m) * p.K, k0 + kk, p.K,
                     p.vec_lhs, v);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) As[kk + i][m] = v[i];
      }
      for (int c = threadIdx.x; c < kBK * kBN / V; c += kThreads) {
        const int kk = c / (kBN / V), n = (c % (kBN / V)) * V;
        float v[V];
        if (k0 + kk < p.K) {
          load_chunk(W + static_cast<long long>(k0 + kk) * p.N, n0 + n, p.N,
                     p.vec_rhs, v);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < V; i += 4)
          *reinterpret_cast<float4*>(&Bs[kk][n + i]) =
              make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 w =
              *reinterpret_cast<const float4*>(&Bs[kk][g * kGroupStride + tx * 4]);
          b[4 * g] = w.x;
          b[4 * g + 1] = w.y;
          b[4 * g + 2] = w.z;
          b[4 * g + 3] = w.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  TO* out = static_cast<TO*>(p.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = ty * TM + i;
    if (m >= rows) continue;
    TO* row = out + static_cast<long long>(r0 + m) * p.N;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      store4(row, n0 + g * kGroupStride + tx * 4, p.N, p.vec_out,
             &acc[i][4 * g]);
  }
}

template <typename T, typename TO>
cudaError_t launch_types(int bm, const Params& p, cudaStream_t s) {
  const unsigned tiles = static_cast<unsigned>((p.T + bm - 1) / bm + p.E + 1);
  const dim3 grid(tiles, (p.N + kBN - 1) / kBN);
  switch (bm) {
    case 64: gmm_kernel<T, TO, 64, 4, 8><<<grid, kThreads, 0, s>>>(p); break;
    case 8: gmm_kernel<T, TO, 8, 1, 4><<<grid, kThreads, 0, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (lhs and rhs); out_dtype: 0 = float32,
// 1 = bfloat16 (bfloat16 output needs bfloat16 inputs).  bm: rows per tile,
// 64 or 8.  group_sizes: E int32 on the device.  Returns a cudaError_t
// (0 = launched).
int gmm_launch(int device, int dtype, int out_dtype, int bm, const void* lhs,
               const void* rhs, const void* group_sizes, void* out, int T,
               int K, int N, int E, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (T <= 0 || K < 0 || N <= 0 || E <= 0 || (N + kBN - 1) / kBN > 65535 ||
      (dtype == 0 && out_dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int v = dtype == 0 ? 4 : 8;     // elements in 16 bytes
  Params p;
  p.lhs = lhs;
  p.rhs = rhs;
  p.gs = static_cast<const int*>(group_sizes);
  p.out = out;
  p.T = T;
  p.K = K;
  p.N = N;
  p.E = E;
  p.vec_lhs = K % v == 0 && aligned16(lhs);
  p.vec_rhs = N % v == 0 && aligned16(rhs);
  p.vec_out = N % 4 == 0 && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_types<float, float>(bm, p, s);
  else if (out_dtype == 0)
    err = launch_types<__nv_bfloat16, float>(bm, p, s);
  else
    err = launch_types<__nv_bfloat16, __nv_bfloat16>(bm, p, s);
  return static_cast<int>(err);
}

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
