// Hopper grouped matmul: the expert products of a mixture-of-experts layer.
//
// Replaces the Pallas TPU kernel `gmm_pallas` / `_gmm_kernel`
// (src/repro/kernels/moe_gmm/kernel.py:76) of the JAX package; the plain
// PyTorch version it is held against is `ops.py::gmm_plain`, and both are
// held against the oracle `ref.py::gmm_reference`.
//
// What it computes: the rows of lhs (T, K) are sorted by expert, group e
// owning rows [offsets[e-1], offsets[e]) with offsets = cumsum(group_sizes);
// out[t] = lhs[t] @ rhs[e(t)] for rhs (E, K, N), accumulated in float32,
// and rows past sum(group_sizes) are zero.  Group sizes may be any
// non-negative integers, zero and ragged ones included; a group that would
// reach past row T is cut there.  The host never reads them.
//
// Two instances, chosen by `ops.route` from dtype, shape and alignment:
//
//   gmm_kernel_wgmma  bfloat16 inputs with K and N multiples of 8 and
//                     16-byte aligned tensors (every expert product of the
//                     MoE layer in bfloat16): tensor cores, TMA, wgmma;
//   gmm_kernel        everything else: float32 inputs (FP32 FMAs, no TF32,
//                     so the float32 results keep the reference's 1e-4),
//                     and bfloat16 shapes TMA cannot take (K = 100).
//
// Output float32, or the input dtype rounded to nearest on store.
//
// What bounds it on this card, at jamba-v0.1-52b's shapes (16 experts,
// d_model 4096, d_ff 14336): every call streams all 16 experts' weights,
// 1.88 GB in bfloat16, 0.56 ms at 3.35 TB/s.  A 1024-token prefill (C = 160
// rows a group) is 3.0e11 FLOP per gate or up call, 0.30 ms at 989 TFLOP/s;
// a decode tick (C = 2) far less.  So every serving call is bound by bytes,
// and one tensor-core design serves both regimes if each weight byte comes
// from device memory once per call and enough of them are in flight.
// gmm_kernel_wgmma:
//
//   * one block per (expert, BM-row tile within its group) x 128 columns,
//     over the whole K loop: MegaBlocks-style tiles that never span two
//     experts, found on the device by an O(E) walk of the group sizes
//     (find_tile), ceil(T/BM) + E + 1 row tiles; spare blocks zero the
//     tail rows or exit.  BM (8, 64, 128 or 192) is the wrapper's choice
//     from the mean group T / E, a shape, so that one block holds a whole
//     group and reads each weight tile once: W = ceil(BM/64) consumer
//     warpgroups of 64 rows share each weight stage (64-row tiles read a
//     160-row group's weights 3 times, and were slower on an H100 at a
//     1024-token prefill); BM = 8 loads 8 lhs rows a stage for the
//     decode's groups of 2 (the other 56 rows of the warpgroup are never
//     stored);
//   * a 1-D grid in bands of kTcBand row tiles, each band sweeping the
//     column tiles, so that a band's lhs rows are read again from L2 by
//     every column tile (row tiles fastest over the whole grid was slower
//     at a 1024-token prefill, whose lhs is 21-73 MB);
//   * a ring of 3-4 shared-memory stages, each the lhs tile (BM x 64) and
//     the weight tile (64 x 128, as two 64-column TMA boxes), loaded by TMA
//     with 128-byte swizzle, with a full and an empty mbarrier per stage.
//     One producer warp issues the loads; the consumer warpgroups wait on
//     the full barrier, issue 4 wgmma m64n128k16 per stage with f32
//     accumulators in registers, and release the stage one stage later
//     (wait_group 1), so the products of one stage overlap the loads of the
//     next ones.  Up to 64 rows two blocks an SM (99 KB each), 128 rows two
//     (99 KB, 3 stages), 192 rows one (165 KB): up to 160-190 KB of loads
//     in flight on each SM, against the ~25 KB that Little's law asks for
//     at the HBM rate;
//   * the weights stay bfloat16 and are never transposed or copied: the
//     (K, N) weight tile is N-contiguous, the MN-major B operand that wgmma
//     takes with its transpose bit;
//   * a tile's rows past its group's end are computed (TMA loads them, and
//     zero past T) but never stored, and a warpgroup with no row of the
//     tile issues no products; no atomics, a fixed K order: deterministic
//     results;
//   * the epilogue stores the accumulators straight from registers, masked
//     to the tile's rows and to N.
//
// gmm_kernel (the first version, kept for what TMA cannot take): a tiled
// SIMT kernel, each block a BM x 128 output tile over the whole K loop,
// lhs and weight tiles widened to float32 in shared memory; BM = 64 rows
// (4 x 8 outputs a thread) or 8 rows (1 x 4) for groups of a few rows,
// picked by the wrapper from the mean group size T / E.
#include <cuda.h>           // CUtensorMap; its encoder is looked up
#include <cudaTypedefs.h>   // through the runtime, so no -lcuda
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
  int row_tiles;                    // the tensor-core instance's grid
};

// The t-th (expert, row tile) pair of BM-row tiles: tile[0] the expert
// (-1: a tile of the zero tail; -2: past the end), tile[1] and tile[2] its
// rows [r0, r1).  One thread walks the E group sizes.
__device__ void find_tile(const Params& p, int bm, int t, int* tile) {
  int start = 0, expert = -2, r0 = 0, r1 = 0;
  for (int e = 0; e < p.E; ++e) {
    const int g = min(max(p.gs[e], 0), p.T - start);
    const int nt = (g + bm - 1) / bm;
    if (t < nt) {
      expert = e;
      r0 = start + t * bm;
      r1 = min(start + g, r0 + bm);
      break;
    }
    t -= nt;
    start += g;
  }
  if (expert == -2) {
    r0 = start + t * bm;
    r1 = min(p.T, r0 + bm);
    if (r0 < p.T) expert = -1;
  }
  tile[0] = expert;
  tile[1] = r0;
  tile[2] = r1;
}

// ---------------------------------------------------------------------------
// gmm_kernel: the SIMT instance
// ---------------------------------------------------------------------------

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

  if (threadIdx.x == 0) find_tile(p, BM, blockIdx.x, tile);
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

// ---------------------------------------------------------------------------
// gmm_kernel_wgmma: the tensor-core instance
// ---------------------------------------------------------------------------

constexpr int kTcBN = 128;                 // columns per block: wgmma's N
constexpr int kTcBK = 64;                  // depth of a stage: 128 B of bf16
constexpr int kTcHalf = 64;                // columns per weight TMA box
constexpr int kTcBHalfBytes = kTcBK * kTcHalf * 2;        // 8 KB
constexpr int kTcWarpgroupRows = 64;       // wgmma's M
// The launch order: bands of kTcBand row tiles, each band sweeping the
// column tiles with its row tiles adjacent, so that the lhs rows of a band
// are read again from L2 by every column tile, and a group of several row
// tiles reads each weight tile from device memory once.
constexpr int kTcBand = 4;

// The tensor-core block for BM-row tiles: W consumer warpgroups of 64 rows
// share each stage's weight tile, and one producer warp fills the ring.
// A BM of 8 loads 8 lhs rows a stage (the rest of the warpgroup's 64 are
// never stored).  Each stage is 1024-aligned: a 128-byte swizzle atom.
template <int BM, int STAGES>
struct Tc {
  static constexpr int W = (BM + kTcWarpgroupRows - 1) / kTcWarpgroupRows;
  static constexpr int kThreads = 128 * W + 32;
  static constexpr int kARegion = W * kTcWarpgroupRows * kTcBK * 2;
  static constexpr int kALoad = BM * kTcBK * 2;
  static constexpr int kStage = kARegion + 2 * kTcBHalfBytes;
  // the ring, its 2 x STAGES mbarriers, and slack to align the ring
  static constexpr int kSmem = 1024 + STAGES * kStage + 2 * STAGES * 8;
  static constexpr int kBlocksPerSM = kSmem <= 113 * 1024 ? 2 : 1;
  static_assert(kStage % 1024 == 0 && kSmem <= 232448, "stage layout");
};

// a refused tensor map returns kEncodeError + its CUresult, apart from
// the cudaError_t codes
constexpr int kEncodeError = 100000;

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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
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

// Pins the accumulators: the compiler may not move a read or write of
// them across this point (wgmma writes them asynchronously).
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, K-major) * B (16 x 128, MN-major).
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}"
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
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One block: rows [r0, r1) of one expert (or of the zero tail), BM at
// most, times the 128 columns from blockIdx.y * 128.  Threads 0 .. 128W-1
// are the consumer warpgroups (warpgroup w: rows 64w .. 64w + 63), the
// last warp the producer.  With kMath false the consumers only wait for
// each stage and release it, and store zeros: the ring's stream alone, the
// floor this design puts under the kernel (ops.stream_floor).
template <typename TO, int BM, int STAGES, bool kMath>
__global__ void __launch_bounds__(Tc<BM, STAGES>::kThreads,
                                  Tc<BM, STAGES>::kBlocksPerSM)
    gmm_kernel_wgmma(__grid_constant__ const CUtensorMap lhs_map,
                     __grid_constant__ const CUtensorMap rhs_map, Params p) {
  using C = Tc<BM, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tile[3];                  // expert, r0, r1
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * C::kStage;        // full[s]: +8s
  const uint32_t empty = full + STAGES * 8;               // empty[s]: +8s

  // the block's row and column tiles (kTcBand)
  const int n_col = (p.N + kTcBN - 1) / kTcBN;
  const int band = blockIdx.x / (kTcBand * n_col);
  const int in_band = min(kTcBand, p.row_tiles - band * kTcBand);
  const int local = blockIdx.x - band * kTcBand * n_col;
  const int col_tile = local / in_band;
  if (threadIdx.x == 0) {
    find_tile(p, BM, band * kTcBand + local % in_band, tile);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer
      mbar_init(empty + 8 * s, 4 * C::W);          // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int expert = tile[0], r0 = tile[1], rows = tile[2] - tile[1];
  if (expert == -2) return;
  const int n0 = col_tile * kTcBN;
  TO* out = static_cast<TO*>(p.out);

  if (expert == -1) {                      // a tile of the zero tail
    for (int i = threadIdx.x; i < rows * kTcBN; i += C::kThreads) {
      const int c = n0 + i % kTcBN;
      if (c < p.N)
        out[static_cast<long long>(r0 + i / kTcBN) * p.N + c] = TO(0.f);
    }
    return;
  }

  const int nk = (p.K + kTcBK - 1) / kTcBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * C::W) {                  // the producer warp
    if (lane == 0) {
      // a second 64-column box only where it holds a real column; past K
      // and T, TMA fills zeros (and counts their bytes)
      const bool second = n0 + kTcHalf < p.N;
      const uint32_t bytes = C::kALoad + (second ? 2 : 1) * kTcBHalfBytes;
      int slot = 0;
      uint32_t parity = 0;
      for (int i = 0; i < nk; ++i) {
        mbar_wait(empty + 8 * slot, parity ^ 1);
        const uint32_t a = ring + slot * C::kStage, b = a + C::kARegion;
        const uint32_t bar = full + 8 * slot;
        mbar_expect_tx(bar, bytes);
        tma_load_2d(a, &lhs_map, bar, i * kTcBK, r0);
        tma_load_3d(b, &rhs_map, bar, n0, i * kTcBK, expert);
        if (second)
          tma_load_3d(b + kTcBHalfBytes, &rhs_map, bar, n0 + kTcHalf,
                      i * kTcBK, expert);
        if (++slot == STAGES) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroups; one whose 64 rows are all past the tile's
  // end takes part in the ring but issues no products
  const int wg = warp / 4;
  const bool live = kMath && wg * kTcWarpgroupRows < rows;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int slot = 0, prev = 0;
  uint32_t parity = 0;
  for (int i = 0; i < nk; ++i) {
    mbar_wait(full + 8 * slot, parity);
    if (live) {
      const uint32_t a = ring + slot * C::kStage + wg * kTcWarpgroupRows * 128;
      const uint32_t b = ring + slot * C::kStage + C::kARegion;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        // A: 64 rows of 128 B, K-major; 16 columns are 32 B further.
        // B: 16 k rows of 128 B further; the two 64-column boxes are
        // kTcBHalfBytes apart (the leading offset), the 8-row groups of a
        // box 1024 B apart (the stride offset).
        wgmma_m64n128k16(acc, smem_desc(a + kk * 32, 16, 1024),
                         smem_desc(b + kk * 16 * 128, kTcBHalfBytes, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmma_wait<1>();                     // the previous stage's products
      fence_acc(acc);
    }
    if (i > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    prev = slot;
    if (++slot == STAGES) {
      slot = 0;
      parity ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator i of thread (warp w of its warpgroup, lane l): row
  // 16w + l/4 + 8 * (i/2 % 2), column 8 * (i/4) + 2 * (l%4) + i%2
  const int row = wg * kTcWarpgroupRows + 16 * (warp % 4) + lane / 4;
  const int col = n0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row + 8 * h;
    if (m >= rows) continue;
    TO* dst = out + static_cast<long long>(r0 + m) * p.N;
#pragma unroll
    for (int j = 0; j < kTcBN / 8; ++j) {
      const int c = col + 8 * j;
      if (c < p.N) store2(dst + c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

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

// A bfloat16 tensor map of `rank` axes (innermost first), 64 x box_rows
// (x 1) boxes, 128-byte swizzle, zero fill out of bounds.
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

template <typename TO, int BM, int STAGES, bool kMath>
cudaError_t launch_wgmma(const CUtensorMap& a, const CUtensorMap& b,
                         const Params& p, cudaStream_t s) {
  using C = Tc<BM, STAGES>;
  auto kernel = gmm_kernel_wgmma<TO, BM, STAGES, kMath>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  Params q = p;
  q.row_tiles = (p.T + BM - 1) / BM + p.E + 1;
  const long long blocks =
      static_cast<long long>(q.row_tiles) * ((p.N + kTcBN - 1) / kTcBN);
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, s>>>(a, b, q);
  return cudaGetLastError();
}

// The ring's depth for each tile height: 4 stages, two blocks an SM up to
// 64 rows; 3 stages for 128 rows, to keep two blocks an SM; one block of
// 192 rows an SM holds 4 (5 measured no faster).
template <int BM>
constexpr int tc_stages() {
  return BM == 128 ? 3 : 4;
}

template <int BM>
cudaError_t launch_rows(int out_dtype, int math, const CUtensorMap& a,
                        const CUtensorMap& b, const Params& p,
                        cudaStream_t s) {
  constexpr int S = tc_stages<BM>();
  if (math == 0) return launch_wgmma<float, BM, S, false>(a, b, p, s);
  if (out_dtype == 0) return launch_wgmma<float, BM, S, true>(a, b, p, s);
  return launch_wgmma<__nv_bfloat16, BM, S, true>(a, b, p, s);
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

// The SIMT instance.  dtype: 0 = float32, 1 = bfloat16 (lhs and rhs);
// out_dtype: 0 = float32, 1 = bfloat16 (bfloat16 output needs bfloat16
// inputs).  bm: rows per tile, 64 or 8.  group_sizes: E int32 on the
// device.  Returns a cudaError_t (0 = launched).
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

// The tensor-core instance: bfloat16 lhs and rhs, K and N multiples of 8,
// lhs, rhs and out 16-byte aligned.  out_dtype: 0 = float32,
// 1 = bfloat16.  bm: rows per tile, 8, 64, 128 or 192.  math = 0 launches
// the stream-only variant (the ring without the products; `out`, float32,
// gets zeros).  Returns 0, a cudaError_t, or kEncodeError + the CUresult
// of a refused tensor map.
int gmm_wgmma_launch(int device, int out_dtype, int math, int bm,
                     const void* lhs, const void* rhs, const void* group_sizes,
                     void* out, int T, int K, int N, int E, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8 ||
      !aligned16(lhs) || !aligned16(rhs) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a, b;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(T)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint64_t b_dims[3] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(E)};
  const cuuint64_t b_strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                   static_cast<cuuint64_t>(K) * N * 2};
  int res = encode(&a, lhs, 2, a_dims, a_strides, bm);
  if (res == 0) res = encode(&b, rhs, 3, b_dims, b_strides, kTcBK);
  if (res != 0) return res;
  Params p = {};
  p.gs = static_cast<const int*>(group_sizes);
  p.out = out;
  p.T = T;
  p.K = K;
  p.N = N;
  p.E = E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bm) {
    case 8: err = launch_rows<8>(out_dtype, math, a, b, p, s); break;
    case 64: err = launch_rows<64>(out_dtype, math, a, b, p, s); break;
    case 128: err = launch_rows<128>(out_dtype, math, a, b, p, s); break;
    case 192: err = launch_rows<192>(out_dtype, math, a, b, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one tensor-core block of bm-row tiles, bytes.
int gmm_wgmma_smem_bytes(int bm) {
  switch (bm) {
    case 8: return Tc<8, tc_stages<8>()>::kSmem;
    case 64: return Tc<64, tc_stages<64>()>::kSmem;
    case 128: return Tc<128, tc_stages<128>()>::kSmem;
    case 192: return Tc<192, tc_stages<192>()>::kSmem;
    default: return -1;
  }
}

const char* gmm_error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
