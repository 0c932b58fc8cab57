// Hopper grouped matmul, backward: the gradients of the expert products.
//
// Replaces no Pallas kernel: the JAX package differentiates its `gmm`
// (src/repro/kernels/moe_gmm/ops.py:15) off the TPU through
// `jax.lax.ragged_dot`'s VJP and has no Pallas backward.  The plain
// PyTorch version these kernels are held against is
// `ref.py::gmm_backward_reference`, which is held against that VJP.
//
// What it computes, for the forward out[t] = lhs[t] @ rhs[e(t)] (rows
// sorted by expert, group e owning rows [offsets[e-1], offsets[e]) with
// offsets = cumsum(group_sizes), a group cut at row T, rows past the total
// zero) and the output gradient dout (T, N):
//
//   dlhs[t] = dout[t] @ rhs[e(t)]^T        zero for the rows past the total;
//   drhs[e] = lhs[rows of e]^T @ dout[rows of e]   zero for an empty group.
//
// Sums in float32; each gradient is stored in its input's dtype.  The host
// never reads the group sizes.  Two instances, chosen by `ops.bwd_route`
// (the forward's `route`):
//
//   gmm_bwd_dlhs_wgmma,   bfloat16 lhs and rhs with K and N multiples of 8
//   gmm_bwd_drhs_wgmma    and 16-byte aligned tensors (every expert product
//                         of the MoE layer in bfloat16): TMA, wgmma.  dout
//                         reaches them in bfloat16: the wrapper rounds the
//                         float32 cotangent once, in one cast pass, as a
//                         TPU's default-precision product rounds a float32
//                         operand;
//   gmm_bwd_simt          float32 inputs (FP32 FMAs, no TF32: TF32 would miss
//                         the 1e-4 tolerance) and the bfloat16 shapes TMA
//                         cannot take; dout stays float32.
//
// What bounds it on this card, at jamba-v0.1-52b's training shapes (8 x 512
// tokens, top-2, capacity factor 1.25: 10,240 rows in 16 groups of 640;
// d_model 4096, d_ff 14336): each of dlhs and drhs is 2 x 10240 x 4096 x
// 14336 = 1.203 TFLOP, 1.216 ms at 989 TFLOP/s, against 2.3-2.6 GB of
// bytes, 0.70-0.76 ms at 3.35 TB/s: bound by operations.
//
// gmm_bwd_dlhs_wgmma is the forward's gmm_kernel_wgmma with the weight read
// transposed in place: a block is one (expert, BM-row tile within its
// group) x 128 output columns (of K), found by the same O(E) walk
// (find_tile), tail tiles zeroed; it contracts over N in 64-deep stages.
// Its B tile rhs[e][k0:k0+128, n:n+64] has the contraction axis
// contiguous, so it is wgmma's K-major B (transpose bit 0), loaded by the
// forward's own (n, k, e) tensor map as two 64 x 64 boxes; the weights are
// never transposed or copied (that copy would be 1.88 GB a product at
// jamba's shapes, as much traffic as the product).
//
// gmm_bwd_drhs_wgmma: one block per (expert, 128 rows of K, 128 columns
// of N), blocks of one expert adjacent, so that its lhs and dout rows
// (23 MB at jamba's gate/up shapes) are read again from L2.  Two consumer
// warpgroups of 64 K rows share each stage's dout tile.  The block walks
// its group's rows in 64-row stages from the group's first row: A is
// lhs[rows]^T, whose contraction axis (rows) is strided, so wgmma reads it
// MN-major (transpose bit 1); B is dout[rows], MN-major as the forward's
// weights.  TMA fills zeros only past the tensor, not past a group's end,
// so in a group's last, partial stage each warpgroup zeroes the rows of its
// A box past the end (rows of the next group) in shared memory, fences them
// for the async proxy and syncs its 128 threads before its products.
// Sums stay in registers over the whole group and are stored once: no
// atomics, no split over rows, a fixed order, so two calls give the same
// bits.  An empty group stores zeros.
//
// gmm_bwd_simt: the forward's tiled SIMT kernel with the tiles read across
// (dlhs: dout's rows and rhs's rows along the contraction, widened to
// float32 and stored transposed in shared memory) or along (drhs: lhs's
// and dout's rows of the group, masked at the group's end).
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
  const void* dout;    // (T, N) contiguous: float32 (simt), bfloat16 (wgmma)
  const void* lhs;     // (T, K) contiguous
  const void* rhs;     // (E, K, N) contiguous
  const int* gs;       // (E,) int32 group sizes
  void* dlhs;          // (T, K) contiguous, lhs's dtype
  void* drhs;          // (E, K, N) contiguous, rhs's dtype
  int T, K, N, E;
  bool vec_dout, vec_lhs, vec_rhs;  // 16-byte loads allowed
  int row_tiles;                    // dlhs_wgmma's grid
};

// The t-th (expert, row tile) pair of BM-row tiles: tile[0] the expert
// (-1: a tile of the zero tail; -2: past the end), tile[1] and tile[2] its
// rows [r0, r1).  One thread walks the E group sizes (gmm.cu's walk).
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

// The rows [rows[0], rows[1]) of group e, cut at row T.
__device__ void find_group(const Params& p, int e, int* rows) {
  int start = 0;
  for (int i = 0; i < e; ++i) start += min(max(p.gs[i], 0), p.T - start);
  rows[0] = start;
  rows[1] = start + min(max(p.gs[e], 0), p.T - start);
}

// ---------------------------------------------------------------------------
// gmm_bwd_simt: the SIMT instance
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
// `limit`; zeros for a row that is not there (`live` false).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, bool live, int col,
                                           int limit, bool vec, float* d) {
  constexpr int V = 16 / sizeof(T);
  if (live && vec && col + V <= limit) {
    load16(row + col, d);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      d[i] = live && col + i < limit ? widen(row[col + i]) : 0.f;
  }
}

// tile[c][m] = src[m * ld + c0 + c] for the W rows m of the tile (zero for
// m >= rows) and the kBK contraction indices c (zero past `limit`): rows
// read along the contraction, stored transposed.
template <typename TS, int W>
__device__ __forceinline__ void load_across(float (*tile)[W], const TS* src,
                                            long long ld, int rows, int c0,
                                            int limit, bool vec) {
  constexpr int V = 16 / sizeof(TS);
  for (int c = threadIdx.x; c < W * kBK / V; c += kThreads) {
    const int m = c / (kBK / V), kk = (c % (kBK / V)) * V;
    float v[V];
    load_chunk(src + m * ld, m < rows, c0 + kk, limit, vec, v);
#pragma unroll
    for (int i = 0; i < V; ++i) tile[kk + i][m] = v[i];
  }
}

// tile[c][n] = src[c * ld + n0 + n] for the kBK contraction rows c (zero
// for c >= rows) and the W columns n (zero past `limit`).
template <typename TS, int W>
__device__ __forceinline__ void load_along(float (*tile)[W], const TS* src,
                                           long long ld, int rows, int n0,
                                           int limit, bool vec) {
  constexpr int V = 16 / sizeof(TS);
  for (int c = threadIdx.x; c < kBK * W / V; c += kThreads) {
    const int kk = c / (W / V), n = (c % (W / V)) * V;
    float v[V];
    load_chunk(src + kk * ld, kk < rows, n0 + n, limit, vec, v);
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(&tile[kk][n + i]) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
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

// One block, BM output rows by 128 output columns, each thread TM by TN.
// kDrhs false (dlhs): rows [r0, r1) of one expert or of the zero tail
// (find_tile over blockIdx.x) by the 128 columns of K from blockIdx.y *
// 128, summed over N.  kDrhs true (drhs): the BM rows of K from
// blockIdx.x * BM by the 128 columns of N from blockIdx.y * 128 of expert
// blockIdx.z, summed over its group's rows.  T is lhs's and rhs's type,
// dout is float32.
template <typename T, bool kDrhs, int BM, int TM, int TN>
__global__ void __launch_bounds__(kThreads) gmm_bwd_simt(Params p) {
  constexpr int kColThreads = kBN / TN;
  constexpr int kGroups = TN / 4;              // groups of 4 columns
  constexpr int kGroupStride = kBN / kGroups;
  static_assert((BM / TM) * kColThreads == kThreads, "thread layout");
  static_assert(TN % 4 == 0, "tile shapes");

  __shared__ __align__(16) float As[kBK][BM];   // A tile, contraction-major
  __shared__ __align__(16) float Bs[kBK][kBN];  // B tile
  __shared__ int tile[3];

  const float* dout = static_cast<const float*>(p.dout);
  int expert, m0, rows, n0, out_ld, out_limit;
  T* out;
  if constexpr (kDrhs) {
    expert = blockIdx.z;
    if (threadIdx.x == 0) find_group(p, expert, tile);
    __syncthreads();
    m0 = blockIdx.x * BM;
    rows = min(BM, p.K - m0);
    n0 = blockIdx.y * kBN;
    out_ld = p.N;
    out_limit = p.N;
    out = static_cast<T*>(p.drhs) + static_cast<long long>(expert) * p.K * p.N;
  } else {
    if (threadIdx.x == 0) find_tile(p, BM, blockIdx.x, tile);
    __syncthreads();
    expert = tile[0];
    if (expert == -2) return;
    m0 = tile[1];
    rows = tile[2] - tile[1];
    n0 = blockIdx.y * kBN;
    out_ld = p.K;
    out_limit = p.K;
    out = static_cast<T*>(p.dlhs);
  }

  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if constexpr (kDrhs) {
    const int start = tile[0], end = tile[1];
    const T* lhs = static_cast<const T*>(p.lhs);
    for (int t0 = start; t0 < end; t0 += kBK) {
      const int live = end - t0;
      load_along<T, BM>(As, lhs + static_cast<long long>(t0) * p.K, p.K,
                        live, m0, p.K, p.vec_lhs);
      load_along<float, kBN>(Bs, dout + static_cast<long long>(t0) * p.N,
                             p.N, live, n0, p.N, p.vec_dout);
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
  } else if (expert >= 0) {
    const float* A = dout + static_cast<long long>(m0) * p.N;
    const T* W = static_cast<const T*>(p.rhs) +
                 (static_cast<long long>(expert) * p.K + n0) * p.N;
    for (int c0 = 0; c0 < p.N; c0 += kBK) {
      load_across<float, BM>(As, A, p.N, rows, c0, p.N, p.vec_dout);
      load_across<T, kBN>(Bs, W, p.N, p.K - n0, c0, p.N, p.vec_rhs);
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

  const bool vec_out = out_ld % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = ty * TM + i;
    if (m >= rows) continue;
    T* row = out + static_cast<long long>(m0 + m) * out_ld;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      store4(row, n0 + g * kGroupStride + tx * 4, out_limit, vec_out,
             &acc[i][4 * g]);
  }
}

template <typename T>
cudaError_t launch_simt(int bm, const Params& p, cudaStream_t s) {
  if (p.dlhs != nullptr) {
    const unsigned tiles =
        static_cast<unsigned>((p.T + bm - 1) / bm + p.E + 1);
    const dim3 grid(tiles, (p.K + kBN - 1) / kBN);
    switch (bm) {
      case 64: gmm_bwd_simt<T, false, 64, 4, 8><<<grid, kThreads, 0, s>>>(p); break;
      case 8: gmm_bwd_simt<T, false, 8, 1, 4><<<grid, kThreads, 0, s>>>(p); break;
      default: return cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.drhs != nullptr) {
    const dim3 grid((p.K + 63) / 64, (p.N + kBN - 1) / kBN, p.E);
    gmm_bwd_simt<T, true, 64, 4, 8><<<grid, kThreads, 0, s>>>(p);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// gmm_bwd_dlhs_wgmma, gmm_bwd_drhs_wgmma: the tensor-core instance
// ---------------------------------------------------------------------------

constexpr int kTcBN = 128;                 // columns per block: wgmma's N
constexpr int kTcBK = 64;                  // depth of a stage: 128 B of bf16
constexpr int kTcHalf = 64;                // columns per TMA box
constexpr int kTcBHalfBytes = kTcBK * kTcHalf * 2;        // 8 KB
constexpr int kTcWarpgroupRows = 64;       // wgmma's M
// dlhs's launch order, the forward's: bands of kTcBand row tiles, each band
// sweeping the column tiles with its row tiles adjacent.
constexpr int kTcBand = 4;

// The tensor-core block for BM-row tiles (gmm.cu's): W consumer warpgroups
// of 64 rows share each stage's 128-column B tile, and one producer warp
// fills the ring.  Each stage is 1024-aligned: a 128-byte swizzle atom.
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

// drhs's block: 128 rows of K (two warpgroups), 3 stages (two blocks an SM)
using TcDrhs = Tc<128, 3>;

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
// K-major operands (rows of 128 B along the contraction): leading 16 (not
// read), stride 1024 (8 rows); MN-major ones (rows of 128 B along M or N,
// one per contraction index): leading the step between 64-column boxes,
// stride 1024 (8 contraction rows).
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

// d (64 x 128, f32) += A (64 x 16) * B (16 x 128), bf16 from shared
// memory; kTA, kTB: the transpose bits (0 K-major, 1 MN-major).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}"
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
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The 64 x 128 accumulators of a warpgroup's rows [row0, row0 + 64) into
// out (row stride ld) at columns col0.., masked to `rows` rows and `cols`
// columns: accumulator i of thread (warp w of its warpgroup, lane l) is row
// 16w + l/4 + 8 * (i/2 % 2), column 8 * (i/4) + 2 * (l%4) + i%2.  `cols`
// is a multiple of 8, so a pair is in or out whole.
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, long long ld,
                                          int rows, int cols, int warp,
                                          int lane, const float* acc) {
  const int row = 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row + 8 * h;
    if (m >= rows) continue;
    __nv_bfloat16* dst = out + m * ld;
#pragma unroll
    for (int j = 0; j < kTcBN / 8; ++j) {
      const int c = col + 8 * j;
      if (c < cols)
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// dlhs: one block per (expert, BM-row tile within its group) or tile of
// the zero tail, times the 128 columns of K from its column tile; sums over
// N in 64-deep stages.  Threads 0 .. 128W-1 are the consumer warpgroups
// (warpgroup w: rows 64w .. 64w + 63), the last warp the producer.
template <int BM, int STAGES>
__global__ void __launch_bounds__(Tc<BM, STAGES>::kThreads,
                                  Tc<BM, STAGES>::kBlocksPerSM)
    gmm_bwd_dlhs_wgmma(__grid_constant__ const CUtensorMap dout_map,
                       __grid_constant__ const CUtensorMap rhs_map, Params p) {
  using C = Tc<BM, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tile[3];                  // expert, r0, r1
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * C::kStage;        // full[s]: +8s
  const uint32_t empty = full + STAGES * 8;               // empty[s]: +8s

  const int n_col = (p.K + kTcBN - 1) / kTcBN;
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
  const int k0 = col_tile * kTcBN;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.dlhs);

  if (expert == -1) {                      // a tile of the zero tail
    for (int i = threadIdx.x; i < rows * kTcBN; i += C::kThreads) {
      const int c = k0 + i % kTcBN;
      if (c < p.K)
        out[static_cast<long long>(r0 + i / kTcBN) * p.K + c] =
            __float2bfloat16_rn(0.f);
    }
    return;
  }

  const int nk = (p.N + kTcBK - 1) / kTcBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * C::W) {                  // the producer warp
    if (lane == 0) {
      // the B tile: 128 rows of K as two 64 x 64 boxes of the forward's
      // (n, k, e) map, the second only where it holds a real row; past N,
      // K and T, TMA fills zeros (and counts their bytes)
      const bool second = k0 + kTcHalf < p.K;
      const uint32_t bytes = C::kALoad + (second ? 2 : 1) * kTcBHalfBytes;
      int slot = 0;
      uint32_t parity = 0;
      for (int i = 0; i < nk; ++i) {
        mbar_wait(empty + 8 * slot, parity ^ 1);
        const uint32_t a = ring + slot * C::kStage, b = a + C::kARegion;
        const uint32_t bar = full + 8 * slot;
        mbar_expect_tx(bar, bytes);
        tma_load_2d(a, &dout_map, bar, i * kTcBK, r0);
        tma_load_3d(b, &rhs_map, bar, i * kTcBK, k0, expert);
        if (second)
          tma_load_3d(b + kTcBHalfBytes, &rhs_map, bar, i * kTcBK,
                      k0 + kTcHalf, expert);
        if (++slot == STAGES) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const bool live = wg * kTcWarpgroupRows < rows;
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
        // A: 64 rows of dout, 128 B along N; B: 128 rows of K, 128 B along
        // N (K-major); 16 contraction columns are 32 B further in both
        wgmma_m64n128k16<0, 0>(acc, smem_desc(a + kk * 32, 16, 1024),
                               smem_desc(b + kk * 32, 16, 1024));
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
  if (live) {
    const int row0 = wg * kTcWarpgroupRows;
    store_acc(out + static_cast<long long>(r0 + row0) * p.K + k0, p.K,
              rows - row0, p.K - k0, warp, lane, acc);
  }
}

// drhs: one block per (expert, 128 rows of K, 128 columns of N), experts
// slowest; sums over the group's rows in 64-row stages.  Warpgroup w owns
// K rows k0 + 64w ..; the last warp is the producer.
__global__ void __launch_bounds__(TcDrhs::kThreads, TcDrhs::kBlocksPerSM)
    gmm_bwd_drhs_wgmma(__grid_constant__ const CUtensorMap lhs_map,
                       __grid_constant__ const CUtensorMap dout_map,
                       Params p) {
  using C = TcDrhs;
  constexpr int STAGES = 3;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int group[2];                 // the group's rows [start, end)
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * C::kStage;
  const uint32_t empty = full + STAGES * 8;

  const int n_k = (p.K + kTcBN - 1) / kTcBN, n_n = (p.N + kTcBN - 1) / kTcBN;
  const int expert = blockIdx.x / (n_k * n_n);
  const int rest = blockIdx.x - expert * n_k * n_n;
  const int k0 = (rest / n_n) * kTcBN, n0 = (rest % n_n) * kTcBN;
  if (threadIdx.x == 0) {
    find_group(p, expert, group);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C::W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int start = group[0], end = group[1];
  const int stages = (end - start + kTcBK - 1) / kTcBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * C::W) {                  // the producer warp
    if (lane == 0) {
      // A: lhs[t.., k0 + 64w ..] for each warpgroup w whose rows are real;
      // B: dout[t.., n0 ..] as two boxes, the second where it holds a real
      // column.  Past T, K and N, TMA fills zeros.
      const bool second_a = k0 + kTcHalf < p.K;
      const bool second_b = n0 + kTcHalf < p.N;
      const uint32_t bytes =
          (2 + second_a + second_b) * static_cast<uint32_t>(kTcBHalfBytes);
      int slot = 0;
      uint32_t parity = 0;
      for (int i = 0; i < stages; ++i) {
        mbar_wait(empty + 8 * slot, parity ^ 1);
        const uint32_t a = ring + slot * C::kStage, b = a + C::kARegion;
        const uint32_t bar = full + 8 * slot;
        const int t = start + i * kTcBK;
        mbar_expect_tx(bar, bytes);
        tma_load_2d(a, &lhs_map, bar, k0, t);
        if (second_a)
          tma_load_2d(a + kTcBHalfBytes, &lhs_map, bar, k0 + kTcHalf, t);
        tma_load_2d(b, &dout_map, bar, n0, t);
        if (second_b)
          tma_load_2d(b + kTcBHalfBytes, &dout_map, bar, n0 + kTcHalf, t);
        if (++slot == STAGES) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int row0 = k0 + wg * kTcWarpgroupRows;
  const bool live = row0 < p.K;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int slot = 0, prev = 0;
  uint32_t parity = 0;
  for (int i = 0; i < stages; ++i) {
    mbar_wait(full + 8 * slot, parity);
    if (live) {
      const uint32_t a = ring + slot * C::kStage + wg * kTcBHalfBytes;
      const uint32_t b = ring + slot * C::kStage + C::kARegion;
      const int valid = end - (start + i * kTcBK);
      if (valid < kTcBK) {
        // the group ends inside this stage: zero the warpgroup's A rows
        // past it (the next group's rows, which TMA loaded), whole 128-byte
        // rows, so the swizzle does not matter; then order these generic
        // stores before wgmma's reads (async proxy)
        for (int c = threadIdx.x % 128; c < (kTcBK - valid) * 8; c += 128)
          asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};"
                       ::"r"(a + valid * 128 + c * 16), "r"(0) : "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      }
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        // A: 16 rows (of the group) of 128 B along K, MN-major; B: 16 rows
        // of 128 B along N as two boxes kTcBHalfBytes apart, MN-major; 16
        // contraction rows are 2048 B further in both
        wgmma_m64n128k16<1, 1>(
            acc, smem_desc(a + kk * 16 * 128, kTcBHalfBytes, 1024),
            smem_desc(b + kk * 16 * 128, kTcBHalfBytes, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmma_wait<1>();
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
  if (live)                                // zeros for an empty group
    store_acc(static_cast<__nv_bfloat16*>(p.drhs) +
                  (static_cast<long long>(expert) * p.K + row0) * p.N + n0,
              p.N, p.K - row0, p.N - n0, warp, lane, acc);
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

// A row-major (rows, cols) bfloat16 matrix's map, 64 x box_rows boxes.
int encode_rows(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  return encode(map, ptr, 2, dims, strides, box_rows);
}

// The ring's depth for each tile height, the forward's: 4 stages, two
// blocks an SM up to 64 rows; 3 stages for 128 rows, to keep two blocks an
// SM; one block of 192 rows an SM holds 4.
template <int BM>
constexpr int tc_stages() {
  return BM == 128 ? 3 : 4;
}

template <int BM>
cudaError_t launch_dlhs(const CUtensorMap& a, const CUtensorMap& b,
                        const Params& p, cudaStream_t s) {
  using C = Tc<BM, tc_stages<BM>()>;
  auto kernel = gmm_bwd_dlhs_wgmma<BM, tc_stages<BM>()>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  Params q = p;
  q.row_tiles = (p.T + BM - 1) / BM + p.E + 1;
  const long long blocks =
      static_cast<long long>(q.row_tiles) * ((p.K + kTcBN - 1) / kTcBN);
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, s>>>(a, b, q);
  return cudaGetLastError();
}

cudaError_t launch_drhs(const CUtensorMap& a, const CUtensorMap& b,
                        const Params& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gmm_bwd_drhs_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TcDrhs::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(p.E) *
                           ((p.K + kTcBN - 1) / kTcBN) *
                           ((p.N + kTcBN - 1) / kTcBN);
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  gmm_bwd_drhs_wgmma<<<static_cast<unsigned>(blocks), TcDrhs::kThreads,
                       TcDrhs::kSmem, s>>>(a, b, p);
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

Params make_params(const void* dout, const void* lhs, const void* rhs,
                   const void* group_sizes, void* dlhs, void* drhs, int T,
                   int K, int N, int E) {
  Params p = {};
  p.dout = dout;
  p.lhs = lhs;
  p.rhs = rhs;
  p.gs = static_cast<const int*>(group_sizes);
  p.dlhs = dlhs;
  p.drhs = drhs;
  p.T = T;
  p.K = K;
  p.N = N;
  p.E = E;
  return p;
}

}  // namespace

extern "C" {

// The SIMT instance.  dtype: 0 = float32, 1 = bfloat16 (lhs, rhs, dlhs and
// drhs); dout float32.  bm: dlhs's rows per tile, 64 or 8.  dlhs or drhs
// null: that gradient is not computed.  group_sizes: E int32 on the
// device.  Returns a cudaError_t (0 = launched).
int gmm_bwd_launch(int device, int dtype, int bm, const void* dout,
                   const void* lhs, const void* rhs, const void* group_sizes,
                   void* dlhs, void* drhs, int T, int K, int N, int E,
                   void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0 || E > 65535 ||
      (K + kBN - 1) / kBN > 65535 || (N + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int v = dtype == 0 ? 4 : 8;     // elements in 16 bytes
  Params p = make_params(dout, lhs, rhs, group_sizes, dlhs, drhs, T, K, N, E);
  p.vec_dout = N % 4 == 0 && aligned16(dout);
  p.vec_lhs = K % v == 0 && aligned16(lhs);
  p.vec_rhs = N % v == 0 && aligned16(rhs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_simt<float>(bm, p, s)
                               : launch_simt<__nv_bfloat16>(bm, p, s);
  return static_cast<int>(err);
}

// The tensor-core instance: bfloat16 dout, lhs and rhs (and dlhs, drhs),
// K and N multiples of 8, every tensor 16-byte aligned.  bm: dlhs's rows
// per tile, 8, 64, 128 or 192.  dlhs or drhs null: that gradient is not
// computed.  Returns 0, a cudaError_t, or kEncodeError + the CUresult of a
// refused tensor map.
int gmm_bwd_wgmma_launch(int device, int bm, const void* dout,
                         const void* lhs, const void* rhs,
                         const void* group_sizes, void* dlhs, void* drhs,
                         int T, int K, int N, int E, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (T <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8 ||
      !aligned16(dout) || !aligned16(lhs) || !aligned16(rhs) ||
      (dlhs != nullptr && !aligned16(dlhs)) ||
      (drhs != nullptr && !aligned16(drhs)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p =
      make_params(dout, lhs, rhs, group_sizes, dlhs, drhs, T, K, N, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dlhs != nullptr) {
    CUtensorMap a, b;
    const cuuint64_t b_dims[3] = {static_cast<cuuint64_t>(N),
                                  static_cast<cuuint64_t>(K),
                                  static_cast<cuuint64_t>(E)};
    const cuuint64_t b_strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                     static_cast<cuuint64_t>(K) * N * 2};
    int res = encode_rows(&a, dout, T, N, bm);
    if (res == 0) res = encode(&b, rhs, 3, b_dims, b_strides, kTcBK);
    if (res != 0) return res;
    cudaError_t err;
    switch (bm) {
      case 8: err = launch_dlhs<8>(a, b, p, s); break;
      case 64: err = launch_dlhs<64>(a, b, p, s); break;
      case 128: err = launch_dlhs<128>(a, b, p, s); break;
      case 192: err = launch_dlhs<192>(a, b, p, s); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (drhs != nullptr) {
    CUtensorMap a, b;
    int res = encode_rows(&a, lhs, T, K, kTcBK);
    if (res == 0) res = encode_rows(&b, dout, T, N, kTcBK);
    if (res != 0) return res;
    return static_cast<int>(launch_drhs(a, b, p, s));
  }
  return 0;
}

const char* gmm_bwd_error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
