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
//                         of the MoE layer in bfloat16): TMA, wgmma,
//                         clusters of two blocks.  dout reaches them in
//                         bfloat16: the wrapper rounds the float32
//                         cotangent once, in one cast pass, as a TPU's
//                         default-precision product rounds a float32
//                         operand;
//   gmm_bwd_simt          float32 inputs (FP32 FMAs, no TF32: TF32 would miss
//                         the 1e-4 tolerance) and the bfloat16 shapes TMA
//                         cannot take; dout stays float32.
//
// What bounds it on this card, at jamba-v0.1-52b's training shapes (8 x 512
// tokens, top-2, capacity factor 1.25: 10,240 rows in 16 groups of 640;
// d_model 4096, d_ff 14336): each of dlhs and drhs is 2 x 10240 x 4096 x
// 14336 = 1.203 TFLOP, 1.216 ms at 989 TFLOP/s, against 2.3-2.6 GB of
// bytes, 0.70-0.76 ms at 3.35 TB/s: bound by operations.  What held the
// first design (128 x 128 tiles, one operand stream a block) was the
// traffic from L2 into shared memory: 64 FLOP a byte, 18.8 GB a gradient
// a call, whose loads alone (the floor probe, products taken out) took
// 84 % of dlhs's time and 58 % of drhs's on an H100.  This design moves
// 11.7 GB (dlhs) and 9.4 GB (drhs):
//
//   * 128 x 256 output tiles: two consumer warpgroups of 64 rows, each on
//     wgmma m64n256k16 with 128 float32 accumulators a thread; a stage is
//     a 16 KB A tile and a 32 KB B tile, 85 FLOP a byte; 4 stages.  One
//     producer warp besides them leaves each thread 224 registers
//     (65,536 / 288), so no setmaxnreg is needed;
//   * clusters of two blocks that share one operand by TMA multicast: each
//     block loads half the shared tile into both blocks' shared memory.
//     Each stage's full barrier counts the bytes from both producers, and
//     its empty barrier the releases of both blocks' eight consumer warps
//     (a producer writes into both blocks); each producer, before it
//     leaves, waits for the release of its last stages, so that no block
//     exits while its partner may still reach its barriers;
//   * dlhs (gmm_bwd_dlhs_wgmma): one cluster per (expert, 128-row tile
//     within its group, pair of 256-column tiles of K), found by one
//     thread's O(E) walk of the group sizes (find_dlhs_tile), experts
//     slowest, then column pairs, then the expert's row tiles, so that the
//     row tiles reading one stretch of an expert's 117 MB of weights run
//     side by side; the pair shares the tile's dout rows (A), each block
//     loading 64 of the 128: 40 KB of L2 traffic a block a stage, 102 FLOP
//     a byte; at jamba's gate/up product 1,280 blocks x 224 stages x 40 KB
//     = 11.7 GB (down: 4,480 x 64 x 40 KB, the same).  128-row tiles: a
//     group of 640 rows is 5 whole tiles, where the forward's 192-row tile
//     left one warpgroup of three live in each group's last tile.  The
//     weight tile rhs[e][k0:k0+256, n:n+64] has the contraction axis
//     contiguous, so it is wgmma's K-major B (transpose bit 0), loaded by
//     the forward's (n, k, e) tensor map as one 256-row box; the weights
//     are never transposed or copied (that copy would be 1.88 GB a
//     product at jamba's shapes, as much traffic as the product).  A
//     block whose column tile lies past K (a pair's second tile) loads
//     its half of A for its partner and does nothing else.  Its sums go
//     out by TMA through its own ring, free once both warpgroups' products
//     are done, where all 64 rows of a warpgroup are the tile's, and from
//     registers, masked, in a group's last, partial tile.  (A persistent
//     grid walking the same tiles was tried on an H100 and was slower,
//     its loads alone too);
//   * drhs (gmm_bwd_drhs_wgmma): a persistent grid, as many clusters as fit on
//     the card at once (`cudaOccupancyMaxActiveClusters`: 66 on an H100), each
//     walking tiles of (expert, pair of 128-row tiles of K, 256 columns of N),
//     experts slowest, so that the clusters work on about one expert at a time
//     and its lhs and dout rows (23 MB at jamba's gate/up shapes) are read
//     again from L2; a running cursor over the group sizes finds each tile's
//     rows.  The pair shares the tile's dout rows (B), each block loading 128
//     of the 256 columns: 32 KB a block a stage, 128 FLOP a byte; at gate/up
//     28,672 blocks' tiles x 10 stages x 32 KB = 9.4 GB.  (Clusters of four,
//     24 KB a stage, fit only 30 at once, on 120 SMs, and were tried and no
//     faster.)  A block sums over its group's rows in 64-row stages from the
//     group's first row: A is lhs[rows]^T, whose contraction axis (rows) is
//     strided, so wgmma reads it MN-major (transpose bit 1); B is dout[rows],
//     MN-major as the forward's weights.  TMA fills zeros only past the
//     tensor, not past a group's end, so in a group's last, partial stage each
//     warpgroup zeroes the rows of its A box past the end (rows of the next
//     group) in shared memory, fences them for the async proxy and syncs its
//     128 threads before its products.  The ring runs on from one tile into
//     the next, so the next tile's loads are in flight while this tile's sums
//     are stored; the sums go out by TMA stores from 16 KB of staging a
//     warpgroup, in two halves (4 stages leave no room for more), which
//     overlap the next tile's products (drhs is as large as the weights: 1.88
//     GB of writes a call);
//   * both: a stage is released one stage after its products were issued
//     (wgmma wait_group 1); sums stay in registers over the whole
//     contraction and are stored once: no atomics, no split over a group's
//     rows, a fixed order, so two calls give the same bits.  An empty
//     group's drhs and the padding rows' dlhs are stored as zeros.
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
  bool vec_dout, vec_lhs, vec_rhs;  // 16-byte loads allowed (simt)
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

constexpr int kTcBK = 64;                  // depth of a stage: 128 B of bf16
constexpr int kTcBox = 64;                 // a TMA box: 64 rows of 128 B
constexpr int kTcBoxBytes = kTcBox * kTcBK * 2;           // 8 KB
constexpr int kTcWarpgroupRows = 64;       // wgmma's M
constexpr int kTcRows = 2 * kTcWarpgroupRows;  // output rows a block
constexpr int kTcCols = 256;               // output columns a block: wgmma's N
constexpr int kTcABytes = kTcRows * kTcBK * 2;            // 16 KB
constexpr int kTcBBytes = kTcCols * kTcBK * 2;            // 32 KB
constexpr int kTcStage = kTcABytes + kTcBBytes;           // 48 KB
// two consumer warpgroups and one producer warp: 65,536 / 288 threads
// leaves each thread 224 registers, room for 128 accumulators without
// setmaxnreg (which moves registers between whole warpgroups)
constexpr int kTcThreads = 2 * 128 + 32;
constexpr int kTcProducerWarp = 8;
constexpr int kCluster = 2;                // blocks of a cluster
// 4 stages (192 KB: the loads in flight an SM that L2's latency asks
// for), and for drhs 16 KB of staging a warpgroup for the TMA stores of
// its 64 x 256 sums in two halves; one block an SM
constexpr int kDlhsStages = 4;
constexpr int kDrhsStages = 4;
constexpr int kDrhsStaging = 2 * kTcWarpgroupRows * (kTcCols / 2) * 2;
constexpr int kDlhsSmem = 1024 + kDlhsStages * kTcStage + 2 * kDlhsStages * 8;
constexpr int kDrhsSmem =
    1024 + kDrhsStages * kTcStage + kDrhsStaging + 2 * kDrhsStages * 8;
static_assert(kDlhsSmem <= 232448 && kDrhsSmem <= 232448, "shared memory");

// a refused tensor map returns kEncodeError + its CUresult, apart from
// the cudaError_t codes
constexpr int kEncodeError = 100000;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of the cluster's blocks: the barriers one block initialised
// are seen by the others before any multicast or remote arrival reaches
// them.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Releases a stage to the producers of every block of the cluster: lane 0
// of each consumer warp arrives on the stage's empty barrier in each block
// (its own included), since each producer's multicast writes into all.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  if (lane != 0) return;
#pragma unroll
  for (uint32_t cta = 0; cta < kCluster; ++cta)
    asm volatile(
        "{\n.reg .b32 remote;\n"
        "mapa.shared::cluster.u32 remote, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}"
        ::"r"(bar), "r"(cta) : "memory");
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

// One box into the same offset of every block's shared memory in the
// cluster, each block's barrier at `bar` counting its bytes.
__device__ __forceinline__ void tma_load_2d_all(uint32_t dst,
                                                 const CUtensorMap* map,
                                                 uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
      "h"(static_cast<uint16_t>((1 << kCluster) - 1)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
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
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) += A (64 x 16) * B (16 x 256), bf16 from shared
// memory; kTA, kTB: the transpose bits (0 K-major, 1 MN-major).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, %131, %132;\n}"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A ring position: the slot and the parity of its current phase.
struct Ring {
  int slot = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++slot == stages) {
      slot = 0;
      parity ^= 1;
    }
  }
};

// The producer's last act: wait until the consumers of both blocks have
// released the last `stages` loads, so that no block exits while its
// partner may still arrive on its barriers.
__device__ __forceinline__ void producer_tail(uint32_t empty, int stages,
                                              Ring r) {
  for (int i = 0; i < stages; ++i) {
    mbar_wait(empty + 8 * r.slot, r.parity ^ 1);
    r.advance(stages);
  }
}

// The 64 x 256 accumulators of a warpgroup's rows into out (row stride
// ld), masked to `rows` rows and `cols` columns: accumulator i of thread
// (warp w of its warpgroup, lane l) is row 16w + l/4 + 8 * (i/2 % 2),
// column 8 * (i/4) + 2 * (l%4) + i%2.  `cols` is a multiple of 8, so a
// pair is in or out whole.
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
    for (int j = 0; j < kTcCols / 8; ++j) {
      const int c = col + 8 * j;
      if (c < cols)
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// A warpgroup's 64 x 256 accumulators, rounded to bfloat16, stored by TMA
// at (col, row[, expert]) through `stg`: in kParts parts of 256 / kParts
// columns, each written as 64-column boxes in the 128-byte swizzle that
// TMA reads (chunk c of row m at 16 (c ^ m % 8)) by stmatrix (four 8 x 8
// matrices an instruction: chunks j and j + 1, rows m and m + 8 of the
// warp's 16, lane L addressing row L % 8 of matrix L / 8); then one
// thread stores the boxes that start before `cols` and commits them as a
// bulk group.  TMA clips rows and columns past the tensor.  Before each
// part the previous group must have been read out of the staging.
template <int kParts, bool k3d>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           uint32_t stg, int wg, int warp,
                                           int lane, const float* acc,
                                           int col, int row, int expert,
                                           int cols) {
  constexpr int kPart = kTcCols / kParts;
  const bool leader = threadIdx.x % 128 == 0;
  const int mrow = 16 * (warp % 4) + 8 * ((lane / 8) % 2) + lane % 8;
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    named_sync(1 + wg);
#pragma unroll
    for (int j = 0; j < kPart / 8; j += 2) {
      const int jj = part * kPart / 8 + j;         // 8-column chunk
      const int mj = j + lane / 16;                // this lane's matrix
      const uint32_t addr = stg + (mj / 8) * kTcBoxBytes + mrow * 128 +
                            (((mj % 8) ^ (mrow % 8)) * 16);
      uint32_t v[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(
            acc[4 * (jj + x / 2) + 2 * (x % 2)],
            acc[4 * (jj + x / 2) + 2 * (x % 2) + 1]);
        v[x] = *reinterpret_cast<const uint32_t*>(&b);
      }
      asm volatile(
          "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
          ::"r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + wg);
    if (leader) {
#pragma unroll
      for (int b = 0; b < kPart / kTcBox; ++b) {
        const int c = col + part * kPart + b * kTcBox;
        if (c >= cols) continue;
        if constexpr (k3d)
          tma_store_3d(map, stg + b * kTcBoxBytes, c, row, expert);
        else
          tma_store_2d(map, stg + b * kTcBoxBytes, c, row);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
}

// dlhs's column tiles come in pairs, one a block of a cluster.
__device__ __host__ __forceinline__ int dlhs_pairs(int K) {
  return ((K + kTcCols - 1) / kTcCols + 1) / 2;
}

// The q-th cluster's tile of dlhs: experts slowest, then column pairs,
// then the expert's 128-row tiles, so that the row tiles of one stretch
// of an expert's weights run side by side and read it from L2.  tile[0]
// the expert (-1: a tile of the zero tail past the groups; -2: past the
// end), tile[1] and tile[2] its rows [r0, r1), tile[3] its column pair.
// One thread walks the E group sizes; the host never reads them.
__device__ void find_dlhs_tile(const Params& p, int q, int* tile) {
  const int pairs = dlhs_pairs(p.K);
  int start = 0;
  for (int e = 0; e <= p.E; ++e) {          // e == E: the zero tail
    const int g = e < p.E ? min(max(p.gs[e], 0), p.T - start) : p.T - start;
    const int nt = (g + kTcRows - 1) / kTcRows;
    const long long here = static_cast<long long>(nt) * pairs;
    if (q < here) {
      const int r0 = start + (q % nt) * kTcRows;
      tile[0] = e < p.E ? e : -1;
      tile[1] = r0;
      tile[2] = min(start + g, r0 + kTcRows);
      tile[3] = q / nt;
      return;
    }
    q -= static_cast<int>(here);
    start += g;
  }
  tile[0] = -2;
}

// dlhs: one cluster of two blocks per (expert, 128-row tile within its
// group, pair of 256-column tiles of K), or a tile of the zero tail;
// each block sums its 128 x 256 tile over N in 64-deep stages.  The two
// blocks share the tile's dout rows: each loads 64 of them a stage into
// both.  Warpgroup w (threads 128w ..) owns rows 64w .. 64w + 63; the
// last warp is the producer.  The sums go out by TMA (dlhs_map) through
// the ring once it is free, or from registers in a partial tile.  kMath
// false: the ring alone (the consumers wait and release, and neither
// multiply nor store), the floor probe.
template <bool kMath>
__global__ void __launch_bounds__(kTcThreads, 1)
    gmm_bwd_dlhs_wgmma(__grid_constant__ const CUtensorMap dout_map,
                       __grid_constant__ const CUtensorMap rhs_map,
                       __grid_constant__ const CUtensorMap dlhs_map,
                       Params p) {
  constexpr int STAGES = kDlhsStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tile[4];                  // expert, r0, r1, column pair
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * kTcStage;         // full[s]: +8s
  const uint32_t empty = full + STAGES * 8;               // empty[s]: +8s
  const int rank = static_cast<int>(cluster_rank());
  if (threadIdx.x == 0) {
    find_dlhs_tile(p, blockIdx.x / kCluster, tile);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                  // this block's producer
      mbar_init(empty + 8 * s, 8 * kCluster);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync();
  // both blocks of a cluster hold the same tile, so they leave together
  const int expert = tile[0], r0 = tile[1], rows = tile[2] - tile[1];
  if (expert == -2) return;
  const int k0 = (kCluster * tile[3] + rank) * kTcCols;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.dlhs);

  if (expert == -1) {                      // a tile of the zero tail
    for (int i = threadIdx.x; i < rows * kTcCols; i += kTcThreads) {
      const int c = k0 + i % kTcCols;
      if (c < p.K)
        out[static_cast<long long>(r0 + i / kTcCols) * p.K + c] =
            __float2bfloat16_rn(0.f);
    }
    return;
  }

  const int nk = (p.N + kTcBK - 1) / kTcBK;
  // a pair's second tile may lie past K: that block loads its half of A
  // for its partner and does nothing else
  const bool has_b = k0 < p.K;
  const bool second = r0 + kTcWarpgroupRows < p.T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kTcProducerWarp) {
    if (lane == 0) {
      // A: dout[r0 + 64 * rank ..] into both blocks (the second half only
      // where it starts before T); B: rhs[e][k0 : k0 + 256, n ..], 256
      // rows of K along N (K-major), through the forward's (n, k, e) map.
      // Past N, K and T, TMA fills zeros and counts their bytes.
      const uint32_t bytes =
          (1 + second) * kTcBoxBytes + (has_b ? kTcBBytes : 0);
      const bool mine = rank == 0 || second;
      Ring r;
      for (int i = 0; i < nk; ++i) {
        mbar_wait(empty + 8 * r.slot, r.parity ^ 1);
        const uint32_t a = ring + r.slot * kTcStage, bar = full + 8 * r.slot;
        mbar_expect_tx(bar, bytes);
        if (mine)
          tma_load_2d_all(a + rank * kTcBoxBytes, &dout_map, bar, i * kTcBK,
                          r0 + rank * kTcWarpgroupRows);
        if (has_b)
          tma_load_3d(a + kTcABytes, &rhs_map, bar, i * kTcBK, k0, expert);
        r.advance(STAGES);
      }
      producer_tail(empty, STAGES, r);
    }
    return;
  }

  const int wg = warp / 4;
  const bool live = kMath && has_b && wg * kTcWarpgroupRows < rows;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  Ring r;
  int prev = 0;
  for (int i = 0; i < nk; ++i) {
    mbar_wait(full + 8 * r.slot, r.parity);
    if (live) {
      const uint32_t a = ring + r.slot * kTcStage + wg * kTcBoxBytes;
      const uint32_t b = ring + r.slot * kTcStage + kTcABytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        // A: 64 rows of dout, 128 B along N; B: 256 rows of K, 128 B along
        // N (K-major); 16 contraction columns are 32 B further in both
        wgmma_m64n256k16<0, 0>(acc, smem_desc(a + kk * 32, 16, 1024),
                               smem_desc(b + kk * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();                     // the previous stage's products
      fence_acc(acc);
    }
    if (i > 0) release(empty + 8 * prev, lane);
    prev = r.slot;
    r.advance(STAGES);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release(empty + 8 * prev, lane);
  if (!kMath || !has_b) return;
  // both warpgroups' products are done, so the ring is free: a warpgroup
  // whose 64 rows are all the tile's stores them by TMA through its 32 KB
  // of the ring; one with fewer (a group's last tile) from registers,
  // masked, since the next rows are another tile's
  asm volatile("bar.sync 3, 256;" ::: "memory");
  const int row0 = wg * kTcWarpgroupRows;
  if (rows - row0 >= kTcWarpgroupRows) {
    store_tile<1, false>(&dlhs_map, ring + wg * kTcWarpgroupRows * kTcCols * 2,
                         wg, warp, lane, acc, k0, r0 + row0, 0, p.K);
    if (threadIdx.x % 128 == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  } else if (live) {
    store_acc(out + static_cast<long long>(r0 + row0) * p.K + k0, p.K,
              rows - row0, p.K - k0, warp, lane, acc);
  }
}

// A running walk of the groups for a sequence of experts that never
// decreases: seek(e) leaves `start` at group e's first row and returns its
// end, the group cut at row T.
struct GroupCursor {
  int e = 0, start = 0;
  __device__ __forceinline__ int seek(const Params& p, int to) {
    for (; e < to; ++e) start += min(max(p.gs[e], 0), p.T - start);
    return start + min(max(p.gs[to], 0), p.T - start);
  }
};

// drhs's rows of K a cluster: a 128-row tile a block.
constexpr int kDrhsSpan = kCluster * kTcRows;

// drhs's q-th tile of a cluster: experts slowest, then spans of
// kDrhsSpan rows of K, then 256-column tiles of N.
struct DrhsTile {
  int expert, k0, n0;                      // k0: this block's rows of K
  __device__ __forceinline__ DrhsTile(const Params& p, int q, int rank) {
    const int n_k = (p.K + kDrhsSpan - 1) / kDrhsSpan;
    const int n_n = (p.N + kTcCols - 1) / kTcCols;
    expert = q / (n_k * n_n);
    const int rest = q - expert * n_k * n_n;
    k0 = (rest / n_n) * kDrhsSpan + rank * kTcRows;
    n0 = (rest % n_n) * kTcCols;
  }
};

// drhs: a persistent grid of clusters of two blocks, each cluster walking
// tiles q = cluster, cluster + clusters, ... of (expert, pair of 128-row
// tiles of K, 256 columns of N), experts slowest, so that the clusters
// work on about one expert at a time and its lhs and dout rows (23 MB at
// jamba's gate/up shapes) are read again from L2.  Each block sums its
// 128 x 256 tile over the group's rows in 64-row stages from the group's
// first row; the two blocks share the tile's dout rows: each loads 128 of
// the 256 columns a stage into both.  The ring runs on across tiles, so
// the next tile's loads are in flight while this tile's sums are stored,
// and the stores (TMA, from staging) overlap the next tile's products.
// Warpgroup w owns K rows k0 + 64w ..; the last warp is the producer.
// kMath false: the ring alone, the floor probe.
template <bool kMath>
__global__ void __launch_bounds__(kTcThreads, 1)
    gmm_bwd_drhs_wgmma(__grid_constant__ const CUtensorMap lhs_map,
                       __grid_constant__ const CUtensorMap dout_map,
                       __grid_constant__ const CUtensorMap drhs_map,
                       Params p) {
  constexpr int STAGES = kDrhsStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t staging = ring + STAGES * kTcStage;
  const uint32_t full = staging + kDrhsStaging;           // full[s]: +8s
  const uint32_t empty = full + STAGES * 8;               // empty[s]: +8s
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  const int tiles = p.E * ((p.K + kDrhsSpan - 1) / kDrhsSpan) *
                    ((p.N + kTcCols - 1) / kTcCols);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8 * kCluster);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kTcProducerWarp) {
    if (lane == 0) {
      // A: lhs[t.., k0 ..] as two boxes of 64 columns of K (those that
      // start before K); B: dout[t.., n0 ..] as four boxes of 64 columns,
      // this block loading its share of them (those that start before N)
      // into every block of the cluster.  Past T, K and N, TMA fills
      // zeros.
      constexpr int kShare = kTcCols / kTcBox / kCluster;
      GroupCursor groups;
      Ring r;
      for (int q = cluster; q < tiles; q += clusters) {
        const DrhsTile t(p, q, rank);
        const int end = groups.seek(p, t.expert);
        const int start = groups.start;
        int boxes = 0;
#pragma unroll
        for (int j = 0; j < kTcRows / kTcBox; ++j)
          boxes += t.k0 + j * kTcBox < p.K;
#pragma unroll
        for (int j = 0; j < kTcCols / kTcBox; ++j)
          boxes += t.n0 + j * kTcBox < p.N;
        for (int row = start; row < end; row += kTcBK) {
          mbar_wait(empty + 8 * r.slot, r.parity ^ 1);
          const uint32_t a = ring + r.slot * kTcStage, bar = full + 8 * r.slot;
          mbar_expect_tx(bar, boxes * kTcBoxBytes);
#pragma unroll
          for (int j = 0; j < kTcRows / kTcBox; ++j)
            if (t.k0 + j * kTcBox < p.K)
              tma_load_2d(a + j * kTcBoxBytes, &lhs_map, bar, t.k0 + j * kTcBox,
                          row);
#pragma unroll
          for (int j = kShare * rank; j < kShare * (rank + 1); ++j)
            if (t.n0 + j * kTcBox < p.N)
              tma_load_2d_all(a + kTcABytes + j * kTcBoxBytes, &dout_map, bar,
                              t.n0 + j * kTcBox, row);
          r.advance(STAGES);
        }
      }
      producer_tail(empty, STAGES, r);
    }
    return;
  }

  const int wg = warp / 4;
  const uint32_t stg = staging + wg * (kDrhsStaging / 2);
  GroupCursor groups;
  Ring r;
  int prev = 0;
  for (int q = cluster; q < tiles; q += clusters) {
    const DrhsTile t(p, q, rank);
    const int end = groups.seek(p, t.expert);
    const int start = groups.start;
    const int row0 = t.k0 + wg * kTcWarpgroupRows;
    const bool live = kMath && row0 < p.K;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int i = 0;
    for (int row = start; row < end; row += kTcBK, ++i) {
      mbar_wait(full + 8 * r.slot, r.parity);
      if (live) {
        const uint32_t a = ring + r.slot * kTcStage + wg * kTcBoxBytes;
        const uint32_t b = ring + r.slot * kTcStage + kTcABytes;
        const int valid = end - row;
        if (valid < kTcBK) {
          // the group ends inside this stage: zero the warpgroup's A rows
          // past it (the next group's rows, which TMA loaded), whole
          // 128-byte rows, so the swizzle does not matter; then order
          // these generic stores before wgmma's reads (async proxy)
          for (int c = threadIdx.x % 128; c < (kTcBK - valid) * 8; c += 128)
            asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};"
                         ::"r"(a + valid * 128 + c * 16), "r"(0) : "memory");
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          named_sync(1 + wg);
        }
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcBK / 16; ++kk) {
          // A: 16 rows (of the group) of 128 B along K, MN-major; B: 16
          // rows of 128 B along N as four boxes kTcBoxBytes apart,
          // MN-major; 16 contraction rows are 2048 B further in both
          wgmma_m64n256k16<1, 1>(
              acc, smem_desc(a + kk * 16 * 128, kTcBoxBytes, 1024),
              smem_desc(b + kk * 16 * 128, kTcBoxBytes, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc);
      }
      if (i > 0) release(empty + 8 * prev, lane);
      prev = r.slot;
      r.advance(STAGES);
    }
    // unconditional: a wait on a path the compiler cannot prove makes it
    // serialise every wgmma of the kernel (ptxas C7518)
    wgmma_wait<0>();
    fence_acc(acc);
    if (i > 0) release(empty + 8 * prev, lane);
    if (kMath && row0 < p.K)                // zeros for an empty group
      store_tile<2, true>(&drhs_map, stg, wg, warp, lane, acc, t.n0, row0,
                          t.expert, p.N);
  }
  if (kMath && threadIdx.x % 128 == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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
  const cuuint32_t box[3] = {kTcBox, static_cast<cuuint32_t>(box_rows), 1};
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

// An (E, K, N) bfloat16 tensor's (n, k, e) map, 64 x box_rows x 1 boxes.
int encode_experts(CUtensorMap* map, const void* ptr, int E, int K, int N,
                   int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                 static_cast<cuuint64_t>(K) * N * 2};
  return encode(map, ptr, 3, dims, strides, box_rows);
}

// A launch of `blocks` blocks of kTcThreads in clusters of kCluster.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  ClusterLaunch(unsigned blocks, int smem, cudaStream_t s) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kTcThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <bool kMath>
cudaError_t launch_dlhs(const CUtensorMap& a, const CUtensorMap& b,
                        const CUtensorMap& c, const Params& p,
                        cudaStream_t s) {
  auto kernel = gmm_bwd_dlhs_wgmma<kMath>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDlhsSmem);
  if (err != cudaSuccess) return err;
  // an upper bound on the row tiles: each group's last one and the
  // tail's may be partial
  const long long blocks = static_cast<long long>(kCluster) *
                           ((p.T + kTcRows - 1) / kTcRows + p.E + 1) *
                           dlhs_pairs(p.K);
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  ClusterLaunch l(static_cast<unsigned>(blocks), kDlhsSmem, s);
  err = cudaLaunchKernelEx(&l.cfg, kernel, a, b, c, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The clusters of drhs (either variant) that fit on the device at once, or
// a negative cudaError_t; cached by device.
template <bool kMath>
int drhs_clusters(int device) {
  static int fit[64] = {};
  if (device >= 0 && device < 64 && fit[device] > 0) return fit[device];
  auto kernel = gmm_bwd_drhs_wgmma<kMath>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDrhsSmem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  ClusterLaunch l(kCluster, kDrhsSmem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &l.cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (n <= 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
  if (device >= 0 && device < 64) fit[device] = n;
  return n;
}

template <bool kMath>
cudaError_t launch_drhs(const CUtensorMap& a, const CUtensorMap& b,
                        const CUtensorMap& c, const Params& p, int device,
                        cudaStream_t s) {
  const int fit = drhs_clusters<kMath>(device);
  if (fit < 0) return static_cast<cudaError_t>(-fit);
  const long long tiles = static_cast<long long>(p.E) *
                          ((p.K + kDrhsSpan - 1) / kDrhsSpan) *
                          ((p.N + kTcCols - 1) / kTcCols);
  if (tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const long long clusters = tiles < fit ? tiles : fit;
  ClusterLaunch l(static_cast<unsigned>(kCluster * clusters), kDrhsSmem, s);
  cudaError_t err =
      cudaLaunchKernelEx(&l.cfg, gmm_bwd_drhs_wgmma<kMath>, a, b, c, p);
  if (err != cudaSuccess) return err;
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

template <bool kMath>
int launch_wgmma(int device, const Params& p, cudaStream_t s) {
  if (p.dlhs != nullptr) {
    CUtensorMap a, b, c;
    int res = encode_rows(&a, p.dout, p.T, p.N, kTcWarpgroupRows);
    if (res == 0) res = encode_experts(&b, p.rhs, p.E, p.K, p.N, kTcCols);
    if (res == 0) res = encode_rows(&c, p.dlhs, p.T, p.K, kTcWarpgroupRows);
    if (res != 0) return res;
    const cudaError_t err = launch_dlhs<kMath>(a, b, c, p, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.drhs != nullptr) {
    CUtensorMap a, b, c;
    int res = encode_rows(&a, p.lhs, p.T, p.K, kTcBK);
    if (res == 0) res = encode_rows(&b, p.dout, p.T, p.N, kTcBK);
    if (res == 0) res = encode_experts(&c, p.drhs, p.E, p.K, p.N, kTcBox);
    if (res != 0) return res;
    return static_cast<int>(launch_drhs<kMath>(a, b, c, p, device, s));
  }
  return 0;
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
// K and N multiples of 8, every tensor 16-byte aligned.  dlhs or drhs
// null: that gradient is not computed.  math = 0 launches the floor probe
// (the rings without the products; nothing is stored).  Returns 0, a
// cudaError_t, or kEncodeError + the CUresult of a refused tensor map.
int gmm_bwd_wgmma_launch(int device, int math, const void* dout,
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
  return math ? launch_wgmma<true>(device, p, s)
              : launch_wgmma<false>(device, p, s);
}

// The clusters of drhs's persistent grid: as many as fit on
// the device at once (cudaOccupancyMaxActiveClusters), or a negative
// cudaError_t.
int gmm_bwd_drhs_clusters(int device) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return -static_cast<int>(scope.err);
  return drhs_clusters<true>(device);
}

const char* gmm_bwd_error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
