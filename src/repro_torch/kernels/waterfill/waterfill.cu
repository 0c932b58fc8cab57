// Hopper water-fill: the chunked greedy cohort -> worker allocation of
// negotiation, one problem per thread block.
//
// Replaces the Pallas TPU kernel `waterfill_pallas` / `_waterfill_kernel`
// (src/repro/kernels/waterfill/kernel.py) of the JAX package, and the
// cycle and candidate scans the JAX matchmaker wraps around the same step
// (`_build_cycles_scan`, `_build_preview_scan` in
// src/repro/core/matchmaker/jax_backend.py).  The plain PyTorch versions
// it is held against are `ref.py::waterfill_reference` and its cycle and
// candidate loops.
//
// What it computes, per cohort c in processing order (rows of the
// padded, order-permuted arrays), with `free` the (R, Wp) carry:
//
//   d     = min(demand[c], left)
//   fits  = max(floor(min_r(free_r / safe_r + big_r) + FIT_EPS), 0)
//   fits  = min(fits, d) * compat[c]
//   take  = clip(d - exclusive_scan(fits), 0, fits)      (worker order)
//   free -= want[c] * take ;  left -= sum(take)
//
// and per chunk of 64 cohorts a drain guard: the chunk is skipped
// (takes stay zero, ran = 0) when left <= 0 or no worker has
// free_r >= chunk_min_r * (1 - 2 FIT_EPS) for every r whose chunk minimum
// is positive -- provably no cohort of the chunk fits anywhere then, so
// skipping is claim-exact (see `next_alive` on the zero minima).
//
// What bounds it on this card: not bytes (a few MB at most: the u8
// compat mask in, the i32 takes out) and not arithmetic, but the serial
// dependency: cohort c+1 reads the free matrix cohort c left behind, so
// the C cohorts of a cycle are C dependent block-wide scans, each a
// chain of shared-memory reads, R divides, two shuffle scans and a
// barrier.  Two instances:
//
// "staged" (`staged_kernel`, every R = 6 problem up to 8,192 lanes) keeps
// that chain free of device memory:
//
//   * tiles staged ahead: a tile is `sub` cohorts' want, safe, big and
//     1/safe rows and their u8 compat rows (sub = 64, a whole chunk,
//     where two such stages fit in shared memory, else 32 ... 2), each
//     array one contiguous 1-D bulk async copy (cp.async.bulk) that
//     completes on the stage's mbarrier.  Thread 0 issues tile n+1 into
//     the other stage of a two-stage ring while tile n runs, across
//     chunk and cycle boundaries (the first tile of the next chunk is
//     fetched on speculation and dropped if the guard skips that chunk);
//     each warp releases a stage on its empty mbarrier.  A cohort step
//     reads only shared memory and registers;
//   * the free carry in registers: thread t owns the L contiguous lanes
//     w = t*L + k (L = 1, 2, 4, 8, 16 by width, at most 512 threads),
//     prefix-sums its own lanes in worker order (whole numbers in 32 bits,
//     saturating at d), and one block scan over thread totals does the
//     rest: one barrier per cohort at every width.  Where the register file
//     cannot hold R*Wp values beside the thread's working set (float64
//     above 2,048 lanes, float32 above 4,096: 8,192 lanes of float64 are
//     393 KB against 256 KB of registers), RREG of the R resources stay
//     in registers and the rest in shared memory, still private to the
//     thread, so they cost no barrier either (float64 above 6,144 lanes
//     keeps 3 in registers at 512 threads: ptxas spills part of them);
//   * fits by a multiply: m = min_r(free_r * (1/safe_r) + big_r) decides
//     floor(m + FIT_EPS) unless an interval of a few ulps around m
//     (wider than the worst error of the product, 3 ulp) straddles an
//     integer boundary that survives the clip to [0, d); only those
//     lanes divide (`lane_fits`).  The result is exactly the divide's.
//     The divide probe (the same step with no divide at all) put the
//     divides at 40-78 % of the step's device time on the H100 (PERF.md,
//     PR 18), hence the multiply;
//   * no memset: every cohort of a chunk that ran stores its whole takes
//     row, zeros included, as coalesced int32 vectors, the n-th chunk
//     that ran (over all cycles) into the n-th 64-row slot, and a chunk
//     the guard skips writes no row (it takes nothing); one call is one
//     launch;
//   * the same kernel runs K cycles in one launch (live demand and the
//     chunk minima recomputed on the device each cycle, a free snapshot
//     and the per-cohort totals written per cycle) and N independent
//     candidates in one launch (a block each, totals only).
//
// "rounds" (`waterfill_kernel`, PR 11's kernel, kept for what "staged"
// does not take): lanes w = base + threadIdx.x in rounds of 1024, the
// carry in shared memory when R*Wp values fit, else in device memory,
// one barrier per round, the takes zeroed by a memset first.
//
// Exactness: fits, takes and their sums are integer-valued, so the scan
// is exact in any order.  Every rounding step uses an explicit
// round-to-nearest intrinsic (IEEE divide, no fused multiply-subtract;
// the file is also built with --fmad=false), so float64 results are
// bit-identical to the plain version and to the NumPy backend.  Against
// the JAX backend they are bitwise on integer-valued problems and within
// atol 1e-7 on fractional ones: XLA:CPU contracts free - want * take into
// one fused multiply-add under jit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double floor_t(double a) { return floor(a); }
__device__ __forceinline__ float floor_t(float a) { return floorf(a); }
__device__ __forceinline__ int to_int(double a) { return __double2int_rn(a); }
__device__ __forceinline__ int to_int(float a) { return __float2int_rn(a); }

template <typename T>
__device__ __forceinline__ T min_t(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T max_t(T a, T b) { return a < b ? b : a; }

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
waterfill_kernel(const T* __restrict__ freeT_in,     // (R, Wp)
                 T left,                             // claim budget
                 const T* __restrict__ want,         // (Cp, R)
                 const T* __restrict__ safe,         // (Cp, R)
                 const T* __restrict__ big,          // (Cp, R)
                 const T* __restrict__ demand,       // (Cp,)
                 const uint8_t* __restrict__ crow,   // (Cp, Wp)
                 const T* __restrict__ chunk_min,    // (nch, R)
                 int32_t* __restrict__ takes,        // (Cp, Wp), pre-zeroed
                 int32_t* __restrict__ ran,          // (nch,)
                 T* __restrict__ free_out,           // (R, Wp)
                 int R, int Wp, int nch, int chunk, int free_in_smem,
                 double fit_eps) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ T warp_tot[2][kWarp];
  T* fs = free_in_smem ? reinterpret_cast<T*>(smem_raw) : free_out;

  const int B = blockDim.x;                 // a multiple of 32
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int nwarps = B / kWarp;
  const T zero = T(0);
  const T eps = T(fit_eps);
  const T slack = T(1.0 - 2.0 * fit_eps);

  // every thread reads and writes only its own lanes w = tid + k*B of
  // the carry, from this copy on: fs needs no barrier
  for (int w = tid; w < Wp; w += B)
    for (int r = 0; r < R; ++r) fs[r * Wp + w] = freeT_in[r * Wp + w];

  int parity = 0;
  for (int ch = 0; ch < nch; ++ch) {
    // drain guard: does any worker clear the chunk's minimum request?
    int ok = 0;
    for (int w = tid; w < Wp && !ok; w += B) {
      int all = 1;
      for (int r = 0; r < R; ++r) {
        // a zero minimum bounds nothing (see `next_alive`)
        const T cm = chunk_min[ch * R + r];
        all &= !(cm > zero) || fs[r * Wp + w] >= mul_rn(cm, slack);
      }
      ok = all;
    }
    const bool alive = __syncthreads_or(ok) && left > zero;
    if (tid == 0) ran[ch] = alive ? 1 : 0;
    if (!alive) continue;

    for (int c = ch * chunk; c < (ch + 1) * chunk; ++c) {
      const T d = min_t(demand[c], left);
      // pad cohorts, cohorts masked out by `active` and every cohort after
      // the budget ran out take nothing; d is block-uniform, so the whole
      // block skips together and no barrier is split
      if (d == zero) continue;
      const T* want_c = want + c * R;
      const T* safe_c = safe + c * R;
      const T* big_c = big + c * R;
      T carry = zero;                       // sum of fits of earlier rounds
      for (int base = 0; base < Wp; base += B) {
        const int w = base + tid;
        T f = zero;
        if (w < Wp) {
          T m = add_rn(div_rn(fs[w], safe_c[0]), big_c[0]);
          for (int r = 1; r < R; ++r)
            m = min_t(m, add_rn(div_rn(fs[r * Wp + w], safe_c[r]), big_c[r]));
          f = max_t(floor_t(add_rn(m, eps)), zero);
          f = crow[static_cast<size_t>(c) * Wp + w] ? min_t(f, d) : zero;
        }
        // block-wide inclusive scan of f (exact: integer values)
        T incl = f;
#pragma unroll
        for (int o = 1; o < kWarp; o <<= 1) {
          const T y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl = add_rn(incl, y);
        }
        if (lane == kWarp - 1) warp_tot[parity][warp] = incl;
        __syncthreads();
        const T wt = lane < nwarps ? warp_tot[parity][lane] : zero;
        T wincl = wt;
#pragma unroll
        for (int o = 1; o < kWarp; o <<= 1) {
          const T y = __shfl_up_sync(kFull, wincl, o);
          if (lane >= o) wincl = add_rn(wincl, y);
        }
        const T before = __shfl_sync(kFull, sub_rn(wincl, wt), warp);
        const T total = __shfl_sync(kFull, wincl, kWarp - 1);
        parity ^= 1;

        if (w < Wp) {
          const T excl = add_rn(add_rn(carry, before), sub_rn(incl, f));
          const T take = min_t(max_t(sub_rn(d, excl), zero), f);
          if (take != zero) {
            takes[static_cast<size_t>(c) * Wp + w] = to_int(take);
            for (int r = 0; r < R; ++r)
              fs[r * Wp + w] = sub_rn(fs[r * Wp + w], mul_rn(want_c[r], take));
          }
        }
        carry = add_rn(carry, total);
      }
      left = sub_rn(left, min_t(d, carry));
    }
  }

  if (free_in_smem)
    for (int w = tid; w < Wp; w += B)
      for (int r = 0; r < R; ++r) free_out[r * Wp + w] = fs[r * Wp + w];
}

// Measurement probe, not part of the water-fill: `steps` rounds of the
// kernel's cohort-step skeleton alone -- the two shuffle scans and the one
// __syncthreads per round, each round's input depending on the last
// round's total -- at a given block size.  Its time is the floor that the
// serial chain of cohort steps puts under the water-fill at that shape.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
step_floor_kernel(int steps, T* __restrict__ out) {
  __shared__ T warp_tot[2][kWarp];
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const T zero = T(0);
  T f = T(tid & 1);
  int parity = 0;
  for (int s = 0; s < steps; ++s) {
    T incl = f;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const T y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = add_rn(incl, y);
    }
    if (lane == kWarp - 1) warp_tot[parity][warp] = incl;
    __syncthreads();
    const T wt = lane < nwarps ? warp_tot[parity][lane] : zero;
    T wincl = wt;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const T y = __shfl_up_sync(kFull, wincl, o);
      if (lane >= o) wincl = add_rn(wincl, y);
    }
    const T before = __shfl_sync(kFull, sub_rn(wincl, wt), warp);
    const T total = __shfl_sync(kFull, wincl, kWarp - 1);
    parity ^= 1;
    f = min_t(sub_rn(total, add_rn(before, incl)), T(1));
  }
  if (tid == 0) out[0] = f;
}

// Lets the kernel's dynamic shared memory grow to what its static shared
// memory leaves of the block's opt-in limit `max_smem`.
template <typename T>
cudaError_t init(int max_smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, waterfill_kernel<T>);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      waterfill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      max_smem - static_cast<int>(attr.sharedSizeBytes));
}

template <typename T>
cudaError_t launch(const void* freeT, double left, const void* want,
                   const void* safe, const void* big, const void* demand,
                   const void* crow, const void* chunk_min, void* takes,
                   void* ran, void* free_out, int R, int Wp, int nch,
                   int chunk, int free_in_smem, double fit_eps,
                   cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(nch) * chunk * Wp;
  cudaError_t err = cudaMemsetAsync(takes, 0, cells * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  const int threads = Wp < kMaxThreads ? Wp : kMaxThreads;
  const size_t smem = free_in_smem ? static_cast<size_t>(R) * Wp * sizeof(T) : 0;
  waterfill_kernel<T><<<1, threads, smem, stream>>>(
      static_cast<const T*>(freeT), static_cast<T>(left),
      static_cast<const T*>(want), static_cast<const T*>(safe),
      static_cast<const T*>(big), static_cast<const T*>(demand),
      static_cast<const uint8_t*>(crow), static_cast<const T*>(chunk_min),
      static_cast<int32_t*>(takes), static_cast<int32_t*>(ran),
      static_cast<T*>(free_out), R, Wp, nch, chunk, free_in_smem, fit_eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The staged instance
// ---------------------------------------------------------------------------

constexpr int kR = 6;            // resources, a compile-time width
constexpr int kChunk = 64;       // cohorts per drain-guard chunk
// shared-memory layout ahead of the carry and the stages (bytes):
// mbarriers full[2], empty[2] at 0; mask words [3] at 32; warp totals
// [2][32] at 64; the chunk's demand [64] at 576; carry from 1088
constexpr int kMaskOff = 32, kWarpTotOff = 64, kDemandOff = 576;
constexpr int kMaxWarps = 16;    // every staged instance runs <= 512 threads
constexpr int kCarryOff = 1088;

enum Mode { kSingle = 0, kCycles = 1, kPreview = 2 };
enum Fit { kFitDivide = 0, kFitReciprocal = 1, kFitProbe = 2 };

// The margin of the reciprocal test: |free*RN(1/safe) - RN(free/safe)|
// is at most 3 units of 2^-53 (2^-24) relative, and at most a few
// subnormal steps absolute; rel and abs are 4x and far above those.
template <typename T> struct Margin;
template <> struct Margin<double> {
  static __device__ __forceinline__ double rel() { return 0x1p-49; }
  static __device__ __forceinline__ double tiny() { return 0x1p-1000; }
  static __device__ __forceinline__ double top() {
    return 0x1.fffffffffffffp+1023;
  }
};
template <> struct Margin<float> {
  static __device__ __forceinline__ float rel() { return 0x1p-20f; }
  static __device__ __forceinline__ float tiny() { return 0x1p-120f; }
  static __device__ __forceinline__ float top() { return 0x1.fffffep+127f; }
};

// the least of R = 6 values, as a tree: three dependent steps, not five
template <typename T>
__device__ __forceinline__ T min6(const T* e) {
  return min_t(min_t(min_t(e[0], e[1]), min_t(e[2], e[3])),
               min_t(e[4], e[5]));
}

__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

// Waits for the phase of `bar` with this parity.  A wait that outlasts
// about ten seconds can only be a fault in the ring: it traps (the launch
// fails with an error) rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 20000000000ll) __trap();
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

__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(bar) : "memory");
}

template <typename T>
struct StagedParams {
  const T* free_in;          // (R, Wp); preview (N, R, Wp)
  const T* want;             // (Cp, R)
  const T* safe;             // (Cp, R)
  const T* big;              // (Cp, R)
  const T* inv;              // (Cp, R) 1/safe, NaN: divide (staged always)
  const uint8_t* crow;       // (Cp, Wp)
  const T* demand;           // (Cp,); preview (N, Cp)
  const T* chunk_min;        // (nch, R), or null: from the live demand
  const T* arrivals;         // cycles: (K, Cp)
  const T* free_add;         // cycles: (K, R, Wp)
  const uint8_t* add_free;   // cycles: (K,) 1 = add free_add[k]
  const T* budgets;          // cycles: (K,)
  int32_t* takes;            // (K*nch, 64, Wp): the n-th chunk that ran
                             // at [n]; null in preview
  uint8_t* ran;              // (K, nch); null in preview
  int32_t* totals;           // (K, Cp); preview (N, Cp)
  T* free_out;               // (K, R, Wp); null in preview
  T* scratch;                // cycles: live demand (Cp) + minima (nch, R);
                             // preview: minima (N, nch, R)
  T left0;                   // single: the claim budget
  T eps, slack;              // FIT_EPS, 1 - 2 FIT_EPS
  int mode, fit, K, Wp, nch, sub;
};

// Thread t's free carry: lanes w = t*L + k, resources r < RREG in
// registers, the rest in shared memory at a stride that keeps a warp's
// accesses on distinct banks.  Every index is a constant once the
// callers' loops are unrolled, so `reg` stays in registers.
template <typename T, int L, int RREG>
struct Carry {
  T reg[kR][L];
  T* sm;
  int stride, tid;
  __device__ __forceinline__ T get(int r, int k) const {
    return r < RREG ? reg[r][k] : sm[((r - RREG) * L + k) * stride + tid];
  }
  __device__ __forceinline__ void set(int r, int k, T v) {
    if (r < RREG) reg[r][k] = v;
    else sm[((r - RREG) * L + k) * stride + tid] = v;
  }
};

// fits of lane k against one cohort's rows (in shared memory), clipped to
// [0, d]; the caller applies compat.  kFitReciprocal returns exactly what
// kFitDivide does: the interval [m - delta, m + delta] holds the divide's
// m (the product is within 3 ulps of the quotient, and a min moves no
// further than its arguments), floor(RN(x + eps)) is monotone in x, so
// equal clipped floors at both ends are the answer; where they differ,
// or a product is not finite (1/safe is NaN outside the range the bound
// covers), the lane divides.  kFitProbe takes the product's answer
// unchecked: a measurement aid.  ref.py's `reciprocal_fits` mirrors it.
template <typename T, class C>
__device__ __forceinline__ T lane_fits(const C& carry, int k, const T* sv,
                                       const T* bv, const T* iv, T d,
                                       int fit, T eps) {
  const T zero = T(0);
  T e[kR];
  if (fit != kFitDivide) {
    bool bad = false;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const T q = mul_rn(carry.get(r, k), iv[r]);
      bad |= !(abs_t(q) <= Margin<T>::top());
      e[r] = add_rn(q, bv[r]);
    }
    const T m = min6(e);
    if (fit == kFitProbe)
      return min_t(max_t(floor_t(add_rn(m, eps)), zero), d);
    const T delta =
        add_rn(mul_rn(abs_t(m), Margin<T>::rel()), Margin<T>::tiny());
    const T lo = min_t(max_t(floor_t(add_rn(sub_rn(m, delta), eps)), zero), d);
    const T hi = min_t(max_t(floor_t(add_rn(add_rn(m, delta), eps)), zero), d);
    if (!bad && lo == hi) return lo;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r)
    e[r] = add_rn(div_rn(carry.get(r, k), sv[r]), bv[r]);
  return min_t(max_t(floor_t(add_rn(min6(e), eps)), zero), d);
}

// lane_fits where lane k's compat byte (of the thread's packed bytes cb)
// is set, else 0
template <typename T, class C>
__device__ __forceinline__ T masked_fits(const C& carry, int k,
                                         const uint32_t* cb, const T* sv,
                                         const T* bv, const T* iv, T d,
                                         int fit, T eps) {
  return (cb[k / 4] >> (8 * (k % 4))) & 0xffu
             ? lane_fits(carry, k, sv, bv, iv, d, fit, eps) : T(0);
}

// free -= want * take on lane k (nothing to do when it takes nothing)
template <typename T, class C>
__device__ __forceinline__ void take_from(C& carry, int k, const T* want,
                                          T take) {
  if (take != T(0))
#pragma unroll
    for (int r = 0; r < kR; ++r)
      carry.set(r, k, sub_rn(carry.get(r, k), mul_rn(want[r], take)));
}

template <int L> struct Lanes;
template <> struct Lanes<1> {
  static __device__ __forceinline__ void compat(const uint8_t* p,
                                                uint32_t* b) {
    b[0] = *p;
  }
  static __device__ __forceinline__ void store(int32_t* p,
                                               const uint32_t* v) {
    p[0] = static_cast<int32_t>(v[0]);
  }
};
template <> struct Lanes<2> {
  static __device__ __forceinline__ void compat(const uint8_t* p,
                                                uint32_t* b) {
    b[0] = *reinterpret_cast<const uint16_t*>(p);
  }
  static __device__ __forceinline__ void store(int32_t* p,
                                               const uint32_t* v) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  }
};
template <> struct Lanes<4> {
  static __device__ __forceinline__ void compat(const uint8_t* p,
                                                uint32_t* b) {
    b[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ void store(int32_t* p,
                                               const uint32_t* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Lanes<8> {
  static __device__ __forceinline__ void compat(const uint8_t* p,
                                                uint32_t* b) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    b[0] = v.x;
    b[1] = v.y;
  }
  static __device__ __forceinline__ void store(int32_t* p,
                                               const uint32_t* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint4*>(p + 4) = make_uint4(v[4], v[5], v[6], v[7]);
  }
};
template <> struct Lanes<16> {
  static __device__ __forceinline__ void compat(const uint8_t* p,
                                                uint32_t* b) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    b[0] = v.x;
    b[1] = v.y;
    b[2] = v.z;
    b[3] = v.w;
  }
  static __device__ __forceinline__ void store(int32_t* p,
                                               const uint32_t* v) {
#pragma unroll
    for (int i = 0; i < 16; i += 4)
      *reinterpret_cast<uint4*>(p + i) =
          make_uint4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
};

// The two-stage tile ring.  Every thread tracks it alike (its decisions
// are block-uniform); thread 0 issues the copies, every thread waits on a
// stage's full mbarrier, and each warp releases a stage on its empty
// mbarrier.  Tile `id` = chunk * tiles + t holds cohorts chunk * 64 +
// t * sub onwards; the n-th tile issued lives in stage n % 2.
struct Ring {
  int head, tail;                           // tiles issued / consumed
  int tail_id, next_id;                     // the pending tiles' ids
};

template <typename T>
__device__ __forceinline__ void ring_issue(Ring& q, int id,
                                           const StagedParams<T>& p,
                                           unsigned char* stage0,
                                           uint32_t full, uint32_t empty,
                                           int stage_bytes, int tid) {
  const int n = q.head, s = n & 1;
  if (tid == 0) {
    // the stage's last tile, n - 2, must be released by every warp
    if (n >= 2) mbar_wait(empty + 8 * s, ((n >> 1) & 1) ^ 1);
    const int tiles = kChunk / p.sub, ch = id / tiles;
    const int c0 = ch * kChunk + (id - ch * tiles) * p.sub;
    const uint32_t rows = p.sub * kR * sizeof(T);
    const uint32_t dst = smem_addr(stage0 + s * stage_bytes);
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, stage_bytes);
    bulk_g2s(dst, p.want + c0 * kR, rows, bar);
    bulk_g2s(dst + rows, p.safe + c0 * kR, rows, bar);
    bulk_g2s(dst + 2 * rows, p.big + c0 * kR, rows, bar);
    bulk_g2s(dst + 3 * rows, p.inv + c0 * kR, rows, bar);
    bulk_g2s(dst + 4 * rows, p.crow + static_cast<size_t>(c0) * p.Wp,
             p.sub * p.Wp, bar);
  }
  if (n == q.tail) q.tail_id = id;
  else q.next_id = id;
  q.head = n + 1;
}

__device__ __forceinline__ void ring_wait(const Ring& q, uint32_t full) {
  mbar_wait(full + 8 * (q.tail & 1), (q.tail >> 1) & 1);
}

__device__ __forceinline__ void ring_release(Ring& q, uint32_t empty,
                                             int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + 8 * (q.tail & 1));
  ++q.tail;
  q.tail_id = q.next_id;
}

__device__ __forceinline__ void ring_drop(Ring& q, uint32_t full,
                                          uint32_t empty, int lane) {
  while (q.head > q.tail) {
    ring_wait(q, full);
    ring_release(q, empty, lane);
  }
}

// The drain guard over up to 32 chunks a barrier: the first chunk from
// `ch` on for which some worker lane has free_r >= cmin_r * slack for
// every r whose chunk minimum is positive, or nch; none once left <= 0.
// A lane that fails it has some r with free_r below every live cohort's
// positive request, so it fits none of them.  (A zero minimum means some
// live cohort asks nothing of r and bounds nothing: a free_r a rounding
// below 0 must not retire the lane -- the JAX package's guard does, and
// then skips claims the NumPy backend makes.)  Chunks it passes over
// change nothing, so testing them against one carry is exact.  Thread
// totals meet in mask word round % 3; the word after it was last read
// before the previous round's barrier, so thread 0 clears it here.
template <typename T, int L, int RREG>
__device__ __forceinline__ int next_alive(const Carry<T, L, RREG>& carry,
                                          int ch, const T* cmin, T left,
                                          T slack, int nch, bool mine,
                                          uint32_t* masks, int& round,
                                          int tid, int lane) {
  while (ch < nch && left > T(0)) {
    const int n = min(32, nch - ch);
    uint32_t ok = 0u;
    for (int i = 0; i < n; ++i) {
      T thr[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const T cm = cmin[(ch + i) * kR + r];
        thr[r] = cm > T(0) ? mul_rn(cm, slack) : -T(INFINITY);
      }
      bool any = false;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        bool all = mine;
#pragma unroll
        for (int r = 0; r < kR; ++r) all &= carry.get(r, k) >= thr[r];
        any |= all;
      }
      ok |= static_cast<uint32_t>(any) << i;
    }
    ok = __reduce_or_sync(kFull, ok);
    volatile uint32_t* word = masks + round % 3;
    if (tid == 0) masks[(round + 1) % 3] = 0u;
    if (lane == 0 && ok) atomicOr(masks + round % 3, ok);
    __syncthreads();
    const uint32_t alive = *word;
    ++round;
    if (alive) return ch + __ffs(alive) - 1;
    ch += n;
  }
  return nch;
}

// The block-wide exclusive prefix of the thread totals `run`, in worker
// order, and their sum: warps scan by shuffles, warp totals meet in
// shared memory (the cohort's one barrier) and every thread adds those
// of the warps before its own.  Sums saturate at `cap` (Sat: uint32
// sums of whole numbers below 2^31, exact wherever a prefix is below the
// cap, and a prefix at the cap takes nothing) or are plain (Exact: T).
struct Sat {
  uint32_t cap;
  __device__ __forceinline__ uint32_t operator()(uint32_t a,
                                                 uint32_t b) const {
    const uint32_t s = a + b;
    return s < cap ? s : cap;
  }
};
template <typename T>
struct Exact {
  __device__ __forceinline__ T operator()(T a, T b) const {
    return add_rn(a, b);
  }
};

template <typename V, class Op>
__device__ __forceinline__ V block_prefix(V run, Op op, V* wtot, int parity,
                                          int lane, int warp, int nwarps,
                                          V& total) {
  V incl = run;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const V y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = op(incl, y);
  }
  V ex = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) ex = V(0);
  if (lane == kWarp - 1) wtot[parity * kWarp + warp] = incl;
  __syncthreads();
  V before = V(0), sum = V(0);
#pragma unroll
  for (int i = 0; i < kMaxWarps; ++i) {
    if (i < nwarps) {
      if (i == warp) before = sum;
      sum = op(sum, wtot[parity * kWarp + i]);
    }
  }
  total = sum;
  return op(before, ex);
}

template <typename T, int L, int RREG, int NT>
__global__ void __launch_bounds__(NT, 1)
staged_kernel(const StagedParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = blockDim.x;                 // a multiple of 32
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int nwarps = B / kWarp;
  const int Wp = p.Wp, nch = p.nch, Cp = nch * kChunk, sub = p.sub;
  const int tiles = kChunk / sub;
  const int w0 = tid * L;                   // this thread's first lane
  const bool mine = w0 < Wp;                // Wp % L == 0: all or none
  const T zero = T(0);

  const uint32_t full = smem_addr(smem), empty = full + 16;
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + kMaskOff);
  unsigned char* wtot = smem + kWarpTotOff;
  T* dem = reinterpret_cast<T*>(smem + kDemandOff);
  const int rows = sub * kR * static_cast<int>(sizeof(T));
  const int stage_bytes = 4 * rows + sub * Wp;
  unsigned char* stage0 =
      smem + kCarryOff + (kR - RREG) * L * B * static_cast<int>(sizeof(T));

  // one candidate per block in preview
  const T* free_in = p.free_in;
  const T* demand = p.demand;
  int32_t* totals = p.totals;
  T* mins = p.scratch;
  if (p.mode == kPreview) {
    free_in += static_cast<size_t>(blockIdx.x) * kR * Wp;
    demand += static_cast<size_t>(blockIdx.x) * Cp;
    totals += static_cast<size_t>(blockIdx.x) * Cp;
    mins += static_cast<size_t>(blockIdx.x) * nch * kR;
  } else if (p.mode == kCycles) {
    mins += Cp;                             // after the live demand
  }

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + 8 * s, 1);           // thread 0's expect_tx
      mbar_init(empty + 8 * s, nwarps);     // one arrival per warp
    }
    masks[0] = masks[1] = masks[2] = 0u;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  Carry<T, L, RREG> carry;
  carry.sm = reinterpret_cast<T*>(smem + kCarryOff);
  carry.stride = B;
  carry.tid = tid;
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int k = 0; k < L; ++k)
      carry.set(r, k, mine ? free_in[r * Wp + w0 + k] : zero);
  __syncthreads();

  Ring q{0, 0, -1, -1};
  int round = 0;                            // drain-guard mask round
  int parity = 0;                           // warp-total buffer
  int slot = 0;                             // chunks run so far
  for (int kc = 0; kc < p.K; ++kc) {
    const T* D = demand;                    // this cycle's demand
    T* live = nullptr;
    if (p.mode == kCycles) {
      live = p.scratch;
      __syncthreads();                      // last cycle's demand writes
      for (int c = tid; c < Cp; c += B)
        live[c] = add_rn(kc == 0 ? demand[c] : live[c],
                         p.arrivals[static_cast<size_t>(kc) * Cp + c]);
      if (p.add_free[kc] && mine) {
        const T* fa = p.free_add + static_cast<size_t>(kc) * kR * Wp;
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int k = 0; k < L; ++k)
            carry.set(r, k, add_rn(carry.get(r, k), fa[r * Wp + w0 + k]));
      }
      D = live;
    }
    const T* cmin = p.chunk_min;
    if (cmin == nullptr) {
      // the drain guard's per-chunk minimum request over the cohorts
      // that still demand (inf where none does)
      __syncthreads();
      for (int i = tid; i < nch * kR; i += B) {
        const int ch = i / kR, r = i - ch * kR;
        T m = T(INFINITY);
        for (int j = 0; j < kChunk; ++j) {
          const int c = ch * kChunk + j;
          if (D[c] > zero) m = min_t(m, p.want[c * kR + r]);
        }
        mins[i] = m;
      }
      __syncthreads();
      cmin = mins;
    }
    T left = p.mode == kCycles ? p.budgets[kc] : p.left0;
    uint8_t* ran = p.ran ? p.ran + kc * nch : nullptr;
    int32_t* tot = p.mode == kPreview
                       ? totals : totals + static_cast<size_t>(kc) * Cp;

    // chunks [a, b) skipped: ran 0, totals 0, no takes rows
    auto skip = [&](int a, int b) {
      if (a >= b) return;
      for (int i = tid; i < (b - a) * kChunk; i += B) tot[a * kChunk + i] = 0;
      if (ran)
        for (int i = tid; i < b - a; i += B) ran[a + i] = 0;
    };

    int ch = next_alive(carry, 0, cmin, left, p.slack, nch, mine, masks,
                        round, tid, lane);
    skip(0, ch);
    while (ch < nch) {
      if (ran && tid == 0) ran[ch] = 1;
      for (int i = tid; i < kChunk; i += B) dem[i] = D[ch * kChunk + i];
      __syncthreads();
      int32_t* rows_out = nullptr;          // this chunk's 64 takes rows
      if (p.takes)
        rows_out = p.takes + static_cast<size_t>(slot) * kChunk * Wp;
      ++slot;
      for (int t = 0; t < tiles; ++t) {
        const int id = ch * tiles + t;
        if (!(q.head > q.tail && q.tail_id == id)) {
          ring_drop(q, full, empty, lane);  // a speculated tile
          ring_issue(q, id, p, stage0, full, empty, stage_bytes, tid);
        }
        // the next tile: within the chunk, the next chunk's first (on
        // speculation), or the next cycle's first
        if (q.head - q.tail < 2) {
          if (t + 1 < tiles || ch + 1 < nch)
            ring_issue(q, id + 1, p, stage0, full, empty, stage_bytes, tid);
          else if (kc + 1 < p.K)
            ring_issue(q, 0, p, stage0, full, empty, stage_bytes, tid);
        }
        ring_wait(q, full);
        const unsigned char* st = stage0 + (q.tail & 1) * stage_bytes;
        const T* wv = reinterpret_cast<const T*>(st);
        const T* sv = wv + sub * kR;
        const T* bv = sv + sub * kR;
        const T* iv = bv + sub * kR;
        const uint8_t* cv = st + 4 * rows;
        for (int j = 0; j < sub; ++j) {
          const int cj = t * sub + j;       // the cohort within the chunk
          const int c = ch * kChunk + cj;
          const T dc = dem[cj];
          const T d = min_t(dc, left);
          int32_t* trow = rows_out ? rows_out + cj * Wp + w0 : nullptr;
          uint32_t tk[L];
          // pad cohorts, cohorts masked out and every cohort after the
          // budget ran out take nothing; d is block-uniform, so the block
          // skips together and no barrier is split
          if (d == zero) {
#pragma unroll
            for (int k = 0; k < L; ++k) tk[k] = 0u;
            if (trow && mine) Lanes<L>::store(trow, tk);
            if (tid == 0) tot[c] = 0;
            continue;
          }
          uint32_t cb[(L + 3) / 4] = {};
          if (mine) Lanes<L>::compat(cv + j * Wp + w0, cb);
          const T* want = wv + j * kR;
          T taken;
          if (d < T(2147483647)) {
            // fits <= d < 2^31: whole numbers in 32 bits, summed
            // saturating at d
            const Sat sat{static_cast<uint32_t>(to_int(d))};
            uint32_t fu[L];
            uint32_t run = 0u;
#pragma unroll
            for (int k = 0; k < L; ++k) {
              fu[k] = static_cast<uint32_t>(to_int(masked_fits(
                  carry, k, cb, sv + j * kR, bv + j * kR, iv + j * kR, d,
                  p.fit, p.eps)));
              run = sat(run, fu[k]);
            }
            uint32_t total;
            uint32_t ex = block_prefix(run, sat,
                                       reinterpret_cast<uint32_t*>(wtot),
                                       parity, lane, warp, nwarps, total);
#pragma unroll
            for (int k = 0; k < L; ++k) {
              const uint32_t room = ex >= sat.cap ? 0u : sat.cap - ex;
              tk[k] = room < fu[k] ? room : fu[k];
              ex = sat(ex, fu[k]);
              take_from(carry, k, want, T(tk[k]));
            }
            taken = T(total);
          } else {
            // d of 2^31 or more: exact sums in T, and each lane's fits
            // computed again after the barrier rather than held across it
            T run = zero;
#pragma unroll
            for (int k = 0; k < L; ++k)
              run = add_rn(run, masked_fits(carry, k, cb, sv + j * kR,
                                            bv + j * kR, iv + j * kR, d,
                                            p.fit, p.eps));
            T total;
            T ex = block_prefix(run, Exact<T>{}, reinterpret_cast<T*>(wtot),
                                parity, lane, warp, nwarps, total);
#pragma unroll
            for (int k = 0; k < L; ++k) {
              const T f = masked_fits(carry, k, cb, sv + j * kR,
                                      bv + j * kR, iv + j * kR, d, p.fit,
                                      p.eps);
              const T take = min_t(max_t(sub_rn(d, ex), zero), f);
              ex = add_rn(ex, f);
              tk[k] = static_cast<uint32_t>(to_int(take));
              take_from(carry, k, want, take);
            }
            taken = min_t(d, total);
          }
          parity ^= 1;
          if (trow && mine) Lanes<L>::store(trow, tk);
          left = sub_rn(left, taken);
          if (tid == 0) {
            tot[c] = to_int(taken);
            if (live) live[c] = sub_rn(dc, taken);
          }
        }
        ring_release(q, empty, lane);
      }
      const int nx = next_alive(carry, ch + 1, cmin, left, p.slack, nch,
                                mine, masks, round, tid, lane);
      skip(ch + 1, nx);
      ch = nx;
    }
    if (p.free_out && mine) {
      T* fo = p.free_out + static_cast<size_t>(kc) * kR * Wp;
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int k = 0; k < L; ++k) fo[r * Wp + w0 + k] = carry.get(r, k);
    }
  }
  ring_drop(q, full, empty, lane);          // no copy outlives the block
}

// The instances: element type, lanes a thread, resources whose carry
// stays in registers, most threads (512: a 128-register budget a
// thread).  A launch names one by (type, L, RREG).  ops.py's `_STAGED`
// mirrors this table.
#define WATERFILL_STAGED_INSTANCES(X) \
  X(double, 1, 6, 512)                \
  X(double, 2, 6, 512)                \
  X(double, 4, 6, 512)                \
  X(double, 8, 3, 512)                \
  X(double, 16, 2, 384)               \
  X(double, 16, 3, 512)               \
  X(float, 1, 6, 512)                 \
  X(float, 2, 6, 512)                 \
  X(float, 4, 6, 512)                 \
  X(float, 8, 6, 512)                 \
  X(float, 16, 4, 512)

template <typename T>
const void* staged_instance(int L, int rreg) {
#define WATERFILL_PICK(TT, LL, RR, NN)                                   \
  if (std::is_same<T, TT>::value && L == LL && rreg == RR)               \
    return reinterpret_cast<const void*>(&staged_kernel<TT, LL, RR, NN>);
  WATERFILL_STAGED_INSTANCES(WATERFILL_PICK)
#undef WATERFILL_PICK
  return nullptr;
}

cudaError_t staged_init(int max_smem) {
#define WATERFILL_OPT_IN(TT, LL, RR, NN)                                 \
  if (err == cudaSuccess)                                                \
    err = cudaFuncSetAttribute(staged_kernel<TT, LL, RR, NN>,            \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               max_smem);
  cudaError_t err = cudaSuccess;
  WATERFILL_STAGED_INSTANCES(WATERFILL_OPT_IN)
#undef WATERFILL_OPT_IN
  return err;
}

template <typename T>
cudaError_t staged_launch(int L, int rreg, int mode, int fit,
                          const void* free_in,
                          const void* want, const void* safe,
                          const void* big, const void* inv,
                          const void* crow, const void* demand,
                          const void* chunk_min, const void* arrivals,
                          const void* free_add, const void* add_free,
                          const void* budgets, void* takes, void* ran,
                          void* totals, void* free_out, void* scratch,
                          double left, double fit_eps, int K, int N,
                          int Wp, int nch, int sub, int threads, int smem,
                          cudaStream_t stream) {
  const void* fn = staged_instance<T>(L, rreg);
  if (fn == nullptr) return cudaErrorInvalidValue;
  StagedParams<T> p;
  p.free_in = static_cast<const T*>(free_in);
  p.want = static_cast<const T*>(want);
  p.safe = static_cast<const T*>(safe);
  p.big = static_cast<const T*>(big);
  p.inv = static_cast<const T*>(inv);
  p.crow = static_cast<const uint8_t*>(crow);
  p.demand = static_cast<const T*>(demand);
  p.chunk_min = static_cast<const T*>(chunk_min);
  p.arrivals = static_cast<const T*>(arrivals);
  p.free_add = static_cast<const T*>(free_add);
  p.add_free = static_cast<const uint8_t*>(add_free);
  p.budgets = static_cast<const T*>(budgets);
  p.takes = static_cast<int32_t*>(takes);
  p.ran = static_cast<uint8_t*>(ran);
  p.totals = static_cast<int32_t*>(totals);
  p.free_out = static_cast<T*>(free_out);
  p.scratch = static_cast<T*>(scratch);
  p.left0 = static_cast<T>(left);
  p.eps = static_cast<T>(fit_eps);
  p.slack = static_cast<T>(1.0 - 2.0 * fit_eps);
  p.mode = mode;
  p.fit = fit;
  p.K = K;
  p.Wp = Wp;
  p.nch = nch;
  p.sub = sub;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchKernel(fn, dim3(N), dim3(threads), args,
                                     static_cast<size_t>(smem), stream);
  return err != cudaSuccess ? err : cudaGetLastError();
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

}  // namespace

extern "C" {

// dtype: 0 = float64, 1 = float32.  Returns a cudaError_t (0 = launched).
int waterfill_launch(int device, int dtype, const void* freeT, double left,
                     const void* want, const void* safe, const void* big,
                     const void* demand, const void* crow,
                     const void* chunk_min, void* takes, void* ran,
                     void* free_out, int R, int Wp, int nch, int chunk,
                     int free_in_smem, double fit_eps, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<double>(freeT, left, want, safe, big, demand, crow,
                         chunk_min, takes, ran, free_out, R, Wp, nch, chunk,
                         free_in_smem, fit_eps, s);
  else
    err = launch<float>(freeT, left, want, safe, big, demand, crow,
                        chunk_min, takes, ran, free_out, R, Wp, nch, chunk,
                        free_in_smem, fit_eps, s);
  return static_cast<int>(err);
}

// Once per device, before its first launch: lets every kernel template
// opt into the largest dynamic shared memory a block may have there, and
// returns that size in bytes (or minus a cudaError_t).
int waterfill_init(int device) {
  int bytes = 0;
  DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess) err = init<double>(bytes);
  if (err == cudaSuccess) err = init<float>(bytes);
  if (err == cudaSuccess) err = staged_init(bytes);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// The step-floor probe: `steps` scan rounds in one block of `threads`
// threads (a multiple of 32), writing one value to `out`.
int waterfill_step_floor(int device, int dtype, int steps, int threads,
                         void* out, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    step_floor_kernel<double><<<1, threads, 0, s>>>(
        steps, static_cast<double*>(out));
  else
    step_floor_kernel<float><<<1, threads, 0, s>>>(
        steps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The staged instance.  mode: 0 one cycle (chunk_min given), 1 K cycles
// (arrivals, free_add, add_free, budgets; scratch holds Cp + nch*R
// values), 2 N candidates, a block each (scratch N*nch*R values; no
// takes, ran or free_out).  fit: 0 divide, 1 reciprocal with the exact
// fallback, 2 the divide probe (reciprocal unchecked).  takes: the rows
// of the n-th chunk that ran (over all cycles) go to rows n*64 on.  L,
// rreg, threads, sub and smem come from the caller's plan
// (ops.staged_plan).
int waterfill_staged_launch(int device, int dtype, int L, int rreg, int mode,
                            int fit, const void* free_in, const void* want,
                            const void* safe, const void* big,
                            const void* inv, const void* crow,
                            const void* demand, const void* chunk_min,
                            const void* arrivals, const void* free_add,
                            const void* add_free, const void* budgets,
                            void* takes, void* ran, void* totals,
                            void* free_out, void* scratch, double left,
                            double fit_eps, int K, int N, int Wp, int nch,
                            int sub, int threads, int smem, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = staged_launch<double>(
        L, rreg, mode, fit, free_in, want, safe, big, inv, crow, demand,
        chunk_min, arrivals, free_add, add_free, budgets, takes, ran,
        totals, free_out, scratch, left, fit_eps, K, N, Wp, nch, sub,
        threads, smem, s);
  else
    err = staged_launch<float>(
        L, rreg, mode, fit, free_in, want, safe, big, inv, crow, demand,
        chunk_min, arrivals, free_add, add_free, budgets, takes, ran,
        totals, free_out, scratch, left, fit_eps, K, N, Wp, nch, sub,
        threads, smem, s);
  return static_cast<int>(err);
}

const char* waterfill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
