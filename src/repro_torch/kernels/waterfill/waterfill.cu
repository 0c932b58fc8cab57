// Hopper water-fill: one negotiation cycle of the chunked greedy
// cohort -> worker allocation, in one thread block.
//
// Replaces the Pallas TPU kernel `waterfill_pallas` / `_waterfill_kernel`
// (src/repro/kernels/waterfill/kernel.py) of the JAX package; the plain
// PyTorch version it is held against is `ref.py::waterfill_reference`.
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
// and per chunk of `chunk` cohorts a drain guard: the chunk is skipped
// (takes stay zero, ran = 0) when left <= 0 or no worker has
// free_r >= chunk_min_r * (1 - 2 FIT_EPS) for every r -- provably no
// cohort of the chunk fits anywhere then, so skipping is claim-exact.
//
// What bounds it on this card: not bytes (the whole problem is a few
// MB at most: the u8 compat mask in, the i32 takes out) and not
// arithmetic (a few R-wide divides per worker lane per cohort), but the
// serial dependency: cohort c+1 reads the free matrix cohort c left
// behind, so the C cohorts of a cycle are C dependent block-wide scans.
// The design keeps that chain short:
//
//   * one block per problem; worker lanes across threads, lane
//     w = base + threadIdx.x in rounds of blockDim (<= 1024) lanes, so
//     any Wp works and Wp <= 1024 costs one round per cohort;
//   * the free carry lives in dynamic shared memory when R*Wp values fit
//     (the host decides), else in place in the free_out buffer; each
//     thread only ever touches its own lanes, so the carry needs no
//     barrier of its own;
//   * one __syncthreads per round: warps scan in registers with
//     __shfl_up_sync, publish their totals to a double-buffered shared
//     array, and every warp re-scans the (<= 32) warp totals itself;
//   * `left` is block-uniform in registers: every thread applies the
//     same left -= min(d, total) (the greedy prefix hands out exactly
//     min(d, sum fits) jobs), so no broadcast is needed;
//   * a cohort with d = 0 (padding, masked by `active`, or after the
//     budget ran out) is skipped whole: it would take nothing.
//
// Exactness: fits, takes and their sums are integer-valued, so the scan
// is exact in any order.  Every rounding step uses an explicit
// round-to-nearest intrinsic (IEEE divide, no fused multiply-subtract;
// the file is also built with --fmad=false), so float64 results are
// bit-identical to the plain version and to the JAX reference.
#include <cuda_runtime.h>
#include <stdint.h>

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
      for (int r = 0; r < R; ++r)
        all &= fs[r * Wp + w] >= mul_rn(chunk_min[ch * R + r], slack);
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

// Once per device, before its first launch: lets both kernel templates
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

const char* waterfill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
