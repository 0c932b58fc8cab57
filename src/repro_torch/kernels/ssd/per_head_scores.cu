// Design study of the SSD kernel's "mma" instance (ssd.cu): the scores
// C B^T formed per head, in the outputs pass, against ssd.cu's scores
// pass, which forms them once per (batch row, chunk, group) for every
// head of the group to read.  Both give the same bits.  Built and timed
// by `study.py` only; the port never launches it.  Passes 1 and 2 are
// ssd.cu's own; the outputs pass loads each key tile's B beside its x
// and forms the 64 x 64 scores of depth N itself, with the same
// mma.sync sequence as ssd.cu's pass 3a.
#include "ssd.cu"

namespace {
namespace tc {

// The shared region after the C tile: the entering state's hi and lo
// parts, and later (over them) the key tile's B and x.
__host__ __device__ constexpr int per_head_region(int P, int N) {
  return 2 * P * pad(N) > kRows * (pad(N) + pad(P))
             ? 2 * P * pad(N)
             : kRows * (pad(N) + pad(P));
}

__host__ __device__ constexpr size_t per_head_smem(int P, int N) {
  return sizeof(bf16) * (kRows * pad(N) + per_head_region(P, N)) +
         sizeof(float) * 2 * kMaxQ;
}

// ssd.cu's pass 3b with the scores formed here, per head: block (query
// tile qt, chunk c, head bh), y for the 64 query rows i0 .. i0+63 of the
// chunk; warp w owns rows i0 + 16w .. i0 + 16w + 15.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_per_head_outputs(Params p) {
  constexpr int LC = pad(N), LX = pad(P);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* cs = reinterpret_cast<bf16*>(smem_tc);    // (64 queries, N)
  bf16* hi = cs + kRows * LC;                     // (P, N) entering state,
  bf16* lo = hi + P * LC;                         //   bf16 hi and lo parts
  bf16* bs = cs + kRows * LC;                     // (64 keys, N), over hi
  bf16* xs = bs + kRows * LC;                     // (64 keys, P)
  float* cum = reinterpret_cast<float*>(cs + kRows * LC +
                                        per_head_region(P, N));
  float* dts = cum + kMaxQ;
  const int qt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int t0 = c * p.Q, L = min(p.Q, p.S - t0), i0 = qt * kRows;
  if (i0 >= L) return;              // a tile past the ragged last chunk
  const int b = bh / p.H, h = bh - b * p.H, g = h / (p.H / p.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = lane & 3, r0 = warp * 16 + (lane >> 2);   // rows r0, r0+8
  const bf16* xb = p.x + b * p.xs_b + static_cast<long long>(t0) * p.xs_s +
                   h * p.xs_h;
  const bf16* bb = p.Bm + b * p.bs_b + static_cast<long long>(t0) * p.bs_s +
                   g * p.bs_g;
  const bf16* cb = p.Cm + b * p.cs_b + static_cast<long long>(t0) * p.cs_s +
                   g * p.cs_g;

  load_tile<N>(cs, LC, cb + static_cast<long long>(i0) * p.cs_s, p.cs_s,
               min(kRows, L - i0));
  const float* cum_in = p.cum + (static_cast<long long>(bh) * p.nc + c) * p.Qp;
  const float* dtb = p.dt + (static_cast<long long>(b) * p.S + t0) * p.H + h;
  for (int j = tid; j < i0 + kRows; j += kThreads) {
    cum[j] = cum_in[j] * kLog2e;    // cumA in log2 units, for ex2
    dts[j] = j < L ? dtb[static_cast<long long>(j) * p.H] : 0.f;
  }

  float acc[P / 8][4];
#pragma unroll
  for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  // inter-chunk term: exp(cumA_i) (C_i . S_enter[p, :]), the state as
  // pass 2 split it into bf16 hi + lo (two products)
  const bool entered = c > 0 || p.init;
  if (entered) {
    const bf16* from =
        p.enter + ((static_cast<long long>(b) * p.nc + c) * p.H + h) * 2 * P * N;
    load_tile<N, P>(hi, LC, from, N, P);
    load_tile<N, P>(lo, LC, from + P * N, N, P);
  }
  cp_async_commit();
  if (entered) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < N; kk += 16) {
      uint32_t a[4];                // C[i][n] stored (i, n)
      ldsm_x4(a, cs + (warp * 16 + (lane & 15)) * LC + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < P / 8; nt += 2) {
        // S[p][n] stored (p, n): the col-major B of C S^T
        const int off = (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LC + kk +
                        ((lane >> 3) & 1) * 8;
        uint32_t bq[4];
        ldsm_x4(bq, hi + off);
        mma16816(acc[nt], a, bq[0], bq[1]);
        mma16816(acc[nt + 1], a, bq[2], bq[3]);
        ldsm_x4(bq, lo + off);
        mma16816(acc[nt], a, bq[0], bq[1]);
        mma16816(acc[nt + 1], a, bq[2], bq[3]);
      }
    }
    const float e0 = ex2(cum[i0 + r0]), e1 = ex2(cum[i0 + r0 + 8]);
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
  }

  // intra-chunk term over the key tiles at or before this one
  const int ri0 = i0 + r0, ri1 = ri0 + 8;
  for (int kt = 0; kt <= qt; ++kt) {
    const int j0 = kt * kRows;
    __syncthreads();                // the state's or the last tile's space
    load_tile<N>(bs, LC, bb + static_cast<long long>(j0) * p.bs_s, p.bs_s,
                 min(kRows, L - j0));
    load_tile<P>(xs, LX, xb + static_cast<long long>(j0) * p.xs_s, p.xs_s,
                 min(kRows, L - j0));
    cp_async_wait_all();
    __syncthreads();
    const float ci0 = cum[ri0], ci1 = cum[ri1];
    // key n8 tiles holding some j <= i of this warp's rows
    const int live = kt == qt ? 2 * warp + 2 : 8;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < N; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, cs + (warp * 16 + (lane & 15)) * LC + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        if (nt < live) {
          uint32_t bq[4];           // B[j][n] stored (j, n)
          ldsm_x4(bq, bs + (nt * 8 + (lane & 7) + (lane >> 4) * 8) * LC + kk +
                          ((lane >> 3) & 1) * 8);
          mma16816(s[nt], a, bq[0], bq[1]);
          mma16816(s[nt + 1], a, bq[2], bq[3]);
        }
      }
    }
    // mask, decay and dt: below the diagonal tile every pair has j < i;
    // on it, pairs j > i (and past L) are set to 0 by a select, never
    // multiplied by their decay, which may be infinite
    const bool diag = kt == qt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + nt * 8 + 2 * tq + u;
        const float cj = cum[j], dj = dts[j];
        const bool k0 = !diag || (j <= ri0 && j < L);
        const bool k1 = !diag || (j <= ri1 && j < L);
        s[nt][u] = k0 ? s[nt][u] * ex2(ci0 - cj) * dj : 0.f;
        s[nt][2 + u] = k1 ? s[nt][2 + u] * ex2(ci1 - cj) * dj : 0.f;
      }
    // scores @ x: key tiles 2k and 2k+1's accumulators are, packed to
    // bf16, the A fragment of the k-th 16-key slice
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (2 * k < live) {
        const uint32_t a[4] = {pack_bf16(s[2 * k][0], s[2 * k][1]),
                               pack_bf16(s[2 * k][2], s[2 * k][3]),
                               pack_bf16(s[2 * k + 1][0], s[2 * k + 1][1]),
                               pack_bf16(s[2 * k + 1][2], s[2 * k + 1][3])};
#pragma unroll
        for (int nt = 0; nt < P / 8; nt += 2) {
          uint32_t bq[4];           // x[j][p] stored (j, p)
          ldsm_x4_trans(bq, xs + (k * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                     LX + nt * 8 + (lane >> 4) * 8);
          mma16816(acc[nt], a, bq[0], bq[1]);
          mma16816(acc[nt + 1], a, bq[2], bq[3]);
        }
      }
    }
  }

  // skip term (xs holds this tile's own rows), then store
  const float Dh = p.D[h];
  bf16* yb = p.y + ((static_cast<long long>(b) * p.S + t0) * p.H + h) * P;
  const long long ry = static_cast<long long>(p.H) * P;
#pragma unroll
  for (int nt = 0; nt < P / 8; ++nt) {
    const int col = nt * 8 + 2 * tq;
    if (ri0 < L) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + r0 * LX + col));
      *reinterpret_cast<__nv_bfloat162*>(yb + ri0 * ry + col) =
          __floats2bfloat162_rn(acc[nt][0] + Dh * xv.x,
                                acc[nt][1] + Dh * xv.y);
    }
    if (ri1 < L) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + (r0 + 8) * LX + col));
      *reinterpret_cast<__nv_bfloat162*>(yb + ri1 * ry + col) =
          __floats2bfloat162_rn(acc[nt][2] + Dh * xv.x,
                                acc[nt][3] + Dh * xv.y);
    }
  }
}

template <int P, int N>
cudaError_t launch_per_head(const Params& p, int BH, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_per_head_outputs<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(per_head_smem(P, N)));
  if (err != cudaSuccess) return err;
  ssd_mma_states<<<dim3(p.nc, P / kRows * (N / kRows), BH), kThreads,
                   states_smem(), s>>>(p);
  ssd_mma_pass<<<dim3((P * N + kPassThreads - 1) / kPassThreads, BH),
                 kPassThreads, 0, s>>>(p);
  ssd_per_head_outputs<P, N><<<dim3(p.Qp / kRows, p.nc, BH), kThreads,
                               per_head_smem(P, N), s>>>(p);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace

extern "C" {

// ssd_mma_launch's arguments and workspaces but the scores'.  Returns a
// cudaError_t.
int ssd_per_head_launch(int device, const void* x, const void* dt,
                        const void* A, const void* Bm, const void* Cm,
                        const void* D, const void* init, void* y, void* fin,
                        void* cum, void* states, void* enter, int B, int S,
                        int H, int P, int G, int N, int Q, long long xs_b,
                        long long xs_s, long long xs_h, long long bs_b,
                        long long bs_s, long long bs_g, long long cs_b,
                        long long cs_s, long long cs_g, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0 ||
      Q > tc::kMaxQ || ssd_mma_smem(P, N) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = static_cast<const __nv_bfloat16*>(Bm);
  p.Cm = static_cast<const __nv_bfloat16*>(Cm);
  p.D = static_cast<const float*>(D);
  p.init = static_cast<const float*>(init);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.fin = static_cast<float*>(fin);
  p.cum = static_cast<float*>(cum);
  p.states = static_cast<float*>(states);
  p.enter = static_cast<__nv_bfloat16*>(enter);
  p.scores = nullptr;
  p.S = S;
  p.H = H;
  p.G = G;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.Qp = (Q + tc::kRows - 1) / tc::kRows * tc::kRows;
  p.nc = (S + Q - 1) / Q;
  p.xs_b = xs_b;
  p.xs_s = xs_s;
  p.xs_h = xs_h;
  p.bs_b = bs_b;
  p.bs_s = bs_s;
  p.bs_g = bs_g;
  p.cs_b = cs_b;
  p.cs_s = cs_s;
  p.cs_g = cs_g;
  const int BH = B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 64) return tc::launch_per_head<64, 64>(p, BH, s);
  if (P == 64 && N == 128) return tc::launch_per_head<64, 128>(p, BH, s);
  if (P == 128 && N == 64) return tc::launch_per_head<128, 64>(p, BH, s);
  return tc::launch_per_head<128, 128>(p, BH, s);
}

}  // extern "C"
