// dopri5_attempt_draws for Hopper (sm_90a): one adaptive Dormand-Prince
// attempt of S posterior field draws at once, forward only: the body of the
// batched prediction solve's captured attempt (models/flow.py
// `CapturedAttempt`; the validation and test evaluations).
//
// Replaces no Pallas kernel: the JAX package runs this attempt as XLA's
// fusion of the vmapped plain field inside a `lax.while_loop`. It was added
// because on the card the plain attempt is ~300 small kernels over a few
// rows a draw (32 draws x 2 sequences at validation), each one latency-bound,
// and the host waits out all of them at every attempt's error read.
//
// Bound: latency. An attempt is six dependent field evaluations (k1 arrives,
// FSAL) over a few rows a draw: each stage waits on its parameter loads and
// on a few accurate cosf/expf chains per lane, then on the block's
// barrier. The arithmetic (~10 MFLOP at 32 x 2 rows, M=100, S=256) and the
// draws' operands (~1.3 MB) would take well under a microsecond.
//
// One block per tile of RT rows of one draw (the draws' tiles in draw order),
// G groups of D warps. Each stage is one `rhs_tile` call (rhs_tile.cuh) on
// the draw's operands; the warps of a dim meet in shared memory, added in
// group order, where the thread of (row, k) forms k_i and the next stage
// input. The stage combinations round as the plain step does (each product,
// each partial sum in coefficient order, dt times the sum, then the add), so
// the kernel differs from `ops/cuda_kernels.dopri5_attempt_draws_plain` only
// in the field's summation order. A block writes its sum of squared scaled
// errors; `draws_ratio_kernel` adds each draw's tiles in order, takes the
// RMS and the largest over the draws in a fixed tree (a NaN wins, so a
// non-finite step is rejected). No float atomics: bit-reproducible run to
// run. Requires D == Din.
//
// Operands: x, k1, x_new, k7 (S, N, D); z (M, Din), lengthscales (D, Din)
// constrained and var (D,) shared; per draw, in the kernel layout, omega
// (S, D, Din, Sf), phase and w (S, D, Sf), nu (S, D, M). dt is read from
// device memory, so a graph replay sees each new fill.
//
// draws_commit_kernel, the captured attempt's last node, commits an accepted
// attempt on the device: the cubic Hermite dense output at every output time
// in (tau, tau_end] and the hand-over x <- x_new, k1 <- k7 (see below).

#include "rhs_tile.cuh"

#define DP_B5 49
#define DP_E 56
#define RATIO_THREADS 256

// x + dt * sum_{j < count} c[j] k_j with the plain step's roundings, k_j at
// kr[j * GQ]; a zero coefficient is skipped where `skip_zero` (the plain
// 5th-order sum leaves those terms out).
template <int GQ>
__device__ __forceinline__ float dp_combine(float x, float dt, const float* c,
                                            const float* kr, int count,
                                            bool skip_zero) {
  float acc = 0.f;
  for (int j = 0; j < count; ++j) {
    if (skip_zero && c[j] == 0.f) continue;
    acc = __fadd_rn(acc, __fmul_rn(c[j], kr[j * GQ]));
  }
  return __fadd_rn(x, __fmul_rn(dt, acc));
}

// NaN-propagating max (fmaxf drops a NaN).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(b) || b > a) ? b : a;
}

// Shared memory: FwdSmem<DP, RT, 7> (rhs_tile.cuh), then sq (align4(RT * DP))
// the tile's squared scaled errors.
template <int DP, int RT, int MAXT>
static __global__ void __launch_bounds__(MAXT)
draws_attempt_kernel(const float* __restrict__ x, const float* __restrict__ k1,
                     const float* __restrict__ dt_ptr, const float* __restrict__ coef,
                     float direction, float rtol, float atol, RhsParams p,
                     const float* __restrict__ ls, float* __restrict__ x_new,
                     float* __restrict__ k7, float* __restrict__ part, int n,
                     int tiles, int groups) {
  extern __shared__ __align__(16) float smem[];
  using L = FwdSmem<DP, RT, 7>;
  constexpr int XS = tile_stride(DP);
  constexpr int GQ = align4(RT * DP);
  const int din = p.din, D = p.d;
  const int warps = blockDim.x >> 5;
  float* xb = smem + L::xb;    // (RT, XS) the state tile
  float* xi = smem + L::xi;    // (RT, XS) the current stage input
  float* ks = smem + L::ks;    // (7, GQ) k1..k7, [r * DP + k]
  float* ils = smem + L::il;   // (D, DP) 1 / lengthscale
  float* red = smem + L::red;  // (warps, 32) the warps' row sums
  float* sq = red + 32 * warps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp % D, grp = warp / D;
  const int draw = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * RT;
  const int rows = min(RT, n - row0);
  const float dt = *dt_ptr;
  const size_t off = ((size_t)draw * n + row0) * din;
  p.omega += (size_t)draw * D * din * p.s;
  p.phase += (size_t)draw * D * p.s;
  p.w += (size_t)draw * D * p.s;
  p.nu += (size_t)draw * D * p.m;

  for (int i = threadIdx.x; i < D * DP; i += blockDim.x) {
    const int k = i % DP;
    ils[i] = (k < din) ? 1.f / ls[(i / DP) * din + k] : 0.f;
  }
  for (int i = threadIdx.x; i < RT * XS; i += blockDim.x) {
    const int r = i / XS, k = i % XS;
    const bool live = r < rows && k < din;
    xb[i] = live ? x[off + r * din + k] : 0.f;
    if (live) ks[r * DP + k] = k1[off + r * din + k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RT * XS; i += blockDim.x) {  // stage 2's input
    const int r = i / XS, k = i % XS;
    xi[i] = (r < rows && k < din)
                ? dp_combine<GQ>(xb[i], dt, coef + 7, ks + r * DP + k, 1, false)
                : 0.f;
  }
  __syncthreads();

#pragma unroll 1
  for (int st = 1; st < 7; ++st) {
    tile_stage<DP, RT>(p, xi, rows, d, grp, groups, lane, ils + d * DP,
                       red + warp * 32);
    __syncthreads();
    // the thread of (r, k) forms k_st there and reads only the k_j it formed
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
      const int r = i / din, k = i % din;
      const int xk = r * XS + k;
      float* kr = ks + r * DP + k;
      kr[st * GQ] = direction * tile_rhs_sum<RT>(p, red, groups, r, k);
      if (st < 5) {  // the next stage's input
        xi[xk] = dp_combine<GQ>(xb[xk], dt, coef + (st + 1) * 7, kr, st + 1, false);
      } else if (st == 5) {  // the 5th-order endpoint, the last stage's input
        xi[xk] = dp_combine<GQ>(xb[xk], dt, coef + DP_B5, kr, 6, true);
      } else {  // k7 = f(x5): the embedded error, scaled
        float e = 0.f;
        for (int j = 0; j < 7; ++j)
          e = __fadd_rn(e, __fmul_rn(coef[DP_E + j], kr[j * GQ]));
        e = __fmul_rn(dt, e);
        const float x5 = xi[xk];
        const float scale =
            __fadd_rn(atol, __fmul_rn(rtol, fmaxf(fabsf(xb[xk]), fabsf(x5))));
        const float q = __fdiv_rn(e, scale);
        x_new[off + i] = x5;
        k7[off + i] = kr[6 * GQ];
        sq[i] = __fmul_rn(q, q);
      }
    }
    __syncthreads();
  }

  if (warp == 0) {  // the tile's sum of squares, lanes then a fixed butterfly
    float v = 0.f;
    for (int i = lane; i < rows * din; i += 32) v += sq[i];
    v = warp_sum(v);
    if (lane == 0) part[blockIdx.x] = v;
  }
}

// ratio = max over draws of sqrt(sum of the draw's tiles / (N * D)), each
// draw's tiles added in order, the max in a fixed tree.
static __global__ void __launch_bounds__(RATIO_THREADS)
draws_ratio_kernel(const float* __restrict__ part, float* __restrict__ ratio,
                   int draws, int tiles, float count) {
  __shared__ float best[RATIO_THREADS];
  float m = 0.f;
  for (int s = threadIdx.x; s < draws; s += RATIO_THREADS) {
    float v = 0.f;
    for (int t = 0; t < tiles; ++t) v += part[(size_t)s * tiles + t];
    m = nan_max(m, sqrtf(v / count));
  }
  best[threadIdx.x] = m;
  __syncthreads();
  for (int h = RATIO_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) best[threadIdx.x] = nan_max(best[threadIdx.x], best[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) *ratio = best[0];
}

// The instantiated variants (DP, RT, MAXT), one per range of Din (<= 4, 5,
// <= 8, <= 16; ops/cuda_kernels.py picks the smallest DP >= Din): the
// segment forward's (fused_dopri5.cu), whose stage code this kernel shares;
// MAXT bounds the block and with it the registers per thread (65536 / MAXT).
#define DRAWS_VARIANTS(X) X(4, 8, 1024) X(5, 8, 1024) X(8, 4, 384) X(16, 4, 512)

// Both kernels on `stream`; with `occupancy` non-null nothing is launched
// and the attempt kernel's occupancy_report at this geometry is written there.
static int draws_run(const float* x, const float* k1, const float* dt,
                     const float* coef, float direction, float rtol, float atol,
                     const float* z, const float* ls, const float* var,
                     const float* omega, const float* phase, const float* w,
                     const float* nu, float* x_new, float* k7, float* part,
                     float* ratio, int draws, int n, int din, int d, int m, int s,
                     int dp, int rt, int groups, int maxt, int* occupancy,
                     void* stream) {
  const RhsParams p = make_params(z, nullptr, var, omega, phase, w, nu, din, d, m, s);
  if (din != d || din < 1 || din > dp || m < 1 || s < 1 || n < 1 || draws < 1 ||
      rt < 1 || groups < 1 || 32 * d * groups > maxt)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * d * groups;
  const int tiles = (n + rt - 1) / rt;
  if ((long long)draws * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int blocks = draws * tiles;
  const size_t smem =
      sizeof(float) * (size_t)(fwd_smem_floats(dp, rt, 7, d * groups) + align4(rt * dp));
  cudaError_t e = cudaErrorInvalidValue;
#define X(DP_, RT_, MAXT_)                                                        \
  if (dp == DP_ && rt == RT_ && maxt == MAXT_) {                                  \
    e = prepare_kernel(draws_attempt_kernel<DP_, RT_, MAXT_>, threads, smem,      \
                       occupancy);                                                \
    if (e == cudaSuccess && !occupancy) {                                         \
      draws_attempt_kernel<DP_, RT_, MAXT_>                                       \
          <<<blocks, threads, smem, (cudaStream_t)stream>>>(                      \
              x, k1, dt, coef, direction, rtol, atol, p, ls, x_new, k7, part, n,  \
              tiles, groups);                                                     \
      e = cudaGetLastError();                                                     \
    }                                                                             \
  }
  DRAWS_VARIANTS(X)
#undef X
  if (e != cudaSuccess || occupancy) return (int)e;
  draws_ratio_kernel<<<1, RATIO_THREADS, 0, (cudaStream_t)stream>>>(
      part, ratio, draws, tiles, (float)n * (float)d);
  return (int)cudaGetLastError();
}

extern "C" int gpode_dp_draws_attempt(const float* x, const float* k1,
                                      const float* dt, const float* coef,
                                      float direction, float rtol, float atol,
                                      const float* z, const float* ls,
                                      const float* var, const float* omega,
                                      const float* phase, const float* w,
                                      const float* nu, float* x_new, float* k7,
                                      float* part, float* ratio, int draws, int n,
                                      int din, int d, int m, int s, int dp, int rt,
                                      int groups, int maxt, void* stream) {
  return draws_run(x, k1, dt, coef, direction, rtol, atol, z, ls, var, omega, phase,
                   w, nu, x_new, k7, part, ratio, draws, n, din, d, m, s, dp, rt,
                   groups, maxt, nullptr, stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the attempt kernel at this geometry; launches nothing.
extern "C" int gpode_dp_draws_attempt_occupancy(int din, int d, int m, int s,
                                                int dp, int rt, int groups,
                                                int maxt, int* out) {
  return draws_run(nullptr, nullptr, nullptr, nullptr, 0.f, 0.f, 0.f, nullptr,
                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, 1, rt, din, d, m, s, dp, rt, groups,
                   maxt, out, nullptr);
}

// ---------------------------------------------------------------------------
// draws_commit_kernel: an accepted attempt's commit (models/flow.py
// `CapturedAttempt`, after the attempt in the captured graph).
//
// Replaces no Pallas kernel: the JAX package's dense output is XLA's. It was
// added because on the host the commit is ~7 small launches an output point
// and two copies an accepted step, issued one by one between the attempts.
//
// Bound: latency. The launch, one read of the T output times spread over a
// block's threads and two barriers; the bytes (x, k1, x_new, k7 read, x and
// k1 written, a few points' outputs) are ~10 KB at the validation request's
// 32 x 2 x 5 states.
//
// Reads the attempt's error ratio and on !(ratio <= 1) (a reject, or NaN)
// writes nothing, as the host's `float(ratio) <= 1.0` decides. Else each
// block takes the output times COMMIT_THREADS at a time: the thread of time
// j, where tau < taus[j] <= tau_end, forms that point's four coefficients
// once and lists them in shared memory (an integer atomic orders the list;
// the points are independent, so the order changes no bit); then the thread
// of element i of the (S, N, D) state writes every listed point, out[j, i] =
// ops/ode.py `_hermite(taus[j], tau, tau_end, x, k1, x_new, k7)` with its
// roundings: the coefficients in float32 in numpy's order, each product and
// sum rounded once (no contraction into FMA), the four terms added left to
// right as the host's tensor ops add them. It then sets x[i] = x_new[i] and
// k1[i] = k7[i]: the thread owns its element, so it has read the old state
// before it writes. scalars = {dt, tau, tau_end}, read on the device, so a
// replay sees each new copy. No float atomics; elements past n are masked.

#define COMMIT_THREADS 256

static __global__ void __launch_bounds__(COMMIT_THREADS)
draws_commit_kernel(const float* __restrict__ ratio,
                    const float* __restrict__ scalars,
                    const float* __restrict__ taus, int points,
                    float* __restrict__ out, float* __restrict__ x,
                    float* __restrict__ k1, const float* __restrict__ x_new,
                    const float* __restrict__ k7, int n) {
  __shared__ float coef[4][COMMIT_THREADS];  // h00, h10 * h, h01, h11 * h
  __shared__ int time_of[COMMIT_THREADS];
  __shared__ int listed;
  if (!(*ratio <= 1.f)) return;  // the same for every thread of the block
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float t0 = scalars[1], t1 = scalars[2];
  float h = __fsub_rn(t1, t0);
  if (h == 0.f) h = 1.f;
  float x0 = 0.f, f0 = 0.f, x1 = 0.f, f1 = 0.f;
  if (live) {
    x0 = x[i];
    f0 = k1[i];
    x1 = x_new[i];
    f1 = k7[i];
  }
  for (int first = 0; first < points; first += COMMIT_THREADS) {
    if (threadIdx.x == 0) listed = 0;
    __syncthreads();
    const int j = first + threadIdx.x;
    const float t = j < points ? taus[j] : 0.f;
    if (j < points && t0 < t && t <= t1) {
      const float s = __fdiv_rn(__fsub_rn(t, t0), h);
      const float s2 = __fmul_rn(s, s);
      const float s3 = __fmul_rn(s2, s);
      const int k = atomicAdd(&listed, 1);
      time_of[k] = j;
      coef[0][k] = __fadd_rn(__fsub_rn(__fmul_rn(2.f, s3), __fmul_rn(3.f, s2)), 1.f);
      coef[1][k] = __fmul_rn(__fadd_rn(__fsub_rn(s3, __fmul_rn(2.f, s2)), s), h);
      coef[2][k] = __fadd_rn(__fmul_rn(-2.f, s3), __fmul_rn(3.f, s2));
      coef[3][k] = __fmul_rn(__fsub_rn(s3, s2), h);
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < listed; ++k) {
        float v = __fadd_rn(__fmul_rn(coef[0][k], x0), __fmul_rn(coef[1][k], f0));
        v = __fadd_rn(v, __fmul_rn(coef[2][k], x1));
        v = __fadd_rn(v, __fmul_rn(coef[3][k], f1));
        out[(size_t)time_of[k] * n + i] = v;
      }
    }
    __syncthreads();  // the list is read before the next chunk's
  }
  if (live) {
    x[i] = x1;
    k1[i] = f1;
  }
}

// The commit on `stream`: out (points, n), x, k1, x_new, k7 (n) contiguous.
extern "C" int gpode_dp_draws_commit(const float* ratio, const float* scalars,
                                     const float* taus, float* out, float* x,
                                     float* k1, const float* x_new,
                                     const float* k7, int points, int n,
                                     void* stream) {
  if (points < 0 || n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + COMMIT_THREADS - 1) / COMMIT_THREADS;
  draws_commit_kernel<<<blocks, COMMIT_THREADS, 0, (cudaStream_t)stream>>>(
      ratio, scalars, taus, points, out, x, k1, x_new, k7, n);
  return (int)cudaGetLastError();
}
