// fused_dopri5_attempt for Hopper (sm_90a): one whole-span Dormand-Prince
// step of the GPODE vector field for every row (forward), and the reverse
// sweep of its 5th-order chain (backward).
//
// Replaces gpode_tpu/ops/pallas_kernels.py `_fused_dp_forward` (:958,
// pallas_call :979; body `_fused_dp_attempt_kernel` :859) and `_fused_dp_bwd`
// (:1003, pallas_call :1027; body `_fused_dp_attempt_bwd_kernel` :879).
//
// Bound: arithmetic — 7 rhs evaluations per row forward, 6 rhs VJPs per row
// backward (rhs_tile.cuh), against ~100 bytes of state per row. HBM sees x0
// in and x5, err and the six stage inputs (6,N,Din) out; the backward reads
// those stage inputs back instead of recomputing the chain. Stage i+1 needs
// all D components of k_i, so a block synchronises between stages.
//
// Forward: one block per tile of RT rows, G groups of D warps. Each of the
// seven evaluations (f0, six stages, k7 = f(x5)) is one `rhs_tile` call
// (rhs_tile.cuh): warp (grp, d) owns every G-th 32-column unit of dim d and
// runs the tile's rows as independent cosf/expf chains, its row sums in
// registers until one fold; the warps of a dim meet in shared memory, added
// in group order, where the thread of (row, k) forms k_i and the next stage
// input. The state tile, the stage derivatives and the stage input stay in
// shared memory for the whole step.
//
// Backward: what costs time is the latency of 6 * N * D * (2S + M) accurate
// sincosf/expf results, so the design keeps many of them in flight per SM.
// A block of G groups of D warps walks its rows in tiles of RT; per tile the
// six stage inputs, the six stage cotangents and the running dx sit in shared
// memory, and each stage is one `rhs_vjp_tile` call (rhs_tile.cuh): every
// warp takes all RT rows for its own columns, so a block's accumulator memory
// does not grow with its warps, parameter loads and accumulator updates are
// paid once per tile, and the dx of a tile meets in shared memory once per
// stage, added in warp order. One slab per block, reduced across blocks in a
// fixed-order second pass (no float atomics).
//
// The tableau arrives as `coef` (A 7x7 row-major | b5 (7) | b5 - b4 (7)),
// made from the port's single copy in gpode_tpu_torch/ops/ode.py, so an
// accepted attempt is the adaptive solver's first step. Requires D == Din.

#include "rhs_tile.cuh"

#define DP_B5 49
#define DP_E 56

// Forward: shared memory as FwdSmem<DP, RT, 7> (rhs_tile.cuh).
template <int DP, int RT, int MAXT>
static __global__ void __launch_bounds__(MAXT)
dp_attempt_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ dt_ptr,
                      const float* __restrict__ coef, float rtol, float atol,
                      RhsParams p, float* __restrict__ x5_out,
                      float* __restrict__ err_out, float* __restrict__ xs_out, int n,
                      int groups) {
  extern __shared__ __align__(16) float smem[];
  using L = FwdSmem<DP, RT, 7>;
  constexpr int GQ = align4(RT * DP);
  const int din = p.din, D = p.d;
  float* xb = smem + L::xb;    // (RT, stride) x0 tile
  float* xi = smem + L::xi;    // (RT, stride) current stage input
  float* ks = smem + L::ks;    // (7, GQ) stage derivatives, [r * DP + k]
  float* ils = smem + L::il;   // (D, DP) 1 / lengthscale
  float* red = smem + L::red;  // (warps, 32) the warps' row sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp % D, grp = warp / D;
  const int row0 = blockIdx.x * RT;
  const int rows = min(RT, n - row0);
  const float dt = *dt_ptr;
  const size_t plane = (size_t)n * din;  // one stage of xs_out
  const size_t off = (size_t)row0 * din;

  tile_load_inv_ls<DP>(p, ils);
  tile_load_x0<DP, RT>(x0, xb, xi, xs_out, row0, rows, din);
  __syncthreads();

#pragma unroll 1
  for (int st = 0; st < 7; ++st) {
    tile_stage<DP, RT>(p, xi, rows, d, grp, groups, lane, ils + d * DP,
                       red + warp * 32);
    __syncthreads();
    // the thread of (r, k) forms k_st there and reads only the k_j it formed
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
      const int r = i / din, k = i % din;
      const int xk = r * tile_stride(DP) + k;
      float* kr = ks + r * DP + k;  // k_j at kr[j * GQ]
      kr[st * GQ] = tile_rhs_sum<RT>(p, red, groups, r, k);
      float acc = 0.f;
      if (st < 5) {  // next stage input: x + dt * sum_j a[st+1][j] k_j
        for (int j = 0; j <= st; ++j) acc += coef[(st + 1) * 7 + j] * kr[j * GQ];
        xi[xk] = xb[xk] + dt * acc;
        xs_out[(st + 1) * plane + off + i] = xi[xk];
      } else if (st == 5) {  // 5th-order endpoint: x + dt * sum_{b5_j != 0} b5_j k_j
        for (int j = 0; j < 6; ++j) {
          const float b = coef[DP_B5 + j];
          if (b != 0.f) acc += b * kr[j * GQ];
        }
        xi[xk] = xb[xk] + dt * acc;
      } else {  // k7 = f(x5): the embedded error estimate
        for (int j = 0; j < 7; ++j) acc += coef[DP_E + j] * kr[j * GQ];
        const float x5 = xi[xk];
        const float scale = atol + rtol * fmaxf(fabsf(xb[xk]), fabsf(x5));
        x5_out[off + i] = x5;
        err_out[off + i] = dt * acc / scale;
      }
    }
    __syncthreads();
  }
}

// Backward: shared memory as TileSmem<DP, RT, 6, 7> (rhs_tile.cuh): planes
// 0..5 the stage cotangents gk, plane 6 the running dx.
template <int DP, int RT, int MAXT>
static __global__ void __launch_bounds__(MAXT)
dp_attempt_bwd_kernel(const float* __restrict__ xs, const float* __restrict__ gy,
                      const float* __restrict__ dt_ptr,
                      const float* __restrict__ coef, RhsParams p,
                      float* __restrict__ dx, float* __restrict__ part_main,
                      float* __restrict__ part_dz, int n, int rows_per_block,
                      int groups) {
  extern __shared__ __align__(16) float smem[];
  using L = TileSmem<DP, RT, 6, 7>;
  constexpr int GQ = tile_plane<DP, RT>();
  const int din = p.din, D = p.d;
  const int qa = vjp_acc_floats(din, p.m, p.s);
  const int warps = blockDim.x >> 5;
  float* xt = smem + L::xt;            // (6, RT, stride) saved stage inputs
  float* gk = smem + L::planes;        // (6, GQ) stage cotangents, [r * Din + k]
  float* gxt = gk + 6 * GQ;            // (GQ) running dx
  float* ils = smem + L::il;           // (D, DP) 1 / lengthscale
  float* acc = smem + L::acc;          // (D, qa) parameter cotangents
  float* dls = acc + align4(D * qa);   // (warps, DP, 32) lengthscale shares
  float* dxw = dls + 32 * DP * warps;  // (warps, 32) per-warp dx shares
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp % D, grp = warp / D;
  const int tile_end = min(n, (blockIdx.x + 1) * rows_per_block);

  for (int i = threadIdx.x; i < dxw - acc; i += blockDim.x) acc[i] = 0.f;
  tile_load_inv_ls<DP>(p, ils);

  for (int row0 = blockIdx.x * rows_per_block; row0 < tile_end; row0 += RT) {
    const int rows = min(RT, tile_end - row0);
    tile_load_stages<DP, RT>(xs, xt, 6, (size_t)n * din, row0, rows, din);
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
      const float g = gy[(size_t)row0 * din + i];
      gxt[i] = g;
      for (int st = 0; st < 6; ++st) gk[st * GQ + i] = *dt_ptr * coef[DP_B5 + st] * g;
    }
    __syncthreads();

#pragma unroll 1
    for (int st = 5; st >= 0; --st) {
      rhs_vjp_tile<DP, RT>(p, xt + st * RT * tile_stride(DP), gk + st * GQ + d,
                           rows, d, grp, groups, lane, acc + d * qa, ils + d * DP,
                           dls + warp * DP * 32, dxw + warp * 32);
      __syncthreads();
      for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
        const float gxi = tile_dx_sum<DP>(dxw, warps, i / din, i % din);
        gxt[i] += gxi;
        for (int j = 0; j < st; ++j) {
          const float a = coef[st * 7 + j];
          if (a != 0.f) gk[j * GQ + i] += *dt_ptr * a * gxi;
        }
      }
      __syncthreads();
    }

    for (int i = threadIdx.x; i < rows * din; i += blockDim.x)
      dx[(size_t)row0 * din + i] = gxt[i];
    __syncthreads();  // the next tile overwrites xt / gk / gxt
  }
  tile_write_partials<DP>(p, acc, dls, groups, part_main, part_dz);
}

// The instantiated forward variants (DP, RT, MAXT), one per range of Din
// (<= 4, 5, <= 8, <= 16; ops/cuda_kernels.py picks the smallest DP >= Din):
// 2 * RT is the width of the row-sum fold; MAXT bounds the block and with it
// the registers per thread (65536 / MAXT): at 1024, 64 registers, so three
// 10-warp blocks are resident per SM (the fastest geometry measured at
// Din = 5; PERF.md).
#define DP_FWD_VARIANTS(X) X(4, 8, 1024) X(5, 8, 1024) X(8, 4, 384) X(16, 4, 512)

// The forward kernel on `stream`; with `occupancy` non-null nothing is
// launched and the kernel's occupancy_report at this geometry is written
// there instead.
static int dp_fwd_run(const float* x0, const float* dt, const float* coef, float rtol,
                      float atol, const float* z, const float* inv_ls,
                      const float* var, const float* omega, const float* phase,
                      const float* w, const float* nu, float* x5, float* err,
                      float* xs, int n, int din, int d, int m, int s, int dp, int rt,
                      int groups, int maxt, int* occupancy, void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  if (din != d || din < 1 || din > dp || m < 1 || s < 1 || n < 1 || groups < 1 ||
      32 * d * groups > maxt)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * d * groups;
  const int blocks = (n + rt - 1) / rt;
  const size_t smem = sizeof(float) * (size_t)fwd_smem_floats(dp, rt, 7, d * groups);
  cudaError_t e = cudaErrorInvalidValue;
#define X(DP_, RT_, MAXT_)                                                        \
  if (dp == DP_ && rt == RT_ && maxt == MAXT_) {                                  \
    e = prepare_kernel(dp_attempt_fwd_kernel<DP_, RT_, MAXT_>, threads, smem,     \
                       occupancy);                                                \
    if (e == cudaSuccess && !occupancy) {                                         \
      dp_attempt_fwd_kernel<DP_, RT_, MAXT_>                                      \
          <<<blocks, threads, smem, (cudaStream_t)stream>>>(                      \
              x0, dt, coef, rtol, atol, p, x5, err, xs, n, groups);               \
      e = cudaGetLastError();                                                     \
    }                                                                             \
  }
  DP_FWD_VARIANTS(X)
#undef X
  return (int)e;
}

extern "C" int gpode_dp_attempt_fwd(const float* x0, const float* dt,
                                    const float* coef, float rtol, float atol,
                                    const float* z, const float* inv_ls,
                                    const float* var, const float* omega,
                                    const float* phase, const float* w,
                                    const float* nu, float* x5, float* err,
                                    float* xs, int n, int din, int d, int m, int s,
                                    int dp, int rt, int groups, int maxt,
                                    void* stream) {
  return dp_fwd_run(x0, dt, coef, rtol, atol, z, inv_ls, var, omega, phase, w, nu,
                    x5, err, xs, n, din, d, m, s, dp, rt, groups, maxt, nullptr,
                    stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the forward kernel at this geometry; launches nothing.
extern "C" int gpode_dp_attempt_fwd_occupancy(int din, int d, int m, int s, int dp,
                                              int rt, int groups, int maxt,
                                              int* out) {
  return dp_fwd_run(nullptr, nullptr, nullptr, 0.f, 0.f, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    rt, din, d, m, s, dp, rt, groups, maxt, out, nullptr);
}

// The instantiated backward variants (DP, RT, MAXT), one per range of Din
// (<= 4, 5, <= 8, <= 16; ops/cuda_kernels.py picks the smallest DP >= Din):
// RT * DP is the width of the dx fold; MAXT bounds the block and with it the
// registers per thread (65536 / MAXT). Six stages leave registers for 6-row
// tiles at Din = 5.
#define DP_BWD_VARIANTS(X) X(4, 4, 640) X(5, 6, 640) X(8, 4, 512) X(16, 1, 512)

// The backward kernel and its fixed-order reduction on `stream`; with
// `occupancy` non-null nothing is launched and the kernel's occupancy_report
// at this geometry is written there instead.
static int dp_bwd_run(const float* xs, const float* g, const float* dt,
                      const float* coef, const float* z, const float* inv_ls,
                      const float* var, const float* omega, const float* phase,
                      const float* w, const float* nu, float* dx, float* part_main,
                      float* part_dz, float* out_main, float* out_dz, int n,
                      int din, int d, int m, int s, int rows_per_block, int dp, int rt,
                      int groups, int maxt, int* occupancy, void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  if (din != d || din < 1 || din > dp || m < 1 || s < 1 || groups < 1 ||
      32 * d * groups > maxt || rt < 1 || rows_per_block < rt ||
      rows_per_block % rt != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * d * groups;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem =
      sizeof(float) * (size_t)tile_smem_floats(
                          dp, rt, 6, 7, d * vjp_acc_floats(din, m, s), d * groups);
  cudaError_t e = cudaErrorInvalidValue;
#define X(DP_, RT_, MAXT_)                                                        \
  if (dp == DP_ && rt == RT_ && maxt == MAXT_) {                                  \
    e = prepare_kernel(dp_attempt_bwd_kernel<DP_, RT_, MAXT_>, threads, smem,     \
                       occupancy);                                                \
    if (e == cudaSuccess && !occupancy) {                                         \
      dp_attempt_bwd_kernel<DP_, RT_, MAXT_>                                      \
          <<<blocks, threads, smem, (cudaStream_t)stream>>>(                      \
              xs, g, dt, coef, p, dx, part_main, part_dz, n, rows_per_block,      \
              groups);                                                            \
      e = cudaGetLastError();                                                     \
    }                                                                             \
  }
  DP_BWD_VARIANTS(X)
#undef X
  if (e != cudaSuccess || occupancy) return (int)e;
  return (int)reduce_partials(p, blocks, part_main, part_dz, out_main, out_dz,
                              (cudaStream_t)stream);
}

extern "C" int gpode_dp_attempt_bwd(const float* xs, const float* g,
                                    const float* dt, const float* coef,
                                    const float* z, const float* inv_ls,
                                    const float* var, const float* omega,
                                    const float* phase, const float* w,
                                    const float* nu, float* dx,
                                    float* part_main, float* part_dz,
                                    float* out_main, float* out_dz, int n,
                                    int din, int d, int m, int s,
                                    int rows_per_block, int dp, int rt, int groups,
                                    int maxt, void* stream) {
  return dp_bwd_run(xs, g, dt, coef, z, inv_ls, var, omega, phase, w, nu, dx,
                    part_main, part_dz, out_main, out_dz, n, din, d, m, s,
                    rows_per_block, dp, rt, groups, maxt, nullptr, stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the backward kernel at this geometry; launches nothing.
extern "C" int gpode_dp_attempt_bwd_occupancy(int din, int d, int m, int s, int dp,
                                              int rt, int groups, int maxt,
                                              int* out) {
  return dp_bwd_run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, rt, din, d, m, s, rt, dp, rt, groups, maxt, out,
                    nullptr);
}
