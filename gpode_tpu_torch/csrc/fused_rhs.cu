// fused_rhs for Hopper (sm_90a): the decoupled-sampling GP vector field
//   f_d(x) = sum_s cos(x.Omega_d[:,s] + phi_d[s]) sqrt(2 var_d / S) w_d[s]
//          + sum_m nu_d[m] var_d exp(-1/2 sum_k ((x_k - z_mk) / ls_dk)^2)
// and its VJP (all eight cotangents). Din may differ from D.
//
// Replaces gpode_tpu/ops/pallas_kernels.py `_fused_rhs_forward` (:234,
// pallas_call :252) and `_fused_rhs_bwd_pallas` (:445, pallas_call :467).
//
// Bound: arithmetic (see rhs_tile.cuh); HBM sees x (and g) in and f (and
// dx) out only, the (N,S) features and (N,M) Gram live in registers. Both
// directions run on the row tile of the segment kernels: a block is G
// groups of D warps, warp (grp, d) owns every G-th 32-column unit of dim d
// and one column per lane, whose parameters it loads once per tile of RT
// rows.
//
// Forward: one block per tile, one `rhs_tile` call; the dim's warps meet in
// shared memory in group order and the thread of (row, d) writes f straight
// to out (N, D).
//
// Backward: a block walks rows_per_block rows in tiles of RT, one
// `rhs_vjp_tile` call per tile, its columns' cotangents accumulated in
// shared memory over all its tiles; the dx shares of all D * G warps are
// added in warp order. One slab per block, reduced across blocks in a
// fixed-order second pass (no float atomics). Ragged last tiles are masked
// by the row count, never padded.

#include "rhs_tile.cuh"

// Forward shared memory (floats): xt (RT, tile_stride(DP)) | il (D, DP) |
// red (warps, 32) the warps' row sums.
__host__ __device__ constexpr int rhs_fwd_smem_floats(int dp, int rt, int d,
                                                      int warps) {
  return rt * tile_stride(dp) + align4(d * dp) + 32 * warps;
}

template <int DP, int RT, int MAXT>
static __global__ void __launch_bounds__(MAXT)
rhs_fwd_kernel(const float* __restrict__ x, RhsParams p, float* __restrict__ out,
               int n, int groups) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.d;
  float* xt = smem;                                 // (RT, stride) rows of x
  float* ils = xt + RT * tile_stride(DP);           // (D, DP) 1 / lengthscale
  float* red = ils + align4(D * DP);                // (warps, 32) row sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp % D, grp = warp / D;
  const int row0 = blockIdx.x * RT;
  const int rows = min(RT, n - row0);

  tile_load_inv_ls<DP>(p, ils);
  tile_load_stages<DP, RT>(x, xt, 1, 0, row0, rows, p.din);
  __syncthreads();
  tile_stage<DP, RT>(p, xt, rows, d, grp, groups, lane, ils + d * DP,
                     red + warp * 32);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
    out[(size_t)row0 * D + i] = tile_rhs_sum<RT>(p, red, groups, i / D, i % D);
}

// Backward shared memory (floats): xt (RT, tile_stride(DP)) | gt (RT, D)
// the tile's rows of g | il (D, DP) | the accumulators (D * vjp_acc_floats)
// | dls (warps, DP, 32) lengthscale shares | dxw (warps, 32) dx shares.
__host__ __device__ constexpr int rhs_bwd_smem_floats(int dp, int rt, int d,
                                                      int acc_floats,
                                                      int warps) {
  return rt * tile_stride(dp) + align4(rt * d) + align4(d * dp) +
         align4(acc_floats) + 32 * dp * warps + 32 * warps;
}

template <int DP, int RT, int MAXT>
static __global__ void __launch_bounds__(MAXT)
rhs_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               RhsParams p, float* __restrict__ dx, float* __restrict__ part_main,
               float* __restrict__ part_dz, int n, int rows_per_block, int groups) {
  extern __shared__ __align__(16) float smem[];
  const int din = p.din, D = p.d;
  const int qa = vjp_acc_floats(din, p.m, p.s);
  const int warps = blockDim.x >> 5;
  float* xt = smem;                             // (RT, stride) rows of x
  float* gt = xt + RT * tile_stride(DP);        // (RT, D) rows of g
  float* ils = gt + align4(RT * D);             // (D, DP) 1 / lengthscale
  float* acc = ils + align4(D * DP);            // (D, qa) parameter cotangents
  float* dls = acc + align4(D * qa);            // (warps, DP, 32) lengthscale shares
  float* dxw = dls + 32 * DP * warps;           // (warps, 32) per-warp dx shares
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp % D, grp = warp / D;
  const int tile_end = min(n, (blockIdx.x + 1) * rows_per_block);

  for (int i = threadIdx.x; i < dxw - acc; i += blockDim.x) acc[i] = 0.f;
  tile_load_inv_ls<DP>(p, ils);

  for (int row0 = blockIdx.x * rows_per_block; row0 < tile_end; row0 += RT) {
    const int rows = min(RT, tile_end - row0);
    // the previous tile's VJP is past the barrier below; its dx pass reads
    // only dxw
    tile_load_stages<DP, RT>(x, xt, 1, 0, row0, rows, din);
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
      gt[i] = g[(size_t)row0 * D + i];
    __syncthreads();
    rhs_vjp_tile<DP, RT, true>(p, xt, gt + d, rows, d, grp, groups, lane,
                               acc + d * qa, ils + d * DP, dls + warp * DP * 32,
                               dxw + warp * 32);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x)
      dx[(size_t)row0 * din + i] = tile_dx_sum<DP>(dxw, warps, i / din, i % din);
  }
  tile_write_partials<DP>(p, acc, dls, groups, part_main, part_dz);
}

// The instantiated variants (DP, RT, MAXT), one per range of Din: DP bounds
// the loops over Din, RT is the tile's rows, MAXT bounds the block and with
// it the registers per thread (65536 / MAXT) and D (MAXT / 32 warps). Every
// one builds at 0 B of spill (ptxas; the forward <16, 4, 1024> spilled 4 B
// at its 64 registers).
#define RHS_FWD_VARIANTS(X) X(4, 8, 1024) X(5, 8, 1024) X(8, 8, 1024) X(16, 4, 512)
#define RHS_BWD_VARIANTS(X) X(4, 4, 640) X(5, 6, 640) X(8, 4, 512) X(16, 1, 512)

// The forward kernel on `stream`; with `occupancy` non-null nothing is
// launched and the kernel's occupancy_report at this geometry is written
// there instead.
static int rhs_fwd_run(const float* x, const float* z, const float* inv_ls,
                       const float* var, const float* omega, const float* phase,
                       const float* w, const float* nu, float* out, int n, int din,
                       int d, int m, int s, int dp, int rt, int groups, int maxt,
                       int* occupancy, void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  if (din < 1 || din > dp || d < 1 || m < 1 || s < 1 || n < 1 || groups < 1 ||
      32 * d * groups > maxt)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * d * groups;
  const int blocks = (n + rt - 1) / rt;
  const size_t smem = sizeof(float) * (size_t)rhs_fwd_smem_floats(dp, rt, d, d * groups);
  cudaError_t e = cudaErrorInvalidValue;
#define X(DP_, RT_, MAXT_)                                                        \
  if (dp == DP_ && rt == RT_ && maxt == MAXT_) {                                  \
    e = prepare_kernel(rhs_fwd_kernel<DP_, RT_, MAXT_>, threads, smem, occupancy); \
    if (e == cudaSuccess && !occupancy) {                                         \
      rhs_fwd_kernel<DP_, RT_, MAXT_><<<blocks, threads, smem,                    \
                                        (cudaStream_t)stream>>>(x, p, out, n,     \
                                                                groups);          \
      e = cudaGetLastError();                                                     \
    }                                                                             \
  }
  RHS_FWD_VARIANTS(X)
#undef X
  return (int)e;
}

extern "C" int gpode_fused_rhs_fwd(const float* x, const float* z,
                                   const float* inv_ls, const float* var,
                                   const float* omega, const float* phase,
                                   const float* w, const float* nu, float* out,
                                   int n, int din, int d, int m, int s, int dp,
                                   int rt, int groups, int maxt, void* stream) {
  return rhs_fwd_run(x, z, inv_ls, var, omega, phase, w, nu, out, n, din, d, m, s,
                     dp, rt, groups, maxt, nullptr, stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the forward kernel at this geometry; launches nothing.
extern "C" int gpode_fused_rhs_fwd_occupancy(int din, int d, int m, int s, int dp,
                                             int rt, int groups, int maxt,
                                             int* out) {
  return rhs_fwd_run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, rt, din, d, m, s, dp, rt, groups, maxt, out,
                     nullptr);
}

// The backward kernel and its fixed-order reduction on `stream`; with
// `occupancy` non-null nothing is launched and the kernel's occupancy_report
// at this geometry is written there instead.
static int rhs_bwd_run(const float* x, const float* g, const float* z,
                       const float* inv_ls, const float* var, const float* omega,
                       const float* phase, const float* w, const float* nu,
                       float* dx, float* part_main, float* part_dz, float* out_main,
                       float* out_dz, int n, int din, int d, int m, int s,
                       int rows_per_block, int dp, int rt, int groups, int maxt,
                       int* occupancy, void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  if (din < 1 || din > dp || d < 1 || m < 1 || s < 1 || n < 1 || groups < 1 ||
      32 * d * groups > maxt || rt < 1 || rows_per_block < rt ||
      rows_per_block % rt != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * d * groups;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem =
      sizeof(float) * (size_t)rhs_bwd_smem_floats(
                          dp, rt, d, d * vjp_acc_floats(din, m, s), d * groups);
  cudaError_t e = cudaErrorInvalidValue;
#define X(DP_, RT_, MAXT_)                                                        \
  if (dp == DP_ && rt == RT_ && maxt == MAXT_) {                                  \
    e = prepare_kernel(rhs_bwd_kernel<DP_, RT_, MAXT_>, threads, smem, occupancy); \
    if (e == cudaSuccess && !occupancy) {                                         \
      rhs_bwd_kernel<DP_, RT_, MAXT_>                                             \
          <<<blocks, threads, smem, (cudaStream_t)stream>>>(                      \
              x, g, p, dx, part_main, part_dz, n, rows_per_block, groups);        \
      e = cudaGetLastError();                                                     \
    }                                                                             \
  }
  RHS_BWD_VARIANTS(X)
#undef X
  if (e != cudaSuccess || occupancy) return (int)e;
  return (int)reduce_partials(p, blocks, part_main, part_dz, out_main, out_dz,
                              (cudaStream_t)stream);
}

extern "C" int gpode_fused_rhs_bwd(const float* x, const float* g,
                                   const float* z, const float* inv_ls,
                                   const float* var, const float* omega,
                                   const float* phase, const float* w,
                                   const float* nu, float* dx, float* part_main,
                                   float* part_dz, float* out_main,
                                   float* out_dz, int n, int din, int d, int m,
                                   int s, int rows_per_block, int dp, int rt,
                                   int groups, int maxt, void* stream) {
  return rhs_bwd_run(x, g, z, inv_ls, var, omega, phase, w, nu, dx, part_main,
                     part_dz, out_main, out_dz, n, din, d, m, s, rows_per_block, dp,
                     rt, groups, maxt, nullptr, stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the backward kernel at this geometry; launches nothing.
extern "C" int gpode_fused_rhs_bwd_occupancy(int din, int d, int m, int s, int dp,
                                             int rt, int groups, int maxt,
                                             int* out) {
  return rhs_bwd_run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     rt, din, d, m, s, rt, dp, rt, groups, maxt, out, nullptr);
}
