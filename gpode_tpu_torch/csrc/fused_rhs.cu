// fused_rhs for Hopper (sm_90a): the decoupled-sampling GP vector field
//   f_d(x) = sum_s cos(x.Omega_d[:,s] + phi_d[s]) sqrt(2 var_d / S) w_d[s]
//          + sum_m nu_d[m] var_d exp(-1/2 sum_k ((x_k - z_mk) / ls_dk)^2)
// and its VJP (all eight cotangents).
//
// Replaces gpode_tpu/ops/pallas_kernels.py `_fused_rhs_forward` (:234,
// pallas_call :252) and `_fused_rhs_bwd_pallas` (:445, pallas_call :467).
//
// Bound: arithmetic (see rhs_tile.cuh); HBM sees x in and f out only, the
// (N,S) features and (N,M) Gram live in registers. Forward: a block takes a
// tile of rows; its D*G warps are G groups of D, warp (grp, d) computes f_d
// for every G-th row of the tile. Backward: a block of D warps, warp d
// accumulates dim d's parameter cotangents over the tile in shared memory;
// the per-dim dx shares meet in shared memory and are summed over d in order.
// Ragged last tiles are masked by the row count, never padded.

#include "rhs_tile.cuh"

static __global__ void fused_rhs_fwd_kernel(const float* __restrict__ x,
                                            RhsParams p, float* __restrict__ out,
                                            int n, int rows_per_block,
                                            int groups) {
  extern __shared__ float smem[];  // x tile (rows_per_block, Din)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp % p.d, grp = warp / p.d;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  for (int i = threadIdx.x; i < rows * p.din; i += blockDim.x)
    smem[i] = x[(size_t)row0 * p.din + i];
  __syncthreads();
  for (int r = grp; r < rows; r += groups) {
    const float v = rhs_row_dim(p, smem + r * p.din, d, lane);
    if (lane == 0) out[(size_t)(row0 + r) * p.d + d] = v;
  }
}

static __global__ void fused_rhs_bwd_kernel(const float* __restrict__ x,
                                            const float* __restrict__ g,
                                            RhsParams p, float* __restrict__ dx,
                                            float* __restrict__ part_main,
                                            float* __restrict__ part_dz, int n,
                                            int rows_per_block) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp;
  const int qa = vjp_acc_floats(p.din, p.m, p.s);
  const int R = rows_per_block;
  float* xs = smem + p.d * qa;      // (R, Din)
  float* gs = xs + R * p.din;       // (R, D)
  float* dxd = gs + R * p.d;        // (R, D, Din) per-dim dx shares
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n - row0);
  for (int i = threadIdx.x; i < p.d * qa; i += blockDim.x) smem[i] = 0.f;
  for (int i = threadIdx.x; i < rows * p.din; i += blockDim.x)
    xs[i] = x[(size_t)row0 * p.din + i];
  for (int i = threadIdx.x; i < rows * p.d; i += blockDim.x)
    gs[i] = g[(size_t)row0 * p.d + i];
  __syncthreads();

  VjpAcc acc;
  vjp_acc_init(acc, smem + d * qa, p.din, p.m, p.s);
  for (int r = 0; r < rows; ++r)
    rhs_vjp_row_dim(p, xs + r * p.din, d, gs[r * p.d + d], lane, acc,
                    dxd + (r * p.d + d) * p.din);
  __syncthreads();

  for (int i = threadIdx.x; i < rows * p.din; i += blockDim.x) {
    const int r = i / p.din, k = i % p.din;
    float v = 0.f;
    for (int dd = 0; dd < p.d; ++dd) v += dxd[(r * p.d + dd) * p.din + k];
    dx[(size_t)row0 * p.din + i] = v;
  }
  vjp_write_partials(p, acc, d, lane, blockIdx.x, part_main, part_dz);
}

extern "C" int gpode_fused_rhs_fwd(const float* x, const float* z,
                                   const float* inv_ls, const float* var,
                                   const float* omega, const float* phase,
                                   const float* w, const float* nu, float* out,
                                   int n, int din, int d, int m, int s,
                                   int rows_per_block, int groups,
                                   void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * rows_per_block * din;
  fused_rhs_fwd_kernel<<<blocks, 32 * d * groups, smem, (cudaStream_t)stream>>>(
      x, p, out, n, rows_per_block, groups);
  return (int)cudaGetLastError();
}

extern "C" int gpode_fused_rhs_bwd(const float* x, const float* g,
                                   const float* z, const float* inv_ls,
                                   const float* var, const float* omega,
                                   const float* phase, const float* w,
                                   const float* nu, float* dx, float* part_main,
                                   float* part_dz, float* out_main,
                                   float* out_dz, int n, int din, int d, int m,
                                   int s, int rows_per_block, void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * ((size_t)d * vjp_acc_floats(din, m, s) +
                                       (size_t)rows_per_block * (din + d + d * din));
  cudaError_t e = cudaFuncSetAttribute(
      fused_rhs_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_rhs_bwd_kernel<<<blocks, 32 * d, smem, (cudaStream_t)stream>>>(
      x, g, p, dx, part_main, part_dz, n, rows_per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_partials(p, blocks, part_main, part_dz, out_main, out_dz,
                              (cudaStream_t)stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the backward kernel at this geometry; launches nothing.
extern "C" int gpode_fused_rhs_bwd_occupancy(int din, int d, int m, int s,
                                             int rows_per_block, int* out) {
  const size_t smem = sizeof(float) * ((size_t)d * vjp_acc_floats(din, m, s) +
                                       (size_t)rows_per_block * (din + d + d * din));
  return (int)occupancy_report(fused_rhs_bwd_kernel, 32 * d, smem, out);
}
