// fused_rk4_segment for Hopper (sm_90a): `substeps` classic rk4 steps of the
// GPODE vector field over one shooting interval for every row (forward),
// and the reverse sweep of that stage chain (backward).
//
// Replaces gpode_tpu/ops/pallas_kernels.py `_fused_rk4_forward` (:698,
// pallas_call :720; body `_fused_rk4_kernel` :586 / `_rk4_stages` :568) and
// `_fused_rk4_bwd_pallas` (:733, pallas_call :756; body
// `_fused_rk4_bwd_kernel` :605).
//
// Bound: arithmetic — 4*substeps rhs evaluations per row forward and
// 4*substeps rhs VJPs per row backward (rhs_tile.cuh), against ~100 bytes of
// state per row. The state tile, the stage input and k1..k4 stay in shared
// memory for the whole interval; HBM sees x0 in and x(t1) plus the
// 4*substeps stage inputs (4*substeps, N, Din) out. The backward reads those
// stage inputs back instead of recomputing the chain. Stage i+1 needs all D
// components of k_i, so the block synchronises between stages: forward
// blocks are G groups of D warps (warp (grp, d) evaluates dim d of every
// G-th row of the tile), as in fused_dopri5.cu; backward blocks are D warps
// with per-warp parameter-cotangent accumulators, reduced across blocks in a
// fixed-order second pass (no float atomics).
//
// The step size is h = dt / substeps in float32 from the full-span dt, and
// the combine is x + h/6 * (k1 + 2 k2 + 2 k3 + k4) in that order, as in the
// JAX package's rk4 stepper. Requires D == Din.

#include "rhs_tile.cuh"

static __global__ void rk4_fwd_kernel(const float* __restrict__ x0,
                                      const float* __restrict__ dt_ptr,
                                      RhsParams p, float* __restrict__ x1_out,
                                      float* __restrict__ xs_out, int n,
                                      int substeps, int rows_per_block,
                                      int groups) {
  extern __shared__ float smem[];
  const int R = rows_per_block, din = p.din, D = p.d;
  float* xb = smem;            // (R, Din) state at the start of the step
  float* xi = xb + R * din;    // (R, Din) current stage input
  float* ks = xi + R * din;    // (4, R, D) stage derivatives
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp % D, grp = warp / D;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n - row0);
  const float h = *dt_ptr / (float)substeps;
  const float h2 = 0.5f * h, h6 = h / 6.f;
  const size_t plane = (size_t)n * din;  // one stage of xs_out
  const size_t off = (size_t)row0 * din;

  for (int i = threadIdx.x; i < rows * din; i += blockDim.x) xb[i] = x0[off + i];
  __syncthreads();

  for (int step = 0; step < substeps; ++step) {
    for (int st = 0; st < 4; ++st) {
      // stage inputs: x, x + h/2 k1, x + h/2 k2, x + h k3
      for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
        const int r = i / din, k = i % din;
        float v = xb[i];
        if (st > 0) v = xb[i] + (st == 3 ? h : h2) * ks[((st - 1) * R + r) * D + k];
        xi[i] = v;
        xs_out[(size_t)(4 * step + st) * plane + off + i] = v;
      }
      __syncthreads();
      for (int r = grp; r < rows; r += groups) {
        const float v = rhs_row_dim(p, xi + r * din, d, lane);
        if (lane == 0) ks[(st * R + r) * D + d] = v;
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
      const float* kr = ks + (i / din) * D + i % din;  // k_j at kr[j * R * D]
      xb[i] = xb[i] + h6 * (kr[0] + 2.f * kr[R * D] + 2.f * kr[2 * R * D] +
                            kr[3 * R * D]);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows * din; i += blockDim.x) x1_out[off + i] = xb[i];
}

static __global__ void rk4_bwd_kernel(const float* __restrict__ xs,
                                      const float* __restrict__ gy,
                                      const float* __restrict__ dt_ptr,
                                      RhsParams p, float* __restrict__ dx,
                                      float* __restrict__ part_main,
                                      float* __restrict__ part_dz, int n,
                                      int substeps, int rows_per_block) {
  extern __shared__ float smem[];
  const int R = rows_per_block, din = p.din, D = p.d;
  const int qa = vjp_acc_floats(din, p.m, p.s);
  float* xt = smem + D * qa;       // (4, R, Din) this step's stage inputs
  float* gx = xt + 4 * R * din;    // (4, R, Din) stage-input cotangents
  float* gt = gx + 4 * R * din;    // (R, Din) running cotangent of the state
  float* dxd = gt + R * din;       // (R, D, Din) per-dim dx shares
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n - row0);
  const float h = *dt_ptr / (float)substeps;
  const float h2 = 0.5f * h, h3 = h / 3.f, h6 = h / 6.f;
  const size_t plane = (size_t)n * din;
  const size_t off = (size_t)row0 * din;

  for (int i = threadIdx.x; i < D * qa; i += blockDim.x) smem[i] = 0.f;
  for (int i = threadIdx.x; i < rows * din; i += blockDim.x) gt[i] = gy[off + i];
  __syncthreads();

  VjpAcc acc;
  vjp_acc_init(acc, smem + d * qa, din, p.m, p.s);
  for (int step = substeps - 1; step >= 0; --step) {
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x)
      for (int st = 0; st < 4; ++st)
        xt[st * R * din + i] = xs[(size_t)(4 * step + st) * plane + off + i];
    __syncthreads();
    // cotangents of k4..k1: gk4 = h/6 g; gk3 = h/3 g + h gx4;
    // gk2 = h/3 g + h/2 gx3; gk1 = h/6 g + h/2 gx2
    for (int st = 3; st >= 0; --st) {
      for (int r = 0; r < rows; ++r) {
        const int e = r * din + d;  // (row, dim d) of g and gx; D == Din
        float c = (st == 0 || st == 3 ? h6 : h3) * gt[e];
        if (st < 3) c += (st == 2 ? h : h2) * gx[(st + 1) * R * din + e];
        rhs_vjp_row_dim(p, xt + (st * R + r) * din, d, c, lane, acc,
                        dxd + (r * D + d) * din);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
        const int r = i / din, k = i % din;
        float v = 0.f;
        for (int dd = 0; dd < D; ++dd) v += dxd[(r * D + dd) * din + k];
        gx[st * R * din + i] = v;
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x)
      gt[i] = gt[i] + gx[i] + gx[R * din + i] + gx[2 * R * din + i] +
              gx[3 * R * din + i];
    __syncthreads();
  }

  for (int i = threadIdx.x; i < rows * din; i += blockDim.x) dx[off + i] = gt[i];
  vjp_write_partials(p, acc, d, lane, blockIdx.x, part_main, part_dz);
}

extern "C" int gpode_rk4_fwd(const float* x0, const float* dt, const float* z,
                             const float* inv_ls, const float* var,
                             const float* omega, const float* phase,
                             const float* w, const float* nu, float* x1,
                             float* xs, int n, int din, int d, int m, int s,
                             int substeps, int rows_per_block, int groups,
                             void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * (size_t)rows_per_block * (2 * din + 4 * d);
  rk4_fwd_kernel<<<blocks, 32 * d * groups, smem, (cudaStream_t)stream>>>(
      x0, dt, p, x1, xs, n, substeps, rows_per_block, groups);
  return (int)cudaGetLastError();
}

extern "C" int gpode_rk4_bwd(const float* xs, const float* g, const float* dt,
                             const float* z, const float* inv_ls,
                             const float* var, const float* omega,
                             const float* phase, const float* w,
                             const float* nu, float* dx, float* part_main,
                             float* part_dz, float* out_main, float* out_dz,
                             int n, int din, int d, int m, int s, int substeps,
                             int rows_per_block, void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * ((size_t)d * vjp_acc_floats(din, m, s) +
                                       (size_t)rows_per_block *
                                           (9 * din + d * din));
  cudaError_t e = cudaFuncSetAttribute(
      rk4_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  rk4_bwd_kernel<<<blocks, 32 * d, smem, (cudaStream_t)stream>>>(
      xs, g, dt, p, dx, part_main, part_dz, n, substeps, rows_per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_partials(p, blocks, part_main, part_dz, out_main, out_dz,
                              (cudaStream_t)stream);
}
