// fused_dopri5_attempt for Hopper (sm_90a): one whole-span Dormand-Prince
// step of the GPODE vector field for every row (forward), and the reverse
// sweep of its 5th-order chain (backward).
//
// Replaces gpode_tpu/ops/pallas_kernels.py `_fused_dp_forward` (:958,
// pallas_call :979; body `_fused_dp_attempt_kernel` :859) and `_fused_dp_bwd`
// (:1003, pallas_call :1027; body `_fused_dp_attempt_bwd_kernel` :879).
//
// Bound: arithmetic — 7 rhs evaluations per row forward, 6 rhs VJPs per row
// backward (rhs_tile.cuh), against ~100 bytes of state per row. The state
// tile, all seven stage derivatives and the stage cotangents stay in shared
// memory for the whole step; HBM sees x0 in and x5, err and the six stage
// inputs (6,N,Din) out. The backward reads those stage inputs back instead
// of recomputing the chain. Stage i+1 needs all D components of k_i, so the
// block synchronises between stages: forward blocks are G groups of D warps
// (warp (grp, d) evaluates dim d of every G-th row of the tile); backward
// blocks are D warps with per-warp parameter-cotangent accumulators, reduced
// across blocks in a fixed-order second pass (no float atomics).
//
// The tableau arrives as `coef` (A 7x7 row-major | b5 (7) | b5 - b4 (7)),
// made from the port's single copy in gpode_tpu_torch/ops/ode.py, so an
// accepted attempt is the adaptive solver's first step. Requires D == Din.

#include "rhs_tile.cuh"

#define DP_B5 49
#define DP_E 56

static __global__ void dp_attempt_fwd_kernel(
    const float* __restrict__ x0, const float* __restrict__ dt_ptr,
    const float* __restrict__ coef, float rtol, float atol, RhsParams p,
    float* __restrict__ x5_out, float* __restrict__ err_out,
    float* __restrict__ xs_out, int n, int rows_per_block, int groups) {
  extern __shared__ float smem[];
  const int R = rows_per_block, din = p.din, D = p.d;
  float* xb = smem;             // (R, Din) x0 tile
  float* xi = xb + R * din;     // (R, Din) current stage input
  float* ks = xi + R * din;     // (7, R, D) stage derivatives
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp % D, grp = warp / D;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n - row0);
  const float dt = *dt_ptr;
  const size_t plane = (size_t)n * din;  // one stage of xs_out

  for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
    const float v = x0[(size_t)row0 * din + i];
    xb[i] = v;
    xi[i] = v;
    xs_out[(size_t)row0 * din + i] = v;
  }
  __syncthreads();

  for (int st = 0; st < 6; ++st) {
    for (int r = grp; r < rows; r += groups) {
      const float v = rhs_row_dim(p, xi + r * din, d, lane);
      if (lane == 0) ks[(st * R + r) * D + d] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
      const int r = i / din, k = i % din;
      float acc = 0.f;
      if (st < 5) {  // next stage input: x + dt * sum_j a[st+1][j] k_j
        for (int j = 0; j <= st; ++j)
          acc += coef[(st + 1) * 7 + j] * ks[(j * R + r) * D + k];
        xi[i] = xb[i] + dt * acc;
        xs_out[(st + 1) * plane + (size_t)row0 * din + i] = xi[i];
      } else {       // 5th-order endpoint: x + dt * sum_{b5_j != 0} b5_j k_j
        for (int j = 0; j < 6; ++j) {
          const float b = coef[DP_B5 + j];
          if (b != 0.f) acc += b * ks[(j * R + r) * D + k];
        }
        xi[i] = xb[i] + dt * acc;
      }
    }
    __syncthreads();
  }

  for (int r = grp; r < rows; r += groups) {  // k7 = f(x5), error estimate only
    const float v = rhs_row_dim(p, xi + r * din, d, lane);
    if (lane == 0) ks[(6 * R + r) * D + d] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
    const int r = i / din, k = i % din;
    float acc = 0.f;
    for (int j = 0; j < 7; ++j) acc += coef[DP_E + j] * ks[(j * R + r) * D + k];
    const float x5 = xi[i];
    const float scale = atol + rtol * fmaxf(fabsf(xb[i]), fabsf(x5));
    x5_out[(size_t)row0 * din + i] = x5;
    err_out[(size_t)row0 * din + i] = dt * acc / scale;
  }
}

static __global__ void dp_attempt_bwd_kernel(
    const float* __restrict__ xs, const float* __restrict__ gy,
    const float* __restrict__ dt_ptr, const float* __restrict__ coef,
    RhsParams p, float* __restrict__ dx, float* __restrict__ part_main,
    float* __restrict__ part_dz, int n, int rows_per_block) {
  extern __shared__ float smem[];
  const int R = rows_per_block, din = p.din, D = p.d;
  const int qa = vjp_acc_floats(din, p.m, p.s);
  float* xt = smem + D * qa;        // (6, R, Din) saved stage inputs
  float* gk = xt + 6 * R * din;     // (6, R, D) stage cotangents
  float* gxt = gk + 6 * R * D;      // (R, Din) running dx
  float* dxd = gxt + R * din;       // (R, D, Din) per-dim dx shares
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n - row0);
  const float dt = *dt_ptr;
  const size_t plane = (size_t)n * din;

  for (int i = threadIdx.x; i < D * qa; i += blockDim.x) smem[i] = 0.f;
  for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
    for (int st = 0; st < 6; ++st)
      xt[st * R * din + i] = xs[st * plane + (size_t)row0 * din + i];
    const float g = gy[(size_t)row0 * din + i];
    gxt[i] = g;
    for (int st = 0; st < 6; ++st) gk[st * R * D + i] = dt * coef[DP_B5 + st] * g;
  }
  __syncthreads();

  VjpAcc acc;
  vjp_acc_init(acc, smem + d * qa, din, p.m, p.s);
  for (int st = 5; st >= 0; --st) {
    for (int r = 0; r < rows; ++r)
      rhs_vjp_row_dim(p, xt + (st * R + r) * din, d, gk[(st * R + r) * D + d],
                      lane, acc, dxd + (r * D + d) * din);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
      const int r = i / din, k = i % din;
      float gxi = 0.f;
      for (int dd = 0; dd < D; ++dd) gxi += dxd[(r * D + dd) * din + k];
      gxt[i] += gxi;
      for (int j = 0; j < st; ++j) {
        const float a = coef[st * 7 + j];
        if (a != 0.f) gk[(j * R + r) * D + k] += dt * a * gxi;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < rows * din; i += blockDim.x)
    dx[(size_t)row0 * din + i] = gxt[i];
  vjp_write_partials(p, acc, d, lane, blockIdx.x, part_main, part_dz);
}

extern "C" int gpode_dp_attempt_fwd(const float* x0, const float* dt,
                                    const float* coef, float rtol, float atol,
                                    const float* z, const float* inv_ls,
                                    const float* var, const float* omega,
                                    const float* phase, const float* w,
                                    const float* nu, float* x5, float* err,
                                    float* xs, int n, int din, int d, int m,
                                    int s, int rows_per_block, int groups,
                                    void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * (size_t)rows_per_block * (2 * din + 7 * d);
  dp_attempt_fwd_kernel<<<blocks, 32 * d * groups, smem, (cudaStream_t)stream>>>(
      x0, dt, coef, rtol, atol, p, x5, err, xs, n, rows_per_block, groups);
  return (int)cudaGetLastError();
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
                                    int rows_per_block, void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * ((size_t)d * vjp_acc_floats(din, m, s) +
                                       (size_t)rows_per_block *
                                           (7 * din + 6 * d + d * din));
  cudaError_t e = cudaFuncSetAttribute(
      dp_attempt_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dp_attempt_bwd_kernel<<<blocks, 32 * d, smem, (cudaStream_t)stream>>>(
      xs, g, dt, coef, p, dx, part_main, part_dz, n, rows_per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_partials(p, blocks, part_main, part_dz, out_main, out_dz,
                              (cudaStream_t)stream);
}
