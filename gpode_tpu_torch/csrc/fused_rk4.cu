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
// state per row. HBM sees x0 in and x(t1) plus the 4*substeps stage inputs
// (4*substeps, N, Din) out; the backward reads those stage inputs back
// instead of recomputing the chain. Stage i+1 needs all D components of k_i,
// so a block synchronises between stages.
//
// Forward: the state tile, the stage input and k1..k4 stay in shared memory
// for the whole interval; blocks are G groups of D warps (warp (grp, d)
// evaluates dim d of every G-th row of the tile), as in fused_dopri5.cu.
//
// Backward: as the dopri5 attempt's (fused_dopri5.cu), the time is the
// latency of the accurate sincosf/expf, and the design is the same: a block
// of G groups of D warps walks its rows in tiles of RT; per tile and step the
// four stage inputs, their cotangents, the running state cotangent and the
// cotangent of the current stage's k sit in shared memory, and each stage is
// one `rhs_vjp_tile` call (rhs_tile.cuh) in which every warp takes all RT
// rows for its own columns. The threads that sum a stage's dx over the warps
// (in warp order) form the next stage's cotangent in the same pass. All
// 4*substeps VJPs of a tile run in one block: one slab per block, reduced
// across blocks in a fixed-order second pass (no float atomics).
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

// h = dt / substeps, read where it is used so that it holds no register
// across the VJP.
__device__ __forceinline__ float rk4_step(const float* dt_ptr, int substeps) {
  return *dt_ptr / (float)substeps;
}

// Backward: shared memory as TileSmem<DP, RT, 4, 6> (rhs_tile.cuh): planes
// 0..3 the stage-input cotangents gx, plane 4 the running cotangent gt of
// the state, plane 5 the cotangent `cot` of the stage's k.
template <int DP, int RT, int MAXT>
static __global__ void __launch_bounds__(MAXT)
rk4_bwd_kernel(const float* __restrict__ xs, const float* __restrict__ gy,
               const float* __restrict__ dt_ptr, RhsParams p,
               float* __restrict__ dx, float* __restrict__ part_main,
               float* __restrict__ part_dz, int n, int substeps,
               int rows_per_block, int groups) {
  extern __shared__ __align__(16) float smem[];
  using L = TileSmem<DP, RT, 4, 6>;
  constexpr int GQ = tile_plane<DP, RT>();
  const int din = p.din, D = p.d;
  const int qa = vjp_acc_floats(din, p.m, p.s);
  const int warps = blockDim.x >> 5;
  float* xt = smem + L::xt;            // (4, RT, stride) this step's stage inputs
  float* gx = smem + L::planes;        // (4, GQ) stage-input cotangents
  float* gt = gx + 4 * GQ;             // (GQ) running cotangent of the state
  float* cot = gt + GQ;                // (GQ) cotangent of the stage's k
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
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
      gt[i] = gy[(size_t)row0 * din + i];
      cot[i] = rk4_step(dt_ptr, substeps) / 6.f * gt[i];
    }

#pragma unroll 1
    for (int step = substeps - 1; step >= 0; --step) {
      tile_load_stages<DP, RT>(xs + (size_t)(4 * step) * n * din, xt, 4,
                               (size_t)n * din, row0, rows, din);
      __syncthreads();
      // cotangents of k4..k1, each formed where the next stage input's
      // cotangent is summed: gk4 = h/6 g; gk3 = h/3 g + h gx4;
      // gk2 = h/3 g + h/2 gx3; gk1 = h/6 g + h/2 gx2
#pragma unroll 1
      for (int st = 3; st >= 0; --st) {
        rhs_vjp_tile<DP, RT>(p, xt + st * RT * tile_stride(DP), cot + d, rows, d,
                             grp, groups, lane, acc + d * qa, ils + d * DP,
                             dls + warp * DP * 32, dxw + warp * 32);
        __syncthreads();
        for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
          const float v = tile_dx_sum<DP>(dxw, warps, i / din, i % din);
          gx[st * GQ + i] = v;
          const float h = rk4_step(dt_ptr, substeps);
          if (st > 0)
            cot[i] = (st == 1 ? h / 6.f : h / 3.f) * gt[i] +
                     (st == 3 ? h : 0.5f * h) * v;
        }
        __syncthreads();
      }
      for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
        gt[i] = gt[i] + gx[i] + gx[GQ + i] + gx[2 * GQ + i] + gx[3 * GQ + i];
        cot[i] = rk4_step(dt_ptr, substeps) / 6.f * gt[i];
      }
      // the next step's loads and first stage read gt / cot only after a barrier
    }

    __syncthreads();
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x)
      dx[(size_t)row0 * din + i] = gt[i];
    __syncthreads();  // the next tile overwrites gt / cot
  }
  tile_write_partials<DP>(p, acc, dls, groups, part_main, part_dz);
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

// The instantiated backward variants (DP, RT, MAXT), one per range of Din as
// in fused_dopri5.cu; MAXT bounds the block and with it the registers per
// thread (65536 / MAXT). At Din = 5 a 6-row tile would spill here, so 4 rows.
#define RK4_BWD_VARIANTS(X) X(4, 4, 640) X(5, 4, 640) X(8, 4, 512) X(16, 1, 512)

template <int DP, int RT, int MAXT>
static cudaError_t rk4_bwd_prepare(int threads, size_t smem, int* occupancy) {
  if (occupancy)
    return occupancy_report(rk4_bwd_kernel<DP, RT, MAXT>, threads, smem, occupancy);
  return cudaFuncSetAttribute(rk4_bwd_kernel<DP, RT, MAXT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The backward kernel and its fixed-order reduction on `stream`; with
// `occupancy` non-null nothing is launched and the kernel's occupancy_report
// at this geometry is written there instead.
static int rk4_bwd_run(const float* xs, const float* g, const float* dt,
                       const float* z, const float* inv_ls, const float* var,
                       const float* omega, const float* phase, const float* w,
                       const float* nu, float* dx, float* part_main,
                       float* part_dz, float* out_main, float* out_dz, int n,
                       int din, int d, int m, int s, int substeps,
                       int rows_per_block, int dp, int rt, int groups, int maxt,
                       int* occupancy, void* stream) {
  const RhsParams p = make_params(z, inv_ls, var, omega, phase, w, nu, din, d, m, s);
  if (din != d || din < 1 || din > dp || m < 1 || s < 1 || substeps < 1 ||
      groups < 1 || 32 * d * groups > maxt || rt < 1 || rows_per_block < rt ||
      rows_per_block % rt != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * d * groups;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem =
      sizeof(float) * (size_t)tile_smem_floats(
                          dp, rt, 4, 6, d * vjp_acc_floats(din, m, s), d * groups);
  cudaError_t e = cudaErrorInvalidValue;
#define X(DP_, RT_, MAXT_)                                                        \
  if (dp == DP_ && rt == RT_ && maxt == MAXT_) {                                  \
    e = rk4_bwd_prepare<DP_, RT_, MAXT_>(threads, smem, occupancy);               \
    if (e == cudaSuccess && !occupancy) {                                         \
      rk4_bwd_kernel<DP_, RT_, MAXT_>                                             \
          <<<blocks, threads, smem, (cudaStream_t)stream>>>(                      \
              xs, g, dt, p, dx, part_main, part_dz, n, substeps, rows_per_block,  \
              groups);                                                            \
      e = cudaGetLastError();                                                     \
    }                                                                             \
  }
  RK4_BWD_VARIANTS(X)
#undef X
  if (e != cudaSuccess || occupancy) return (int)e;
  return (int)reduce_partials(p, blocks, part_main, part_dz, out_main, out_dz,
                              (cudaStream_t)stream);
}

extern "C" int gpode_rk4_bwd(const float* xs, const float* g, const float* dt,
                             const float* z, const float* inv_ls,
                             const float* var, const float* omega,
                             const float* phase, const float* w,
                             const float* nu, float* dx, float* part_main,
                             float* part_dz, float* out_main, float* out_dz,
                             int n, int din, int d, int m, int s, int substeps,
                             int rows_per_block, int dp, int rt, int groups, int maxt,
                             void* stream) {
  return rk4_bwd_run(xs, g, dt, z, inv_ls, var, omega, phase, w, nu, dx, part_main,
                     part_dz, out_main, out_dz, n, din, d, m, s, substeps,
                     rows_per_block, dp, rt, groups, maxt, nullptr, stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the backward kernel at this geometry; launches nothing.
extern "C" int gpode_rk4_bwd_occupancy(int din, int d, int m, int s, int dp, int rt,
                                       int groups, int maxt, int* out) {
  return rk4_bwd_run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, rt, din, d, m, s, 1, rt, dp, rt, groups, maxt, out,
                     nullptr);
}
