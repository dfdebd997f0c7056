// Shared device code for the GPODE Hopper kernels (fused_rhs.cu,
// fused_dopri5.cu): the sampled-vector-field rhs for one (row, output dim),
// its VJP, and the fixed-order reduction of per-block parameter cotangents.
//
// Replaces the tile functions of gpode_tpu/ops/pallas_kernels.py:
// `_rhs_tile` (:200) and `_rhs_vjp_tile` (:274, the VPU loop form).
//
// What bounds this work on an H100: arithmetic. One rhs evaluation of one
// row costs D*(S*(2*Din+3) + M*(3*Din+3)) flops and D*(S+M) cos/exp against
// a few hundred bytes of state; the parameters (Omega, phase, w, Z, nu:
// ~40 KB at S=256, M=100, D=5) are shared by every row and stay in L1/L2.
// Design: one warp owns one (row, output dim d); its 32 lanes split the S
// random features and the M inducing points, then combine with xor-shuffle
// sums. Every lane of a butterfly ends with the bit-identical sum, so no
// broadcast is needed and results do not depend on the lane.
//
// Parameter cotangents (the VJP): the TPU kernel summed them across its
// sequential grid with `+=` into one output block. Hopper blocks run
// concurrently, so here every warp keeps its own accumulators in shared
// memory — lane l owns features l, l+32, ... and inducing points l, l+32,
// ..., so no two lanes touch one address — writes them as a per-block slab,
// and `sum_slabs_kernel` adds the slabs in block order. No float atomics:
// results are bit-reproducible run to run.
//
// cos/exp are the accurate libm versions (no --use_fast_math): the phase
// x.Omega + phi reaches far beyond pi, where __cosf loses digits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define GPODE_MAX_DIN 16

// Draw and kernel operands in the kernel layout (the Python wrapper makes
// it): z (M, Din), inv_ls (D, Din) = 1/lengthscale, var (D,),
// omega (D, Din, S), phase (D, S), w (D, S), nu (D, M). All row-major f32.
struct RhsParams {
  const float* z;
  const float* inv_ls;
  const float* var;
  const float* omega;
  const float* phase;
  const float* w;
  const float* nu;
  int din, d, m, s;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// f_d(x) for one row x (Din values, any memory space). Every lane returns it.
__device__ __forceinline__ float rhs_row_dim(const RhsParams& p, const float* x,
                                             int d, int lane) {
  const float* om = p.omega + (size_t)d * p.din * p.s;
  const float* ph = p.phase + (size_t)d * p.s;
  const float* wd = p.w + (size_t)d * p.s;
  float acc_f = 0.f;
  for (int s = lane; s < p.s; s += 32) {
    float xo = 0.f;
    for (int k = 0; k < p.din; ++k) xo = fmaf(x[k], om[(size_t)k * p.s + s], xo);
    acc_f = fmaf(cosf(xo + ph[s]), wd[s], acc_f);
  }
  const float* il = p.inv_ls + d * p.din;
  const float* nud = p.nu + (size_t)d * p.m;
  float acc_g = 0.f;
  for (int j = lane; j < p.m; j += 32) {
    const float* zj = p.z + (size_t)j * p.din;
    float sq = 0.f;
    for (int k = 0; k < p.din; ++k) {
      float t = (x[k] - zj[k]) * il[k];
      sq = fmaf(t, t, sq);
    }
    acc_g = fmaf(expf(-0.5f * sq), nud[j], acc_g);
  }
  const float vd = p.var[d];
  const float scale = sqrtf(2.f * vd / (float)p.s);
  return scale * warp_sum(acc_f) + vd * warp_sum(acc_g);
}

// Floats of one warp's shared-memory accumulators.
__host__ __device__ __forceinline__ int vjp_acc_floats(int din, int m, int s) {
  return din * s + 2 * s + m + m * din;
}
// Floats of one (block, output dim) slab of the "main" cotangents:
// domega (Din*S), dphase (S), dw (S), dnu (M), dls (Din), dvar (1).
__host__ __device__ __forceinline__ int main_slab_floats(int din, int m, int s) {
  return din * s + 2 * s + m + din + 1;
}

// Per-warp VJP state: shared-memory accumulators for one output dim, plus
// lane-local registers for the few per-dim scalars.
struct VjpAcc {
  float* domega;  // (Din, S)
  float* dphase;  // (S)
  float* dw;      // (S)
  float* dnu;     // (M)
  float* dz;      // (M, Din)
  float dls[GPODE_MAX_DIN];
  float dvar_rff;   // sum cos * dphi      (times scale / (2 var) at the end)
  float dvar_gram;  // sum dgram * gram    (divided by var at the end)
};

__device__ __forceinline__ void vjp_acc_init(VjpAcc& a, float* base, int din,
                                             int m, int s) {
  a.domega = base;
  a.dphase = a.domega + din * s;
  a.dw = a.dphase + s;
  a.dnu = a.dw + s;
  a.dz = a.dnu + m;
#pragma unroll
  for (int k = 0; k < GPODE_MAX_DIN; ++k) a.dls[k] = 0.f;
  a.dvar_rff = 0.f;
  a.dvar_gram = 0.f;
}

// VJP of f_d at row x with cotangent g: accumulates the parameter
// cotangents into `a` and writes this dim's share of dx (Din values) to
// dx_out from lane 0.
__device__ __forceinline__ void rhs_vjp_row_dim(const RhsParams& p, const float* x,
                                                int d, float g, int lane,
                                                VjpAcc& a, float* dx_out) {
  float dx[GPODE_MAX_DIN];
#pragma unroll
  for (int k = 0; k < GPODE_MAX_DIN; ++k) dx[k] = 0.f;
  const float vd = p.var[d];
  const float scale = sqrtf(2.f * vd / (float)p.s);

  const float* om = p.omega + (size_t)d * p.din * p.s;
  const float* ph = p.phase + (size_t)d * p.s;
  const float* wd = p.w + (size_t)d * p.s;
  for (int s = lane; s < p.s; s += 32) {
    float xo = 0.f;
    for (int k = 0; k < p.din; ++k) xo = fmaf(x[k], om[(size_t)k * p.s + s], xo);
    float sn, c;
    sincosf(xo + ph[s], &sn, &c);
    const float dphi = g * wd[s];
    const float dxo = -sn * scale * dphi;
    a.dw[s] += c * scale * g;
    a.dphase[s] += dxo;
    a.dvar_rff += c * dphi;
#pragma unroll
    for (int k = 0; k < GPODE_MAX_DIN; ++k) {
      if (k < p.din) {
        a.domega[k * p.s + s] += x[k] * dxo;
        dx[k] = fmaf(dxo, om[(size_t)k * p.s + s], dx[k]);
      }
    }
  }

  const float* il = p.inv_ls + d * p.din;
  const float* nud = p.nu + (size_t)d * p.m;
  for (int j = lane; j < p.m; j += 32) {
    const float* zj = p.z + (size_t)j * p.din;
    float sq = 0.f;
    for (int k = 0; k < p.din; ++k) {
      float t = (x[k] - zj[k]) * il[k];
      sq = fmaf(t, t, sq);
    }
    const float gram = vd * expf(-0.5f * sq);
    const float dgram = g * nud[j];
    a.dnu[j] += gram * g;
    a.dvar_gram += dgram * gram;
    const float dsq = -0.5f * gram * dgram;
#pragma unroll
    for (int k = 0; k < GPODE_MAX_DIN; ++k) {
      if (k < p.din) {
        const float diff = x[k] - zj[k];
        const float ik2 = il[k] * il[k];
        const float wsq = dsq * diff;
        dx[k] += 2.f * ik2 * wsq;
        a.dz[j * p.din + k] += -2.f * ik2 * wsq;
        a.dls[k] += -2.f * ik2 * il[k] * wsq * diff;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < GPODE_MAX_DIN; ++k) {
    if (k < p.din) {
      const float v = warp_sum(dx[k]);
      if (lane == 0) dx_out[k] = v;
    }
  }
}

// Write one warp's accumulators as the (block, d) slabs of the partial
// buffers: part_main (blocks, D, main_slab_floats), part_dz (blocks, D, M*Din).
__device__ __forceinline__ void vjp_write_partials(const RhsParams& p, VjpAcc& a,
                                                   int d, int lane, int block,
                                                   float* part_main,
                                                   float* part_dz) {
  __syncwarp();  // lanes now read accumulators that other lanes wrote
  const int qm = main_slab_floats(p.din, p.m, p.s);
  float* pm = part_main + ((size_t)block * p.d + d) * qm;
  const int n_dense = p.din * p.s + 2 * p.s + p.m;  // domega|dphase|dw|dnu
  for (int i = lane; i < n_dense; i += 32) pm[i] = a.domega[i];
#pragma unroll
  for (int k = 0; k < GPODE_MAX_DIN; ++k) {
    if (k < p.din) {
      const float v = warp_sum(a.dls[k]);
      if (lane == 0) pm[n_dense + k] = v;
    }
  }
  const float vd = p.var[d];
  const float scale = sqrtf(2.f * vd / (float)p.s);
  const float rff = warp_sum(a.dvar_rff);
  const float gram = warp_sum(a.dvar_gram);
  if (lane == 0) pm[n_dense + p.din] = rff * scale / (2.f * vd) + gram / vd;
  float* pz = part_dz + ((size_t)block * p.d + d) * p.m * p.din;
  for (int i = lane; i < p.m * p.din; i += 32) pz[i] = a.dz[i];
}

// out[j] = sum_b part[b * len + j], b ascending: the fixed-order second
// pass that replaces the TPU kernel's sequential-grid accumulation.
static __global__ void sum_slabs_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, int nslabs,
                                        int len) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float v = 0.f;
  for (int b = 0; b < nslabs; ++b) v += part[(size_t)b * len + j];
  out[j] = v;
}

// Reduce both partial buffers into out_main (D, main_slab) and out_dz (M*Din).
static cudaError_t reduce_partials(const RhsParams& p, int blocks,
                                   const float* part_main, const float* part_dz,
                                   float* out_main, float* out_dz,
                                   cudaStream_t stream) {
  const int len_main = p.d * main_slab_floats(p.din, p.m, p.s);
  sum_slabs_kernel<<<(len_main + 255) / 256, 256, 0, stream>>>(
      part_main, out_main, blocks, len_main);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int len_dz = p.m * p.din;
  sum_slabs_kernel<<<(len_dz + 255) / 256, 256, 0, stream>>>(
      part_dz, out_dz, blocks * p.d, len_dz);
  return cudaGetLastError();
}

static inline RhsParams make_params(const float* z, const float* inv_ls,
                                    const float* var, const float* omega,
                                    const float* phase, const float* w,
                                    const float* nu, int din, int d, int m,
                                    int s) {
  RhsParams p;
  p.z = z; p.inv_ls = inv_ls; p.var = var; p.omega = omega;
  p.phase = phase; p.w = w; p.nu = nu;
  p.din = din; p.d = d; p.m = m; p.s = s;
  return p;
}
