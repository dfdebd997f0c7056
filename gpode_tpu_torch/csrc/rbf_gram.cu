// rbf_gram for Hopper (sm_90a): the dimwise RBF cross-Gram
//   K[d, n, m] = var[d] exp(-1/2 sum_k (x[n,k]/ls[d,k] - z[m,k]/ls[d,k])^2)
// x (N, Din), z (M, Din), inv_ls (D, Din) = 1/lengthscale, var (D,)
// -> K (D, N, M), float32, forward only.
//
// Replaces gpode_tpu/ops/pallas_kernels.py `rbf_gram_pallas` (:165,
// pallas_call :178; tile body `_rbf_gram_kernel` / `_sqdist_tile`).
//
// Bound: bytes. The output is D*N*M floats written once against a few KB of
// inputs; per element there are 3*Din+3 flops and one exp. Design: a block
// owns one output dim d and a tile of rows. K[d] is (N, M) row-major, so the
// tile's outputs are ONE contiguous run of rows*M floats: thread i of the
// block writes element i, i + blockDim, ... of that run, which lays the
// threads along M and makes every store coalesced whatever M is. The
// pre-scaled z (M, Din) and x tile (rows, Din) for this d sit in shared
// memory; the Din differences are summed in k order as the plain version
// does. Rows past N are masked by the row count, never padded.
// Accurate expf (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>

static __global__ void rbf_gram_kernel(const float* __restrict__ x,
                                       const float* __restrict__ z,
                                       const float* __restrict__ inv_ls,
                                       const float* __restrict__ var,
                                       float* __restrict__ out, int n, int din,
                                       int m, int rows_per_block) {
  extern __shared__ float smem[];
  float* zs = smem;            // (M, Din)   z / ls_d
  float* xs = smem + m * din;  // (rows, Din) x / ls_d
  const int d = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  const float* il = inv_ls + (size_t)d * din;
  for (int i = threadIdx.x; i < m * din; i += blockDim.x) zs[i] = z[i] * il[i % din];
  for (int i = threadIdx.x; i < rows * din; i += blockDim.x)
    xs[i] = x[(size_t)row0 * din + i] * il[i % din];
  __syncthreads();
  const float vd = var[d];
  float* o = out + ((size_t)d * n + row0) * m;
  for (int i = threadIdx.x; i < rows * m; i += blockDim.x) {
    const float* xr = xs + (i / m) * din;
    const float* zr = zs + (i % m) * din;
    float sq = 0.f;
    for (int k = 0; k < din; ++k) {
      const float diff = xr[k] - zr[k];
      sq = fmaf(diff, diff, sq);
    }
    o[i] = vd * expf(-0.5f * sq);
  }
}

extern "C" int gpode_rbf_gram(const float* x, const float* z, const float* inv_ls,
                              const float* var, float* out, int n, int din, int d,
                              int m, int rows_per_block, int threads,
                              void* stream) {
  const dim3 grid((n + rows_per_block - 1) / rows_per_block, d);
  const size_t smem = sizeof(float) * (size_t)(m + rows_per_block) * din;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rbf_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rbf_gram_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, z, inv_ls, var, out, n, din, m, rows_per_block);
  return (int)cudaGetLastError();
}
