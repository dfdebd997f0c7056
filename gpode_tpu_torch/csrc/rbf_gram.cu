// rbf_gram for Hopper (sm_90a): the dimwise RBF cross-Gram
//   K[d, n, m] = var[d] exp(-1/2 sum_k (x[n,k]/ls[d,k] - z[m,k]/ls[d,k])^2)
// x (N, Din), z (M, Din), inv_ls (D, Din) = 1/lengthscale, var (D,)
// -> K (D, N, M), float32, forward only.
//
// Replaces gpode_tpu/ops/pallas_kernels.py `rbf_gram_pallas` (:165,
// pallas_call :178; tile body `_rbf_gram_kernel` / `_sqdist_tile`).
//
// Bound: bytes. The output is D*N*M floats written once against a few KB of
// inputs (6.0 MB at N=3000, M=100, D=5: 1.8 us at 3.35 TB/s); per element
// there are 3*Din+3 flops and one exp. So the design keeps every thread
// storing and issues as few instructions per stored float as it can:
//
// * A column group per thread. A block owns one output dim d (grid z), a
//   tile of rows (grid x) and a chunk of G_b groups of GRAM_GROUP = 4
//   adjacent columns (grid y). Thread t takes group t % G_b and row lane
//   t / G_b of the tile; it keeps its 4 columns'
//   scaled z rows in registers (4 * DP floats, loaded once) and walks the
//   rows lane, lane + L, ... of its tile. The scaled x row comes from shared
//   memory: the threads of a row read one address (a broadcast).
// * 16-byte stores. Row n of K[d] is M contiguous floats and the tile's rows
//   follow each other, so the threads of a warp write one contiguous run;
//   with M % 4 == 0 each row's group leaves as one float4. Otherwise, and for
//   the ragged last group, scalar stores of the columns below M.
// * No division or modulo in the loop over rows: the thread's group, lane
//   and column offset are fixed before it.
// * Exact-Din variants: DP (the template argument) bounds the loops over
//   Din; an operand beyond Din is 0, which adds fmaf(0, 0, s) = s, so every
//   variant gives the same bits. The Din terms are summed in k order, as the
//   plain version does.
// * Any wider Din: the variant DP = 0 keeps its chunk's scaled z rows in
//   shared memory beside the tile's x rows, as one float4 of a group's four
//   columns per k (zs4[k * G_b + group]), and bounds its loop by the runtime
//   Din. It forms the same products in the same order as the exact-Din
//   variants, so it gives their bits at any Din they take.
//
// Rows past N are masked by the tile's row count, never padded. Accurate
// expf (no --use_fast_math); no atomics, so reruns are bit-identical. The
// launch geometry (rows per block, row lanes, groups per block) is chosen by
// `gram_geometry` in ops/cuda_kernels.py.

#include "rhs_tile.cuh"  // prepare_kernel / occupancy_report

#define GRAM_GROUP 4
#define GRAM_MAX_THREADS 256

// The instantiated variants: DP >= Din, the narrowest taken; DP = 0 for a
// Din above 16. Every one builds at 0 B of spill (ptxas).
#define GRAM_VARIANTS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(16) X(0)

extern __shared__ float4 gram_smem[];

// K[d] at one row of a group: var_d exp(-sq / 2), one 16-byte store when
// every row starts 16-byte aligned (M % 4 == 0), else the columns below M.
static __device__ __forceinline__ void store_group(float* orow,
                                                   const float (&sq)[GRAM_GROUP],
                                                   float vd, bool vec, int ncols) {
  float v[GRAM_GROUP];
#pragma unroll
  for (int c = 0; c < GRAM_GROUP; ++c) v[c] = vd * expf(-0.5f * sq[c]);
  if (vec) {
    *reinterpret_cast<float4*>(orow) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < GRAM_GROUP; ++c)
      if (c < ncols) orow[c] = v[c];
  }
}

template <int DP>
static __global__ void __launch_bounds__(GRAM_MAX_THREADS)
    rbf_gram_kernel(const float* __restrict__ x, const float* __restrict__ z,
                    const float* __restrict__ inv_ls, const float* __restrict__ var,
                    float* __restrict__ out, int n, int din, int m,
                    int rows_per_block, int lanes, int groups_per_block) {
  const int d = blockIdx.z;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  const float* il = inv_ls + (size_t)d * din;
  const int chunk0 = blockIdx.y * groups_per_block * GRAM_GROUP;  // first column
  // DP > 0: (rows_per_block, DP) x / ls_d, 0 beyond Din. DP = 0: the chunk's
  // (Din, G_b) float4 groups of z / ls_d, then (rows_per_block, Din) x / ls_d.
  float4* zs4 = gram_smem;
  float* xs = reinterpret_cast<float*>(
      DP ? gram_smem : gram_smem + (size_t)din * groups_per_block);
  float ild[DP ? DP : 1];
  if constexpr (DP > 0) {
#pragma unroll
    for (int k = 0; k < DP; ++k) ild[k] = k < din ? il[k] : 0.f;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* xr = x + (size_t)(row0 + r) * din;
#pragma unroll
      for (int k = 0; k < DP; ++k) xs[r * DP + k] = k < din ? xr[k] * ild[k] : 0.f;
    }
  } else {
    // column j of the chunk; a ragged group's missing columns repeat the
    // last column and are never stored
    const int width = groups_per_block * GRAM_GROUP;
    float* zsf = reinterpret_cast<float*>(zs4);
    for (int i = threadIdx.x; i < din * width; i += blockDim.x) {
      const int k = i / width, j = i - k * width;
      zsf[i] = z[(size_t)min(chunk0 + j, m - 1) * din + k] * il[k];
    }
    const float* xt = x + (size_t)row0 * din;
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x)
      xs[i] = xt[i] * il[i % din];
  }
  __syncthreads();

  const int group = threadIdx.x % groups_per_block;
  const int lane = threadIdx.x / groups_per_block;
  const int col0 = chunk0 + group * GRAM_GROUP;
  if (col0 >= m) return;  // threads = lanes * groups_per_block: lane < lanes
  const int ncols = min(GRAM_GROUP, m - col0);
  const float vd = var[d];
  const bool vec = (m & (GRAM_GROUP - 1)) == 0;  // rows start 16-byte aligned
  float* o = out + ((size_t)d * n + row0) * m + col0;
  if constexpr (DP > 0) {
    // this group's z / ls_d in registers
    float zs[GRAM_GROUP][DP];
#pragma unroll
    for (int c = 0; c < GRAM_GROUP; ++c) {
      const float* zr = z + (size_t)(col0 + min(c, ncols - 1)) * din;
#pragma unroll
      for (int k = 0; k < DP; ++k) zs[c][k] = k < din ? zr[k] * ild[k] : 0.f;
    }
    for (int r = lane; r < rows; r += lanes) {
      float sq[GRAM_GROUP];
#pragma unroll
      for (int c = 0; c < GRAM_GROUP; ++c) sq[c] = 0.f;
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        const float xk = xs[r * DP + k];
#pragma unroll
        for (int c = 0; c < GRAM_GROUP; ++c) {
          const float diff = xk - zs[c][k];
          sq[c] = fmaf(diff, diff, sq[c]);
        }
      }
      store_group(o + (size_t)r * m, sq, vd, vec, ncols);
    }
  } else {
    const float4* zg = zs4 + group;
    for (int r = lane; r < rows; r += lanes) {
      const float* xr = xs + r * din;
      float sq[GRAM_GROUP] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < din; ++k) {
        const float xk = xr[k];
        const float4 zk = zg[k * groups_per_block];
        const float zc[GRAM_GROUP] = {zk.x, zk.y, zk.z, zk.w};
#pragma unroll
        for (int c = 0; c < GRAM_GROUP; ++c) {
          const float diff = xk - zc[c];
          sq[c] = fmaf(diff, diff, sq[c]);
        }
      }
      store_group(o + (size_t)r * m, sq, vd, vec, ncols);
    }
  }
}

// Dynamic shared memory of a block: the tile's scaled x rows, and for DP = 0
// also its chunk's scaled z rows. `gram_geometry` computes the same.
static size_t gram_smem_bytes(int din, int dp, int rows_per_block,
                              int groups_per_block) {
  if (dp) return sizeof(float) * (size_t)rows_per_block * dp;
  return sizeof(float) * (size_t)din * (rows_per_block + GRAM_GROUP * groups_per_block);
}

// The kernel on `stream`; with `occupancy` non-null nothing is launched and
// the kernel's occupancy_report at this geometry is written there instead.
static int rbf_gram_run(const float* x, const float* z, const float* inv_ls,
                        const float* var, float* out, int n, int din, int d, int m,
                        int dp, int rows_per_block, int lanes, int groups_per_block,
                        int* occupancy, void* stream) {
  const int threads = lanes * groups_per_block;
  if (n < 1 || m < 1 || d < 1 || d > 65535 || din < 1 || lanes < 1 ||
      groups_per_block < 1 || threads > GRAM_MAX_THREADS || rows_per_block < lanes ||
      (dp && din > dp))
    return (int)cudaErrorInvalidValue;
  const int groups = (m + GRAM_GROUP - 1) / GRAM_GROUP;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block,
                  (groups + groups_per_block - 1) / groups_per_block, d);
  const size_t smem = gram_smem_bytes(din, dp, rows_per_block, groups_per_block);
  cudaError_t e = cudaErrorInvalidValue;
#define X(DP_)                                                                    \
  if (dp == DP_) {                                                                \
    e = prepare_kernel(rbf_gram_kernel<DP_>, threads, smem, occupancy);           \
    if (e == cudaSuccess && !occupancy) {                                         \
      rbf_gram_kernel<DP_><<<grid, threads, smem, (cudaStream_t)stream>>>(        \
          x, z, inv_ls, var, out, n, din, m, rows_per_block, lanes,               \
          groups_per_block);                                                      \
      e = cudaGetLastError();                                                     \
    }                                                                             \
  }
  GRAM_VARIANTS(X)
#undef X
  return (int)e;
}

extern "C" int gpode_rbf_gram(const float* x, const float* z, const float* inv_ls,
                              const float* var, float* out, int n, int din, int d,
                              int m, int dp, int rows_per_block, int lanes,
                              int groups_per_block, void* stream) {
  return rbf_gram_run(x, z, inv_ls, var, out, n, din, d, m, dp, rows_per_block,
                      lanes, groups_per_block, nullptr, stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the kernel at this geometry; launches nothing.
extern "C" int gpode_rbf_gram_occupancy(int din, int d, int m, int dp,
                                        int rows_per_block, int lanes,
                                        int groups_per_block, int* out) {
  return rbf_gram_run(nullptr, nullptr, nullptr, nullptr, nullptr, rows_per_block,
                      din, d, m, dp, rows_per_block, lanes, groups_per_block, out,
                      nullptr);
}
