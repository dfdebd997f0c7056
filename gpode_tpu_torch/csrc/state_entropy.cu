// state_entropy for Hopper (sm_90a): the entropy of the factorised shooting
// posterior, forward and backward (models/states.py `shooting_entropy`). For
// each of n state covariances, given by the packed lower triangle l of its
// scale L (D (D + 1) / 2 floats, rows in order, as `np.tril_indices`):
//
//   A = L L^T + jitter I,  C = chol(A),
//   H = D (1 + log 2 pi) / 2 + sum_i log C_ii,
//
// and its VJP in L (mathematically g A^{-1} L, lower triangle).
//
// Replaces no Pallas kernel: in the JAX package XLA fuses the unrolled
// Cholesky-Crout of `cholesky_small` (ops/math.py) into a few kernels. The
// port ran the same unrolled algorithm as D (D + 1) / 2 columns of plain
// tensor arithmetic: ~85 kernels forward and ~240 backward, each over the
// N (T - 1) = 594 factors of the MoCap train step, ~0.4 ms of launches a step
// for a few tens of kilobytes and ~10^5 flops.
//
// Bound: launch latency. The work (~100 flops forward, ~300 backward, a
// factor) and the bytes (its 15 floats at D = 5) take nanoseconds at the
// card's peaks, so each direction is one launch, one thread a factor, with
// the whole factor in registers (a template per D <= MAX_DIM, every loop
// unrolled). No thread shares a factor, so there are no atomics and no
// barriers.
//
// Both kernels repeat the unrolled chain's float32 operations one by one, so
// that its gradient comes out bit for bit what autograd gave through the
// chain: a train step then follows the same trajectory on either path.
// Every product, sum, quotient, square root and reciprocal is its own
// IEEE-rounded operation (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn, __frcp_rn), so nvcc's FMA contraction changes nothing; the
// three 5 x 5 products (L L^T, and G L, L^T G in the backward) are the
// single-precision GEMM's fused multiply-adds over k in ascending order.
//
// * state_entropy_fwd_kernel<D>: A, then C by the chain's recurrence in its
//   order (d = sqrt(pivot), 1/d, the column times 1/d); the logs summed in
//   order. A non-positive pivot gives a NaN or -inf entropy, as the chain's
//   sqrt does.
// * state_entropy_bwd_kernel<D>: A and C again from l (nothing is saved
//   between the launches), keeping each row's remainder t before its
//   division; then the chain's adjoint in the order autograd runs it,
//   the nodes in reverse order of their creation, each cotangent summed in
//   that order (a tensor's consumers, latest first; the stack's zero first):
//   G, the cotangent of A's lower triangle; then G L + (L^T G)^T.

#include <cuda_runtime.h>

#define MAX_DIM 8
#define THREADS 128

__host__ __device__ constexpr int packed(int i, int j) { return i * (i + 1) / 2 + j; }

// a <- L L^T + jitter I (lower triangle): each entry the GEMM's fused
// multiply-adds over k ascending, the jitter then added to the diagonal.
template <int D>
__device__ __forceinline__ void jittered_gram(const float (&l)[D * (D + 1) / 2],
                                              float jitter,
                                              float (&a)[D * (D + 1) / 2]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k <= j; ++k) s = __fmaf_rn(l[packed(i, k)], l[packed(j, k)], s);
      a[packed(i, j)] = __fadd_rn(s, i == j ? jitter : 0.0f);
    }
  }
}

// c <- chol(a) in place (the chain's operations in its order), r[j] = 1 /
// c_jj and, for the backward, t[i][j] (i > j) the remainder that c_ij is
// t times r[j] of.
template <int D, bool KEEP_T>
__device__ __forceinline__ void factor(float (&c)[D * (D + 1) / 2], float (&r)[D],
                                       float (&t)[D * (D + 1) / 2]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float s = c[packed(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k)
      s = __fsub_rn(s, __fmul_rn(c[packed(j, k)], c[packed(j, k)]));
    const float d = __fsqrt_rn(s);
    c[packed(j, j)] = d;
    r[j] = __frcp_rn(d);
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      float u = c[packed(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k)
        u = __fsub_rn(u, __fmul_rn(c[packed(i, k)], c[packed(j, k)]));
      if (KEEP_T) t[packed(i, j)] = u;
      c[packed(i, j)] = __fmul_rn(u, r[j]);
    }
  }
}

template <int D>
__device__ __forceinline__ void load_scale(const float* __restrict__ tril, int f,
                                           float (&l)[D * (D + 1) / 2]) {
  constexpr int P = D * (D + 1) / 2;
  const float* src = tril + (size_t)f * P;
#pragma unroll
  for (int p = 0; p < P; ++p) l[p] = src[p];
}

template <int D>
__global__ void __launch_bounds__(THREADS)
state_entropy_fwd_kernel(const float* __restrict__ tril, float jitter,
                         float constant, float* __restrict__ entropy, int n) {
  constexpr int P = D * (D + 1) / 2;
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= n) return;
  float l[P], c[P], r[D];
  load_scale<D>(tril, f, l);
  jittered_gram<D>(l, jitter, c);
  factor<D, false>(c, r, c);
  float s = logf(c[packed(0, 0)]);
#pragma unroll
  for (int i = 1; i < D; ++i) s = __fadd_rn(s, logf(c[packed(i, i)]));
  // 0.5 (constant + 2 s): the chain's 2 sum log, then its sum
  entropy[f] = __fmul_rn(0.5f, __fadd_rn(constant, __fmul_rn(2.0f, s)));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
state_entropy_bwd_kernel(const float* __restrict__ tril,
                         const float* __restrict__ g, float jitter,
                         float* __restrict__ grad, int n) {
  constexpr int P = D * (D + 1) / 2;
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= n) return;
  float l[P], c[P], t[P], r[D];
  load_scale<D>(tril, f, l);
  jittered_gram<D>(l, jitter, c);
  factor<D, true>(c, r, t);
  // gc: each c entry's cotangent as autograd sums it, first the stack's
  // (the log's g / c_jj on the diagonal, 0 below it); each entry, once
  // final, is overwritten by its entry of G
  const float gf = g[f];
  float gc[P];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) gc[packed(i, j)] = 0.0f;
    gc[packed(i, i)] = __fdiv_rn(gf, c[packed(i, i)]);
  }
#pragma unroll
  for (int j = D - 1; j >= 0; --j) {
    float g_inv = 0.0f;
#pragma unroll
    for (int i = D - 1; i > j; --i) {
      // c_ij = t_ij * r_j
      const float gt = __fmul_rn(gc[packed(i, j)], r[j]);
      const float gi = __fmul_rn(gc[packed(i, j)], t[packed(i, j)]);
      g_inv = i == D - 1 ? gi : __fadd_rn(g_inv, gi);
      // t_ij -= c_ik c_jk, k = j - 1 down to 0
      const float q = -gt;
#pragma unroll
      for (int k = j - 1; k >= 0; --k) {
        gc[packed(i, k)] = __fadd_rn(gc[packed(i, k)], __fmul_rn(q, c[packed(j, k)]));
        gc[packed(j, k)] = __fadd_rn(gc[packed(j, k)], __fmul_rn(q, c[packed(i, k)]));
      }
      gc[packed(i, j)] = gt;
    }
    // r_j = 1 / c_jj (only where a row below used it)
    if (j < D - 1)
      gc[packed(j, j)] = __fadd_rn(gc[packed(j, j)],
                                   __fmul_rn(-g_inv, __fmul_rn(r[j], r[j])));
    // c_jj = sqrt(s_j), s_j -= c_jk c_jk, k = j - 1 down to 0
    const float gs = __fdiv_rn(gc[packed(j, j)], __fmul_rn(2.0f, c[packed(j, j)]));
    const float q = -gs;
#pragma unroll
    for (int k = j - 1; k >= 0; --k) {
      const float p = __fmul_rn(q, c[packed(j, k)]);
      gc[packed(j, k)] = __fadd_rn(__fadd_rn(gc[packed(j, k)], p), p);
    }
    gc[packed(j, j)] = gs;
  }
  // A = L L^T: the cotangent of L is G L + (L^T G)^T, each a GEMM's fused
  // multiply-adds over k ascending (G lower triangular: k from j to i, and
  // from i on)
  float* dst = grad + (size_t)f * P;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float x = 0.0f, y = 0.0f;
#pragma unroll
      for (int k = j; k <= i; ++k) x = __fmaf_rn(gc[packed(i, k)], l[packed(k, j)], x);
#pragma unroll
      for (int k = i; k < D; ++k) y = __fmaf_rn(l[packed(k, j)], gc[packed(k, i)], y);
      dst[packed(i, j)] = __fadd_rn(x, y);
    }
  }
}

// With `occupancy` non-null, write {resident blocks per SM, threads, dynamic
// shared bytes, registers, local bytes} of `kernel` and launch nothing.
template <typename Kernel>
static cudaError_t query(Kernel kernel, int* occupancy) {
  int resident = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                                THREADS, 0);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  occupancy[0] = resident;
  occupancy[1] = THREADS;
  occupancy[2] = 0;
  occupancy[3] = attr.numRegs;
  occupancy[4] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

template <int D>
static int fwd_run(const float* tril, float jitter, float constant,
                   float* entropy, int n, int* occupancy, cudaStream_t s) {
  if (occupancy) return (int)query(state_entropy_fwd_kernel<D>, occupancy);
  if (n == 0) return 0;
  state_entropy_fwd_kernel<D><<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      tril, jitter, constant, entropy, n);
  return (int)cudaGetLastError();
}

template <int D>
static int bwd_run(const float* tril, const float* g, float jitter, float* grad,
                   int n, int* occupancy, cudaStream_t s) {
  if (occupancy) return (int)query(state_entropy_bwd_kernel<D>, occupancy);
  if (n == 0) return 0;
  state_entropy_bwd_kernel<D><<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      tril, g, jitter, grad, n);
  return (int)cudaGetLastError();
}

// The kernel of dimension d: a direction's run for D = 1..MAX_DIM.
static_assert(MAX_DIM == 8, "BY_DIM lists D = 1..8");
#define BY_DIM(RUN, ...)                        \
  switch (d) {                                  \
    case 1: return RUN<1>(__VA_ARGS__);         \
    case 2: return RUN<2>(__VA_ARGS__);         \
    case 3: return RUN<3>(__VA_ARGS__);         \
    case 4: return RUN<4>(__VA_ARGS__);         \
    case 5: return RUN<5>(__VA_ARGS__);         \
    case 6: return RUN<6>(__VA_ARGS__);         \
    case 7: return RUN<7>(__VA_ARGS__);         \
    case 8: return RUN<8>(__VA_ARGS__);         \
    default: return (int)cudaErrorInvalidValue; \
  }

// The forward on `stream`: the packed scales tril (n, d (d + 1) / 2) in, the
// entropies (n,) out; `constant` = d (1 + log 2 pi), rounded by the caller.
extern "C" int gpode_state_entropy_fwd(const float* tril, float jitter,
                                       float constant, float* entropy, int n,
                                       int d, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  BY_DIM(fwd_run, tril, jitter, constant, entropy, n, nullptr, (cudaStream_t)stream)
}

// The backward on `stream`: tril (n, d (d + 1) / 2) and the entropies'
// cotangent g (n,) in, the cotangent of tril (n, d (d + 1) / 2) out.
extern "C" int gpode_state_entropy_bwd(const float* tril, const float* g,
                                       float jitter, float* grad, int n, int d,
                                       void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  BY_DIM(bwd_run, tril, g, jitter, grad, n, nullptr, (cudaStream_t)stream)
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the forward (kernel 0) or the backward (1) at dimension d;
// launches nothing.
extern "C" int gpode_state_entropy_occupancy(int kernel, int d, int* out) {
  if (kernel == 0) {
    BY_DIM(fwd_run, nullptr, 0.f, 0.f, nullptr, 0, out, nullptr)
  }
  BY_DIM(bwd_run, nullptr, nullptr, 0.f, nullptr, 0, out, nullptr)
}
