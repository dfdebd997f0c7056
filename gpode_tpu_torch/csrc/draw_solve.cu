// draw_solve for Hopper (sm_90a): the posterior draw's solves on its own
// factor of K(Z, Z), forward and backward (models/gp.py `draw_posterior`).
// For each of B factors (one per output dim of a dimwise GP) and its R
// right-hand columns (one per draw):
//
//   L = chol(K + jitter I),  a = L^{-1} u,  c = v - a,  nu = L^{-T} c,
//
// and the VJP of nu in K, u and v, with the Cholesky's
//
//   g_c = L^{-1} g_nu,  g_v = g_c,  g_u = -L^{-T} g_c,
//   P = tril(g_c a^T - c g_c^T)              (= tril(L^T g_L), g_L the two
//                                               solves' factor cotangent)
//   g_K = sym(L^{-T} Phi L^{-1}),  Phi = (P + tril(P, -1)^T) / 2.
//
// Replaces no Pallas kernel: the JAX package leaves the factorisation and
// the triangular solves to XLA (`jnp.linalg.cholesky`,
// `jax.scipy.linalg.solve_triangular`). On the card the library runs them
// as one cuSOLVER / cuBLAS call per factor and per solve, each 11-29 us of
// mostly waiting, around a dozen small glue kernels: ~0.5 ms a train step
// at B=5, M=100, R=1 for ~1.2e7 flop.
//
// Bound: latency. A factorisation and a triangular solve are chains of M
// dependent steps; at M=100 the arithmetic (M^3/3 forward, ~2 M^3 backward)
// and the bytes (a 40 KB factor) take under a microsecond at the card's
// peaks. The design keeps each factor in one block's shared memory, so a
// step costs a barrier or a warp shuffle and a few shared-memory reads, and
// spreads the independent right-hand columns over the block's warps:
//
// * draw_solve_fwd_kernel (FWD_WARPS warps a factor): Cholesky-Crout on the
//   factor augmented with the R rows u^T, so that the same steps also leave
//   a = L^{-1} u in those rows, right-looking by panels of 32 columns: one
//   warp factors the panel's diagonal block in registers, its pivots passed
//   by shuffles (d = sqrtf(pivot), accurate, then 1/d IEEE-rounded); one
//   lane a row solves the rows below against it; every thread then takes the
//   panel's rank-32 product off one trailing element, its terms in column
//   order. Three barriers a panel, so at M=100 twelve, where a barrier a
//   column (a first design, 0.143 ms at B=5, M=100) spent ~2,000 cycles a
//   step issuing its per-column bookkeeping. Every product and sum is the
//   column-at-a-time algorithm's, in its order: the same bits. Then
//   nu = L^{-T} c, one warp a column.
// * draw_solve_bwd_kernel (BWD_WARPS warps a factor): g_c by forward
//   substitution, one warp a column; then [W | h] = L^{-T} [Phi | g_c] and
//   Y^T = L^{-T} W^T by back substitution, BWD_COLS columns a warp over M + R
//   and M columns, with L's rows pre-scaled by their diagonals so that a
//   step is a shuffle and FMAs; g_K = (Y + Y^T) / 2.
//
// A substitution runs warp-synchronously: lane l of the warp holds rows
// l (mod 32) of its columns, the owner of row j shuffles it to the warp and
// every lane updates its rows. No float atomics and no reduction across
// blocks: each output is written once, in a fixed order, by one thread. A
// non-positive pivot gives non-finite entries (sqrtf of a negative number),
// as `torch.linalg.cholesky_ex`, with no error read.
//
// Operands, row-major and contiguous: K (B, M, M) (its lower triangle is
// read); u, v, a, nu, g_nu, g_u, g_v (B, R, M): R columns of M per factor;
// L, g_K (B, M, M). Shapes: M <= 32 * MAX_ROWS (a substitution's lane holds
// MAX_ROWS row slots, at every M), and both kernels' shared memory within a
// block's (ops/cuda_kernels.py `draw_solve_geometry`).

#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu
#define FWD_WARPS 8
#define FWD_THREADS (32 * FWD_WARPS)
#define BWD_WARPS 32
#define BWD_THREADS (32 * BWD_WARPS)
#define BWD_COLS 4
#define MAX_ROWS 4

// Shared-memory row stride: odd, so that a warp reading a column (32 rows)
// touches 32 banks.
__host__ __device__ __forceinline__ int row_stride(int m) { return m | 1; }

// Solve L x = b for the warp's NC columns in place: x[c][s] holds row
// lane + 32 s of column c (rows >= m are 0 and stay so). `rdiag` holds
// 1 / L_jj. Each step j turns the owner's b_j into x_j = b_j * rdiag[j] on
// every lane (the owner keeps b_j) and takes L_ij x_j off the rows below;
// the caller scales by rdiag at the end (`finish_rows`).
template <int ROWS, int NC>
__device__ __forceinline__ void warp_solve_lower(const float* __restrict__ Ls,
                                                 const float* __restrict__ rdiag,
                                                 int ld, int m,
                                                 float (&x)[NC][ROWS], int lane) {
#pragma unroll
  for (int sb = 0; sb < ROWS; ++sb) {
    const int jn = min(32, m - 32 * sb);
#pragma unroll 1
    for (int l = 0; l < jn; ++l) {
      const int j = 32 * sb + l;
      const float r = rdiag[j];
      float xj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        xj[c] = __fmul_rn(__shfl_sync(FULL_MASK, x[c][sb], l), r);
#pragma unroll
      for (int s = sb; s < ROWS; ++s) {
        const int i = lane + 32 * s;
        if (i > j && i < m) {
          const float lij = Ls[i * ld + j];
#pragma unroll
          for (int c = 0; c < NC; ++c) x[c][s] = fmaf(-lij, xj[c], x[c][s]);
        }
      }
    }
  }
}

// Solve L^T x = b for the warp's NC columns in place, as warp_solve_lower
// from the last row up. SCALED: Ls holds U_ji = L_ji / L_jj (row j of L
// scaled by its diagonal), so a step is b_i -= U_ji b_j with no product
// before it; else Ls holds L and x_j = b_j * rdiag[j] is formed first.
template <int ROWS, int NC, bool SCALED>
__device__ __forceinline__ void warp_solve_upper(const float* __restrict__ Ls,
                                                 const float* __restrict__ rdiag,
                                                 int ld, int m,
                                                 float (&x)[NC][ROWS], int lane) {
#pragma unroll
  for (int sb = ROWS - 1; sb >= 0; --sb) {
    const int jn = min(32, m - 32 * sb);
#pragma unroll 1
    for (int l = jn - 1; l >= 0; --l) {
      const int j = 32 * sb + l;
      float xj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        xj[c] = __shfl_sync(FULL_MASK, x[c][sb], l);
        if (!SCALED) xj[c] = __fmul_rn(xj[c], rdiag[j]);
      }
#pragma unroll
      for (int s = 0; s <= sb; ++s) {
        const int i = lane + 32 * s;
        if (i < j) {
          const float lji = Ls[j * ld + i];
#pragma unroll
          for (int c = 0; c < NC; ++c) x[c][s] = fmaf(-lji, xj[c], x[c][s]);
        }
      }
    }
  }
}

// x_i = b_i * rdiag[i]: the solved rows of a substitution above.
template <int ROWS, int NC>
__device__ __forceinline__ void finish_rows(const float* __restrict__ rdiag, int m,
                                            float (&x)[NC][ROWS], int lane) {
#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    const int i = lane + 32 * s;
    if (i < m) {
      const float r = rdiag[i];
#pragma unroll
      for (int c = 0; c < NC; ++c) x[c][s] = __fmul_rn(x[c][s], r);
    }
  }
}

// Factor the nb x nb diagonal block of the panel at column c0 in place (one
// warp; nb <= 32): lane i holds row c0 + i of the block in registers; step jj
// shuffles the pivot from lane jj, every lane scales its entry of column jj
// (x * (1 / d), the diagonal d = sqrtf(pivot)) and takes l_i l_kk off its
// entries kk > jj, with l_kk shuffled from lane kk. rdiag[c0 + jj] = 1 / d.
__device__ __forceinline__ void factor_diagonal_block(float* __restrict__ A,
                                                      float* __restrict__ rdiag,
                                                      int ld, int c0, int nb,
                                                      int lane) {
  float x[32];
#pragma unroll
  for (int q = 0; q < 32; ++q)
    x[q] = (lane < nb && q <= lane) ? A[(c0 + lane) * ld + c0 + q] : 0.f;
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    if (jj >= nb) break;
    const float d = sqrtf(__shfl_sync(FULL_MASK, x[jj], jj));
    const float rd = __frcp_rn(d);
    const float l = lane < jj ? 0.f : (lane == jj ? d : __fmul_rn(x[jj], rd));
    x[jj] = l;
    if (lane == 0) rdiag[c0 + jj] = rd;
#pragma unroll
    for (int kk = jj + 1; kk < 32; ++kk)
      x[kk] = fmaf(-l, __shfl_sync(FULL_MASK, l, kk), x[kk]);
  }
#pragma unroll
  for (int q = 0; q < 32; ++q)
    if (lane < nb && q <= lane) A[(c0 + lane) * ld + c0 + q] = x[q];
}

// Row i's entries in the panel's nb columns, l_i = a_i L11^{-T}, by forward
// substitution against the factored diagonal block (read by every lane at
// once), in place; one lane a row. No branch inside a step, so that its
// block reads issue ahead of the products: the entries past nb, never
// stored, take the block's last row.
__device__ __forceinline__ void panel_row(float* __restrict__ A,
                                          const float* __restrict__ rdiag, int ld,
                                          int c0, int nb, int i, bool live) {
  const float* blk = A + c0 * ld + c0;
  float x[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) x[q] = (live && q < nb) ? A[i * ld + c0 + q] : 0.f;
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    if (jj >= nb) break;
    x[jj] = __fmul_rn(x[jj], rdiag[c0 + jj]);
#pragma unroll
    for (int kk = jj + 1; kk < 32; ++kk)
      x[kk] = fmaf(-blk[min(kk, nb - 1) * ld + jj], x[jj], x[kk]);
  }
#pragma unroll
  for (int q = 0; q < 32; ++q)
    if (live && q < nb) A[i * ld + c0 + q] = x[q];
}

// The trailing lower triangle (rows [c1, mr), columns [c1, m)) less the
// panel's rank-nb product: one thread a column k and four rows, so that
// four independent sums share each read of column k's panel entries; each
// element's nb terms in column order.
__device__ __forceinline__ void trailing_update(float* __restrict__ A, int ld,
                                                int m, int mr, int c0, int nb,
                                                int tid) {
  const int c1 = c0 + nb, tc = m - c1, groups = (mr - c1 + 3) / 4;
  for (int e = tid; e < groups * tc; e += FWD_THREADS) {
    const int g = e / tc, k = c1 + (e - g * tc);
    const int i0 = c1 + 4 * g;
    if (k > i0 + 3) continue;  // all four above the diagonal
    const float* lk = A + k * ld + c0;
    const float* li[4];
    float acc[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = min(i0 + t, mr - 1);
      li[t] = A + i * ld + c0;
      acc[t] = A[i * ld + k];
    }
#pragma unroll 8
    for (int q = 0; q < nb; ++q) {
      const float l = lk[q];
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t] = fmaf(-li[t][q], l, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (i0 + t < mr && k <= i0 + t) A[(i0 + t) * ld + k] = acc[t];
  }
}

// Shared memory (floats): A ((m + r) x ld) the augmented factor
// [K + jitter I; u^T], factored in place into [L; a^T]; rdiag (m).
static __global__ void __launch_bounds__(FWD_THREADS)
draw_solve_fwd_kernel(const float* __restrict__ K, const float* __restrict__ u,
                      const float* __restrict__ v, float jitter,
                      float* __restrict__ L, float* __restrict__ a,
                      float* __restrict__ nu, int m, int r) {
  constexpr int ROWS = MAX_ROWS;
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(m), mr = m + r;
  float* A = smem;
  float* rdiag = A + mr * ld;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t fm = (size_t)blockIdx.x * m;
  K += fm * m;
  L += fm * m;
  u += fm * r;
  v += fm * r;
  a += fm * r;
  nu += fm * r;

#pragma unroll 4
  for (int e = tid; e < m * m; e += FWD_THREADS) {
    const int i = e / m, k = e - i * m;
    const float val = K[e];
    A[i * ld + k] = i == k ? __fadd_rn(val, jitter) : val;
  }
#pragma unroll 4
  for (int e = tid; e < r * m; e += FWD_THREADS) {
    const int q = e / m;
    A[(m + q) * ld + (e - q * m)] = u[e];
  }
  __syncthreads();

  // Right-looking by panels of 32 columns: the diagonal block (one warp),
  // the panel's rows below it, augmented rows included (one lane a row),
  // then the trailing lower triangle less the panel's rank-nb product.
  for (int c0 = 0; c0 < m; c0 += 32) {
    const int nb = min(32, m - c0), c1 = c0 + nb;
    if (warp == 0) factor_diagonal_block(A, rdiag, ld, c0, nb, lane);
    __syncthreads();
    for (int i0 = c1 + 32 * warp; i0 < mr; i0 += 32 * FWD_WARPS)
      panel_row(A, rdiag, ld, c0, nb, i0 + lane, i0 + lane < mr);
    __syncthreads();
    trailing_update(A, ld, m, mr, c0, nb, tid);
    __syncthreads();
  }

  // nu = L^{-T} (v - a), one warp a right-hand column
  for (int q = warp; q < r; q += FWD_WARPS) {
    const float* aq = A + (m + q) * ld;
    float x[1][ROWS];
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = lane + 32 * s;
      x[0][s] = i < m ? __fsub_rn(v[q * m + i], aq[i]) : 0.f;
    }
    warp_solve_upper<ROWS, 1, false>(A, rdiag, ld, m, x, lane);
    finish_rows<ROWS, 1>(rdiag, m, x, lane);
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = lane + 32 * s;
      if (i < m) {
        nu[q * m + i] = x[0][s];
        a[q * m + i] = aq[i];
      }
    }
  }
  for (int e = tid; e < m * m; e += FWD_THREADS) {
    const int i = e / m, k = e - i * m;
    L[e] = k <= i ? A[i * ld + k] : 0.f;
  }
}

// Shared memory (floats): Ls (m x ld) L, then U; Ws (m x ld) W, then Y;
// as, cs, gs (r x m) a, c = v - a, g_nu then g_c; rdiag (m).
static __global__ void __launch_bounds__(BWD_THREADS)
draw_solve_bwd_kernel(const float* __restrict__ L, const float* __restrict__ a,
                      const float* __restrict__ v, const float* __restrict__ g_nu,
                      float* __restrict__ g_K, float* __restrict__ g_u,
                      float* __restrict__ g_v, int m, int r) {
  constexpr int ROWS = MAX_ROWS, NC = BWD_COLS;
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(m);
  float* Ls = smem;
  float* Ws = Ls + m * ld;
  float* as = Ws + m * ld;
  float* cs = as + r * m;
  float* gs = cs + r * m;
  float* rdiag = gs + r * m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t fm = (size_t)blockIdx.x * m;
  L += fm * m;
  g_K += fm * m;
  a += fm * r;
  v += fm * r;
  g_nu += fm * r;
  g_u += fm * r;
  g_v += fm * r;

  for (int e = tid; e < m * m; e += BWD_THREADS) {
    const int i = e / m;
    Ls[i * ld + (e - i * m)] = L[e];
  }
  for (int e = tid; e < r * m; e += BWD_THREADS) {
    const float ae = a[e];
    as[e] = ae;
    cs[e] = __fsub_rn(v[e], ae);
    gs[e] = g_nu[e];
  }
  __syncthreads();
  for (int j = tid; j < m; j += BWD_THREADS) rdiag[j] = __frcp_rn(Ls[j * ld + j]);
  __syncthreads();

  // g_c = L^{-1} g_nu (= g_v), one warp a column
  for (int q = warp; q < r; q += BWD_WARPS) {
    float x[1][ROWS];
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = lane + 32 * s;
      x[0][s] = i < m ? gs[q * m + i] : 0.f;
    }
    warp_solve_lower<ROWS, 1>(Ls, rdiag, ld, m, x, lane);
    finish_rows<ROWS, 1>(rdiag, m, x, lane);
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = lane + 32 * s;
      if (i < m) {
        gs[q * m + i] = x[0][s];
        g_v[q * m + i] = x[0][s];
      }
    }
  }
  __syncthreads();
  // U: row j of L (below the diagonal) times 1 / L_jj
  for (int e = tid; e < m * m; e += BWD_THREADS) {
    const int j = e / m, i = e - j * m;
    if (i < j) Ls[j * ld + i] = __fmul_rn(Ls[j * ld + i], rdiag[j]);
  }
  __syncthreads();

  // [W | h] = L^{-T} [Phi | g_c]: W into Ws row-major, g_u = -h
  for (int c0 = warp * NC; c0 < m + r; c0 += BWD_WARPS * NC) {
    float x[NC][ROWS];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int q = c0 + cc;
#pragma unroll
      for (int s = 0; s < ROWS; ++s) {
        const int i = lane + 32 * s;
        float val = 0.f;
        if (i < m && q < m) {
          // Phi_iq = P_{hi,lo} / 2, P_{hi,lo} = sum_t gc_hi a_lo - c_hi gc_lo
          const int hi = max(i, q), lo = min(i, q);
          float acc = 0.f;
          for (int t = 0; t < r; ++t) {
            acc = fmaf(gs[t * m + hi], as[t * m + lo], acc);
            acc = fmaf(-cs[t * m + hi], gs[t * m + lo], acc);
          }
          val = __fmul_rn(0.5f, acc);
        } else if (i < m && q < m + r) {
          val = gs[(q - m) * m + i];
        }
        x[cc][s] = val;
      }
    }
    warp_solve_upper<ROWS, NC, true>(Ls, rdiag, ld, m, x, lane);
    finish_rows<ROWS, NC>(rdiag, m, x, lane);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int q = c0 + cc;
#pragma unroll
      for (int s = 0; s < ROWS; ++s) {
        const int i = lane + 32 * s;
        if (i < m) {
          if (q < m)
            Ws[i * ld + q] = x[cc][s];
          else if (q < m + r)
            g_u[(q - m) * m + i] = -x[cc][s];
        }
      }
    }
  }
  __syncthreads();

  // Y = W L^{-1} by rows: L^T y_q = w_q, row q of W replaced by row q of Y
  for (int c0 = warp * NC; c0 < m; c0 += BWD_WARPS * NC) {
    float x[NC][ROWS];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int q = c0 + cc;
#pragma unroll
      for (int s = 0; s < ROWS; ++s) {
        const int i = lane + 32 * s;
        x[cc][s] = (q < m && i < m) ? Ws[q * ld + i] : 0.f;
      }
    }
    warp_solve_upper<ROWS, NC, true>(Ls, rdiag, ld, m, x, lane);
    finish_rows<ROWS, NC>(rdiag, m, x, lane);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int q = c0 + cc;
#pragma unroll
      for (int s = 0; s < ROWS; ++s) {
        const int i = lane + 32 * s;
        if (q < m && i < m) Ws[q * ld + i] = x[cc][s];
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < m * m; e += BWD_THREADS) {
    const int i = e / m, k = e - i * m;
    g_K[e] = __fmul_rn(0.5f, __fadd_rn(Ws[i * ld + k], Ws[k * ld + i]));
  }
}

// ---------------------------------------------------------------------------
// Launchers (C interface: ops/cuda_kernels.py)
// ---------------------------------------------------------------------------

static bool shape_ok(int b, int m, int r) {
  return b >= 1 && m >= 1 && r >= 1 && m <= 32 * MAX_ROWS;
}

static size_t fwd_smem(int m, int r) {
  const size_t ld = row_stride(m);
  return sizeof(float) * ((size_t)(m + r) * ld + m);
}

static size_t bwd_smem(int m, int r) {
  const size_t ld = row_stride(m);
  return sizeof(float) * (2 * (size_t)m * ld + 3 * (size_t)r * m + m);
}

// With `occupancy` non-null, write {resident blocks per SM, threads, dynamic
// shared bytes, registers, local bytes} of `kernel` there and launch
// nothing; else allow it `smem` bytes of dynamic shared memory.
template <class Kernel>
static cudaError_t prepare(Kernel kernel, int threads, size_t smem, int* occupancy) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess || !occupancy) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  occupancy[0] = resident;
  occupancy[1] = threads;
  occupancy[2] = (int)smem;
  occupancy[3] = attr.numRegs;
  occupancy[4] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

static int fwd_run(const float* K, const float* u, const float* v, float jitter,
                   float* L, float* a, float* nu, int b, int m, int r,
                   int* occupancy, void* stream) {
  if (!shape_ok(b, m, r)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(m, r);
  cudaError_t e = prepare(draw_solve_fwd_kernel, FWD_THREADS, smem, occupancy);
  if (e == cudaSuccess && !occupancy) {
    draw_solve_fwd_kernel<<<b, FWD_THREADS, smem, (cudaStream_t)stream>>>(
        K, u, v, jitter, L, a, nu, m, r);
    e = cudaGetLastError();
  }
  return (int)e;
}

static int bwd_run(const float* L, const float* a, const float* v,
                   const float* g_nu, float* g_K, float* g_u, float* g_v, int b,
                   int m, int r, int* occupancy, void* stream) {
  if (!shape_ok(b, m, r)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(m, r);
  cudaError_t e = prepare(draw_solve_bwd_kernel, BWD_THREADS, smem, occupancy);
  if (e == cudaSuccess && !occupancy) {
    draw_solve_bwd_kernel<<<b, BWD_THREADS, smem, (cudaStream_t)stream>>>(
        L, a, v, g_nu, g_K, g_u, g_v, m, r);
    e = cudaGetLastError();
  }
  return (int)e;
}

// The forward on `stream`: K (b, m, m), u, v (b, r, m) in; L (b, m, m),
// a, nu (b, r, m) out.
extern "C" int gpode_draw_solve_fwd(const float* K, const float* u, const float* v,
                                    float jitter, float* L, float* a, float* nu,
                                    int b, int m, int r, void* stream) {
  return fwd_run(K, u, v, jitter, L, a, nu, b, m, r, nullptr, stream);
}

// The backward on `stream`: L (b, m, m), a, v, g_nu (b, r, m) in; g_K
// (b, m, m), g_u, g_v (b, r, m) out.
extern "C" int gpode_draw_solve_bwd(const float* L, const float* a, const float* v,
                                    const float* g_nu, float* g_K, float* g_u,
                                    float* g_v, int b, int m, int r, void* stream) {
  return bwd_run(L, a, v, g_nu, g_K, g_u, g_v, b, m, r, nullptr, stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the forward (backward = 0) or backward (1) kernel at
// (m, r); launches nothing.
extern "C" int gpode_draw_solve_occupancy(int backward, int m, int r, int* out) {
  if (backward)
    return bwd_run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                   m, r, out, nullptr);
  return fwd_run(nullptr, nullptr, nullptr, 0.f, nullptr, nullptr, nullptr, 1, m, r,
                 out, nullptr);
}
