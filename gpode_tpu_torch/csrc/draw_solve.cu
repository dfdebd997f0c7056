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
// at B=5, M=100, R=1 for ~1.2e7 flop, ~0.84 ms at M=256.
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
// Past M = 128 (up to 256) a square factor no longer fits a block's shared
// memory (4 (M + R)(M + 1) bytes: 265 KB at M=256 against 227 KB), and the
// backward's two squares (L and W) twice over. The same steps then run on
// the packed lower triangle (M (M + 1) / 2 floats, 129 KB at M=256; rows
// i (i + 1) / 2 apart, so a warp reading a column meets at most two-way
// bank conflicts), with the same products and sums in the same order (the
// bits the square layout would give), arranged for a longer chain:
//
// * draw_solve_fwd_packed_kernel (PACKED_FWD_WARPS warps a factor): the
//   factor copied in with asynchronous four-byte copies (a load a thread at
//   a time waited out the memory's latency: ~100 us at M=256); the panels
//   as above, each panel also copied to an aligned slab from which the
//   trailing update runs on register tiles (trailing_update_tiled); the
//   augmented rows after the triangle at the odd stride; nu by tiles of 32
//   rows (tile_solve_upper), all warps taking each tile's terms off the
//   rows above it.
// * the backward in three launches, its work matrix W staged in global
//   memory (B x M x M floats, 1.3 MB at B=5, M=256: it stays in L2), since
//   W is square: draw_solve_bwd_cols_kernel (a grid of B x ceil((M + R) /
//   SLAB_COLS) blocks, SLAB_WARPS warps each; every block loads the packed
//   factor and solves g_c itself by tiles, then its SLAB_COLS columns of
//   [W | h] = L^{-T} [Phi | g_c], W written row-major);
//   draw_solve_bwd_rows_kernel (B x ceil(M / SLAB_COLS) blocks: rows of
//   Y = W L^{-1} from rows of W, in place); draw_solve_bwd_sym_kernel
//   (32 x 32 tiles of g_K = (Y + Y^T) / 2 through shared memory). The
//   slabs spread each factor's M^3-sized solves over 9 and 8 SMs where one
//   block would take them on one.
// At B=5, M=256, R=1 on an H100: forward 0.16 ms, backward 0.11 ms, where
// the library chain takes 1.37 ms (forward and backward). Still latency-
// bound: of the forward's 320k cycles, the trailing updates take ~130k,
// the eight diagonal blocks ~78k, the panels' rows ~47k, nu ~35k.
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
// L, g_K, and the packed backward's work W (B, M, M). Shapes: M <= 32 *
// MAX_ROWS on the square layout, M <= 32 * PACKED_ROWS on the packed one (a
// substitution's lane holds that many row slots), and every kernel's shared
// memory within a block's (ops/cuda_kernels.py `draw_solve_geometry`).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu
#define FWD_WARPS 8
#define FWD_THREADS (32 * FWD_WARPS)
#define PACKED_FWD_WARPS 16
#define PACKED_FWD_THREADS (32 * PACKED_FWD_WARPS)
#define BWD_WARPS 32
#define BWD_THREADS (32 * BWD_WARPS)
#define BWD_COLS 4
#define MAX_ROWS 4
#define PACKED_ROWS 8
#define SLAB_WARPS 8
#define TILE_ROWS 8
#define PANEL_STRIDE 36
#define SLAB_THREADS (32 * SLAB_WARPS)
#define SLAB_COLS (BWD_COLS * SLAB_WARPS)

// Shared-memory row stride: odd, so that a warp reading a column (32 rows)
// touches 32 banks.
__host__ __device__ __forceinline__ int row_stride(int m) { return m | 1; }

__host__ __device__ __forceinline__ int tri(int i) { return (i * (i + 1)) >> 1; }

// The packed forward's shared memory (floats): the triangle and the r
// augmented rows, then rdiag (m) from `packed_a_end`, then the panel copy,
// (m + r) rows of PANEL_STRIDE, 16-byte aligned.
__host__ __device__ __forceinline__ int packed_a_end(int m, int r) {
  return ((tri(m) + r * row_stride(m) + m + 3) & ~3) - m;
}

// Where row i of a factor starts in shared memory. Square: rows `ld` apart
// (the augmented rows after the factor's, the same way). Packed: row i < m
// of the lower triangle at i (i + 1) / 2; an augmented row i >= m after the
// triangle, `ld` apart.
struct Square {
  static constexpr bool packed = false;
  int ld;
  __device__ __forceinline__ int row(int i) const { return i * ld; }
};

struct Packed {
  static constexpr bool packed = true;
  int m, ld;
  __device__ __forceinline__ int row(int i) const {
    return i < m ? tri(i) : tri(m) + (i - m) * ld;
  }
};

// Start copying the lower triangle of the row-major (m, m) matrix G into the
// packed triangle at dst, one warp a row and a lane a column, four bytes a
// copy with no register in between, so that every copy is in flight at once
// (a load a thread at a time waits out the memory's latency each time).
// The caller waits (`__pipeline_wait_prior(0)`) and syncs.
__device__ __forceinline__ void copy_lower_async(float* __restrict__ dst,
                                                 const float* __restrict__ G, int m,
                                                 int warp, int warps, int lane) {
  for (int i = warp; i < m; i += warps)
    for (int k = lane; k <= i; k += 32)
      __pipeline_memcpy_async(dst + tri(i) + k, G + (size_t)i * m + k, 4);
  __pipeline_commit();
}

// Solve L x = b for the warp's NC columns in place: x[c][s] holds row
// lane + 32 s of column c (rows >= m are 0 and stay so). `rdiag` holds
// 1 / L_jj. Each step j turns the owner's b_j into x_j = b_j * rdiag[j] on
// every lane (the owner keeps b_j) and takes L_ij x_j off the rows below;
// the caller scales by rdiag at the end (`finish_rows`).
template <int ROWS, int NC, class Lay>
__device__ __forceinline__ void warp_solve_lower(const float* __restrict__ Ls,
                                                 const float* __restrict__ rdiag,
                                                 Lay lay, int m,
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
          const float lij = Ls[lay.row(i) + j];
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
// UNROLL steps are unrolled together, so that a step's reads of Ls issue
// under the one before (the packed backward's: 57 -> 36 us at M=256).
template <int ROWS, int NC, bool SCALED, int UNROLL = 1, class Lay>
__device__ __forceinline__ void warp_solve_upper(const float* __restrict__ Ls,
                                                 const float* __restrict__ rdiag,
                                                 Lay lay, int m,
                                                 float (&x)[NC][ROWS], int lane) {
#pragma unroll
  for (int sb = ROWS - 1; sb >= 0; --sb) {
    const int jn = min(32, m - 32 * sb);
#pragma unroll UNROLL
    for (int l = jn - 1; l >= 0; --l) {
      const int j = 32 * sb + l;
      const float* Lj = Ls + lay.row(j);
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
          const float lji = Lj[i];
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
template <class Lay>
__device__ __forceinline__ void factor_diagonal_block(float* __restrict__ A,
                                                      float* __restrict__ rdiag,
                                                      Lay lay, int c0, int nb,
                                                      int lane) {
  float* Ai = A + lay.row(c0 + min(lane, nb - 1)) + c0;
  float x[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) x[q] = (lane < nb && q <= lane) ? Ai[q] : 0.f;
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
    if (lane < nb && q <= lane) Ai[q] = x[q];
}

// Row i's entries in the panel's nb columns, l_i = a_i L11^{-T}, by forward
// substitution against the factored diagonal block (read by every lane at
// once), in place; one lane a row. No branch inside a step, so that its
// block reads issue ahead of the products: the entries past nb, never
// stored, take the block's last row.
template <class Lay>
__device__ __forceinline__ void panel_row(float* __restrict__ A,
                                          const float* __restrict__ rdiag, Lay lay,
                                          int c0, int nb, int i, bool live,
                                          float* __restrict__ Pi) {
  float* Ai = A + lay.row(i) + c0;
  float x[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) x[q] = (live && q < nb) ? Ai[q] : 0.f;
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    if (jj >= nb) break;
    x[jj] = __fmul_rn(x[jj], rdiag[c0 + jj]);
#pragma unroll
    for (int kk = jj + 1; kk < 32; ++kk)
      x[kk] = fmaf(-A[lay.row(c0 + min(kk, nb - 1)) + c0 + jj], x[jj], x[kk]);
  }
#pragma unroll
  for (int q = 0; q < 32; ++q)
    if (live && q < nb) Ai[q] = x[q];
  if constexpr (Lay::packed) {
#pragma unroll
    for (int q = 0; q < 32; ++q)
      if (live) Pi[q] = q < nb ? x[q] : 0.f;
  }
}

// The trailing lower triangle (rows [c1, mr), columns [c1, m)) less the
// panel's rank-nb product: one thread a column k and four rows, so that
// four independent sums share each read of column k's panel entries; each
// element's nb terms in column order.
template <class Lay>
__device__ __forceinline__ void trailing_update(float* __restrict__ A, Lay lay,
                                                int m, int mr, int c0, int nb,
                                                int tid) {
  const int c1 = c0 + nb, tc = m - c1, groups = (mr - c1 + 3) / 4;
  for (int e = tid; e < groups * tc; e += FWD_THREADS) {
    const int g = e / tc, k = c1 + (e - g * tc);
    const int i0 = c1 + 4 * g;
    if (k > i0 + 3) continue;  // all four above the diagonal
    const float* lk = A + lay.row(k) + c0;
    const float* li[4];
    float acc[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = min(i0 + t, mr - 1);
      li[t] = A + lay.row(i) + c0;
      acc[t] = li[t][k - c0];  // above the diagonal: read, never written back
    }
#pragma unroll 8
    for (int q = 0; q < nb; ++q) {
      const float l = lk[q];
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t] = fmaf(-li[t][q], l, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (i0 + t < mr && k <= i0 + t) A[lay.row(i0 + t) + k] = acc[t];
  }
}

// The packed forward's trailing update: the same elements and each one's
// terms in column order as trailing_update, on register tiles fed from P,
// a copy of the panel (row i >= c1 at (i - c1) PANEL_STRIDE, 16-byte
// aligned, written by panel_row), so that one shared-memory read feeds
// several products: warp w takes tiles of TILE_ROWS rows by 128 columns,
// lane l the columns kb + l + 32 c (c < 4), each thread TILE_ROWS x 4 sums
// and four columns of a row a read; a tile wholly above the diagonal is
// skipped. (The one-row-group update reads five values a four products and
// waits on shared memory: 96 of the 200 us of the forward at M=256.) A full
// panel (32 columns) is the only one with a trailing part to update.
__device__ __forceinline__ void trailing_update_tiled(float* __restrict__ A, Packed lay,
                                                      const float* __restrict__ P,
                                                      int m, int mr, int c1,
                                                      int warp, int lane) {
  const int row_tiles = (mr - c1 + TILE_ROWS - 1) / TILE_ROWS;
  const int col_tiles = (m - c1 + 127) / 128;
  for (int item = warp; item < row_tiles * col_tiles; item += PACKED_FWD_WARPS) {
    const int g = item / col_tiles, h = item - g * col_tiles;
    const int i0 = c1 + TILE_ROWS * g, kb = c1 + 128 * h;
    if (kb > i0 + TILE_ROWS - 1) continue;  // wholly above the diagonal
    const float* rp[TILE_ROWS];
    const float* cp[4];
    int ks[4];
    float acc[TILE_ROWS][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ks[c] = min(kb + lane + 32 * c, m - 1);
      cp[c] = P + (ks[c] - c1) * PANEL_STRIDE;
    }
#pragma unroll
    for (int t = 0; t < TILE_ROWS; ++t) {
      const int i = min(i0 + t, mr - 1);
      rp[t] = P + (i - c1) * PANEL_STRIDE;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][c] = A[lay.row(i) + ks[c]];  // above the diagonal: read, never written back
    }
#pragma unroll 2
    for (int q = 0; q < 32; q += 4) {
      float4 lc[4], lr[TILE_ROWS];
#pragma unroll
      for (int c = 0; c < 4; ++c) lc[c] = *reinterpret_cast<const float4*>(cp[c] + q);
#pragma unroll
      for (int t = 0; t < TILE_ROWS; ++t) lr[t] = *reinterpret_cast<const float4*>(rp[t] + q);
#pragma unroll
      for (int t = 0; t < TILE_ROWS; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[t][c] = fmaf(-lr[t].x, lc[c].x, acc[t][c]);
          acc[t][c] = fmaf(-lr[t].y, lc[c].y, acc[t][c]);
          acc[t][c] = fmaf(-lr[t].z, lc[c].z, acc[t][c]);
          acc[t][c] = fmaf(-lr[t].w, lc[c].w, acc[t][c]);
        }
    }
#pragma unroll
    for (int t = 0; t < TILE_ROWS; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + t, k = kb + lane + 32 * c;
        if (i < mr && k < m && k <= i) A[lay.row(i) + k] = acc[t][c];
      }
  }
}

// x = L^{-T} b for the r columns at X (column q at X + q ldx), in place, by
// tiles of 32 rows from the last: one warp a column solves the tile's rows
// (as warp_solve_upper with one row slot a lane), then every thread takes
// the tile's terms off one row above it, in the same descending order; a
// tile's 32 steps unrolled, so that its reads of L issue ahead of the chain.
// The same products and sums as warp_solve_upper + finish_rows (the same
// bits), with every warp at work where one warp would take the whole chain
// (30 us of the forward at M=256, one column).
template <class Lay>
__device__ __forceinline__ void tile_solve_upper(const float* __restrict__ Ls,
                                                 const float* __restrict__ rdiag,
                                                 Lay lay, int m, float* __restrict__ X,
                                                 int r, int ldx, int warps, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  for (int t0 = ((m - 1) / 32) * 32; t0 >= 0; t0 -= 32) {
    const int n = min(32, m - t0), i = t0 + lane;
    for (int q = warp; q < r; q += warps) {
      float* xq = X + q * ldx;
      float b = lane < n ? xq[i] : 0.f;
#pragma unroll
      for (int jj = 31; jj >= 0; --jj) {
        if (jj < n) {
          const float xj = __fmul_rn(__shfl_sync(FULL_MASK, b, jj), rdiag[t0 + jj]);
          if (lane < jj) b = fmaf(-Ls[lay.row(t0 + jj) + i], xj, b);
        }
      }
      if (lane < n) xq[i] = __fmul_rn(b, rdiag[i]);
    }
    __syncthreads();
    for (int e = tid; e < r * t0; e += 32 * warps) {
      const int q = e / t0, ii = e - q * t0;
      float* xq = X + q * ldx;
      float b = xq[ii];
#pragma unroll
      for (int jj = 31; jj >= 0; --jj)
        if (jj < n) b = fmaf(-Ls[lay.row(t0 + jj) + ii], xq[t0 + jj], b);
      xq[ii] = b;
    }
    __syncthreads();
  }
}

// x = L^{-1} b for the r columns at X, in place, by tiles of 32 rows from
// the first, as tile_solve_upper: the same bits as warp_solve_lower +
// finish_rows.
template <class Lay>
__device__ __forceinline__ void tile_solve_lower(const float* __restrict__ Ls,
                                                 const float* __restrict__ rdiag,
                                                 Lay lay, int m, float* __restrict__ X,
                                                 int r, int ldx, int warps, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  for (int t0 = 0; t0 < m; t0 += 32) {
    const int n = min(32, m - t0), i = t0 + lane;
    const float* Li = Ls + lay.row(min(i, m - 1)) + t0;
    for (int q = warp; q < r; q += warps) {
      float* xq = X + q * ldx;
      float b = lane < n ? xq[i] : 0.f;
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        if (jj < n) {
          const float xj = __fmul_rn(__shfl_sync(FULL_MASK, b, jj), rdiag[t0 + jj]);
          if (lane > jj && lane < n) b = fmaf(-Li[jj], xj, b);
        }
      }
      if (lane < n) xq[i] = __fmul_rn(b, rdiag[i]);
    }
    __syncthreads();
    const int t1 = t0 + n, below = m - t1;
    for (int e = tid; e < r * below; e += 32 * warps) {
      const int q = e / below, ii = t1 + (e - q * below);
      float* xq = X + q * ldx;
      const float* Lii = Ls + lay.row(ii) + t0;
      float b = xq[ii];
#pragma unroll
      for (int jj = 0; jj < 32; ++jj)
        if (jj < n) b = fmaf(-Lii[jj], xq[t0 + jj], b);
      xq[ii] = b;
    }
    __syncthreads();
  }
}

// The forward on layout `lay` with ROWS row slots a lane. Shared memory
// (floats): A the augmented factor [K + jitter I; u^T] (`Lay` places its
// rows), factored in place into [L; a^T]; rdiag (m) after it, at `a_end`.
template <int ROWS, class Lay>
__device__ __forceinline__ void draw_solve_fwd(const float* __restrict__ K,
                                               const float* __restrict__ u,
                                               const float* __restrict__ v,
                                               float jitter, float* __restrict__ L,
                                               float* __restrict__ a,
                                               float* __restrict__ nu, int m, int r,
                                               Lay lay, int a_end, float* smem) {
  const int mr = m + r;
  float* A = smem;
  float* rdiag = A + a_end;
  float* P = rdiag + m;  // packed: the panel's copy, 16-byte aligned
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t fm = (size_t)blockIdx.x * m;
  K += fm * m;
  L += fm * m;
  u += fm * r;
  v += fm * r;
  a += fm * r;
  nu += fm * r;

  if constexpr (Lay::packed) {
    copy_lower_async(A, K, m, warp, PACKED_FWD_WARPS, lane);
    for (int e = tid; e < r * m; e += PACKED_FWD_THREADS) {
      const int q = e / m;
      __pipeline_memcpy_async(A + lay.row(m + q) + (e - q * m), u + e, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int i = tid; i < m; i += PACKED_FWD_THREADS)
      A[tri(i) + i] = __fadd_rn(A[tri(i) + i], jitter);
  } else {
#pragma unroll 4
    for (int e = tid; e < m * m; e += FWD_THREADS) {
      const int i = e / m, k = e - i * m;
      const float val = K[e];
      A[lay.row(i) + k] = i == k ? __fadd_rn(val, jitter) : val;
    }
#pragma unroll 4
    for (int e = tid; e < r * m; e += FWD_THREADS) {
      const int q = e / m;
      A[lay.row(m + q) + (e - q * m)] = u[e];
    }
  }
  __syncthreads();

  if constexpr (Lay::packed) {
    // As below, the trailing update on register tiles
    for (int c0 = 0; c0 < m; c0 += 32) {
      const int nb = min(32, m - c0), c1 = c0 + nb;
      if (warp == 0) factor_diagonal_block(A, rdiag, lay, c0, nb, lane);
      __syncthreads();
      for (int i0 = c1 + 32 * warp; i0 < mr; i0 += 32 * PACKED_FWD_WARPS)
        panel_row(A, rdiag, lay, c0, nb, min(i0 + lane, mr - 1), i0 + lane < mr,
                  P + (i0 + lane - c1) * PANEL_STRIDE);
      __syncthreads();
      trailing_update_tiled(A, lay, P, m, mr, c1, warp, lane);
      __syncthreads();
    }

    // a out; c = v - a in the augmented rows; nu = L^{-T} c there by tiles
    float* X = A + lay.row(m);
    for (int e = tid; e < r * m; e += PACKED_FWD_THREADS) {
      const int q = e / m, i = e - q * m;
      const float aq = X[q * lay.ld + i];
      a[e] = aq;
      X[q * lay.ld + i] = __fsub_rn(v[e], aq);
    }
    __syncthreads();
    tile_solve_upper(A, rdiag, lay, m, X, r, lay.ld, PACKED_FWD_WARPS, tid);
    for (int e = tid; e < r * m; e += PACKED_FWD_THREADS) {
      const int q = e / m;
      nu[e] = X[q * lay.ld + (e - q * m)];
    }
    for (int i = warp; i < m; i += PACKED_FWD_WARPS)
      for (int k = lane; k < m; k += 32) L[(size_t)i * m + k] = k <= i ? A[tri(i) + k] : 0.f;
    return;
  }

  // Right-looking by panels of 32 columns: the diagonal block (one warp),
  // the panel's rows below it, augmented rows included (one lane a row),
  // then the trailing lower triangle less the panel's rank-nb product.
  for (int c0 = 0; c0 < m; c0 += 32) {
    const int nb = min(32, m - c0), c1 = c0 + nb;
    if (warp == 0) factor_diagonal_block(A, rdiag, lay, c0, nb, lane);
    __syncthreads();
    for (int i0 = c1 + 32 * warp; i0 < mr; i0 += 32 * FWD_WARPS)
      panel_row(A, rdiag, lay, c0, nb, min(i0 + lane, mr - 1), i0 + lane < mr, P);
    __syncthreads();
    trailing_update(A, lay, m, mr, c0, nb, tid);
    __syncthreads();
  }

  // nu = L^{-T} (v - a), one warp a right-hand column
  for (int q = warp; q < r; q += FWD_WARPS) {
    const float* aq = A + lay.row(m + q);
    float x[1][ROWS];
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = lane + 32 * s;
      x[0][s] = i < m ? __fsub_rn(v[q * m + i], aq[i]) : 0.f;
    }
    warp_solve_upper<ROWS, 1, false>(A, rdiag, lay, m, x, lane);
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
    L[e] = k <= i ? A[lay.row(i) + k] : 0.f;
  }
}

// M <= 32 * MAX_ROWS: the square factor, (m + r) rows of row_stride(m).
static __global__ void __launch_bounds__(FWD_THREADS)
draw_solve_fwd_kernel(const float* __restrict__ K, const float* __restrict__ u,
                      const float* __restrict__ v, float jitter,
                      float* __restrict__ L, float* __restrict__ a,
                      float* __restrict__ nu, int m, int r) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(m);
  draw_solve_fwd<MAX_ROWS>(K, u, v, jitter, L, a, nu, m, r, Square{ld},
                           (m + r) * ld, smem);
}

// M <= 32 * PACKED_ROWS: the packed triangle, then r rows of row_stride(m).
static __global__ void __launch_bounds__(PACKED_FWD_THREADS, 1)
draw_solve_fwd_packed_kernel(const float* __restrict__ K, const float* __restrict__ u,
                             const float* __restrict__ v, float jitter,
                             float* __restrict__ L, float* __restrict__ a,
                             float* __restrict__ nu, int m, int r) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(m);
  draw_solve_fwd<PACKED_ROWS>(K, u, v, jitter, L, a, nu, m, r, Packed{m, ld},
                              packed_a_end(m, r), smem);
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
  const Square lay{ld};
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
    warp_solve_lower<ROWS, 1>(Ls, rdiag, lay, m, x, lane);
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
    warp_solve_upper<ROWS, NC, true>(Ls, rdiag, lay, m, x, lane);
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
    warp_solve_upper<ROWS, NC, true>(Ls, rdiag, lay, m, x, lane);
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
// The packed backward: three launches, W in global memory
// ---------------------------------------------------------------------------

// The packed U of factor L (the block's factor, row-major (m, m) in global
// memory) into Us, and rdiag = 1 / diag(L): Us holds row j of L below the
// diagonal times rdiag[j], and L_jj on the diagonal.
__device__ __forceinline__ void load_packed_u(const float* __restrict__ L,
                                              float* __restrict__ Us,
                                              float* __restrict__ rdiag, int m,
                                              int tid) {
  copy_lower_async(Us, L, m, tid >> 5, SLAB_WARPS, tid & 31);
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int j = tid; j < m; j += SLAB_THREADS) rdiag[j] = __frcp_rn(Us[tri(j) + j]);
  __syncthreads();
  for (int j = tid >> 5; j < m; j += SLAB_WARPS)
    for (int i = tid & 31; i < j; i += 32) Us[tri(j) + i] = __fmul_rn(Us[tri(j) + i], rdiag[j]);
}

// Block (f, p): factor f, columns [p SLAB_COLS, (p + 1) SLAB_COLS) of
// [Phi | g_c] (M + R columns), BWD_COLS a warp. Shared memory (floats): Ls
// the packed L, then U (tri(m)); as, cs, gs (r x m) a, c = v - a, g_nu then
// g_c; rdiag (m). Every block solves g_c itself (tiles); the first of a
// factor writes g_v = g_c. W's columns go row-major into W (m, m), g_u = -h.
static __global__ void __launch_bounds__(SLAB_THREADS, 1)
draw_solve_bwd_cols_kernel(const float* __restrict__ L, const float* __restrict__ a,
                           const float* __restrict__ v, const float* __restrict__ g_nu,
                           float* __restrict__ W, float* __restrict__ g_u,
                           float* __restrict__ g_v, int m, int r) {
  constexpr int ROWS = PACKED_ROWS, NC = BWD_COLS;
  extern __shared__ __align__(16) float smem[];
  const Packed lay{m, row_stride(m)};
  float* Ls = smem;
  float* as = Ls + tri(m);
  float* cs = as + r * m;
  float* gs = cs + r * m;
  float* rdiag = gs + r * m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t fm = (size_t)blockIdx.x * m;
  L += fm * m;
  W += fm * m;
  a += fm * r;
  v += fm * r;
  g_nu += fm * r;
  g_u += fm * r;
  g_v += fm * r;

  copy_lower_async(Ls, L, m, warp, SLAB_WARPS, lane);
  for (int e = tid; e < r * m; e += SLAB_THREADS) {
    const float ae = a[e];
    as[e] = ae;
    cs[e] = __fsub_rn(v[e], ae);
    gs[e] = g_nu[e];
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int j = tid; j < m; j += SLAB_THREADS) rdiag[j] = __frcp_rn(Ls[tri(j) + j]);
  __syncthreads();

  // g_c = L^{-1} g_nu (= g_v)
  tile_solve_lower(Ls, rdiag, lay, m, gs, r, m, SLAB_WARPS, tid);
  if (blockIdx.y == 0)
    for (int e = tid; e < r * m; e += SLAB_THREADS) g_v[e] = gs[e];
  // U: row j of L (below the diagonal) times 1 / L_jj
  for (int j = warp; j < m; j += SLAB_WARPS)
    for (int i = lane; i < j; i += 32) Ls[tri(j) + i] = __fmul_rn(Ls[tri(j) + i], rdiag[j]);
  __syncthreads();

  // [W | h] = L^{-T} [Phi | g_c] on this block's columns
  const int c0 = blockIdx.y * SLAB_COLS + warp * NC;
  if (c0 >= m + r) return;
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
  warp_solve_upper<ROWS, NC, true, 2>(Ls, rdiag, lay, m, x, lane);
  finish_rows<ROWS, NC>(rdiag, m, x, lane);
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    const int q = c0 + cc;
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = lane + 32 * s;
      if (i < m) {
        if (q < m)
          W[(size_t)i * m + q] = x[cc][s];
        else if (q < m + r)
          g_u[(q - m) * m + i] = -x[cc][s];
      }
    }
  }
}

// Block (f, p): rows [p SLAB_COLS, (p + 1) SLAB_COLS) of Y = W L^{-1},
// BWD_COLS a warp: L^T y_q = w_q, row q of W replaced by row q of Y.
// Shared memory (floats): the packed U (tri(m)); rdiag (m).
static __global__ void __launch_bounds__(SLAB_THREADS, 1)
draw_solve_bwd_rows_kernel(const float* __restrict__ L, float* __restrict__ W,
                           int m) {
  constexpr int ROWS = PACKED_ROWS, NC = BWD_COLS;
  extern __shared__ __align__(16) float smem[];
  const Packed lay{m, row_stride(m)};
  float* Us = smem;
  float* rdiag = Us + tri(m);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t fm = (size_t)blockIdx.x * m;
  L += fm * m;
  W += fm * m;
  load_packed_u(L, Us, rdiag, m, tid);
  __syncthreads();

  const int c0 = blockIdx.y * SLAB_COLS + warp * NC;
  if (c0 >= m) return;
  float x[NC][ROWS];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    const int q = c0 + cc;
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = lane + 32 * s;
      x[cc][s] = (q < m && i < m) ? W[(size_t)q * m + i] : 0.f;
    }
  }
  warp_solve_upper<ROWS, NC, true, 2>(Us, rdiag, lay, m, x, lane);
  finish_rows<ROWS, NC>(rdiag, m, x, lane);
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    const int q = c0 + cc;
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = lane + 32 * s;
      if (q < m && i < m) W[(size_t)q * m + i] = x[cc][s];
    }
  }
}

// Block (f, t): tile t of the lower tiles (ti >= tj) of 32 x 32 of
// g_K = (Y + Y^T) / 2, and its mirror: the tiles (ti, tj) and (tj, ti) of Y
// through shared memory (2 x 32 x 33 floats), each output written once.
static __global__ void __launch_bounds__(SLAB_THREADS)
draw_solve_bwd_sym_kernel(const float* __restrict__ Y, float* __restrict__ g_K,
                          int m) {
  __shared__ float lo[32][33], up[32][33];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  int ti = 0, t = blockIdx.y;
  while (t > ti) t -= ++ti;   // t-th tile of the lower triangle, row-major
  const int tj = t;
  const size_t fm = (size_t)blockIdx.x * m;
  Y += fm * m;
  g_K += fm * m;
  const int r0 = 32 * ti, k0 = 32 * tj;
  for (int y = ty; y < 32; y += SLAB_WARPS) {
    const int i = r0 + y, k = k0 + tx, i2 = k0 + y, k2 = r0 + tx;
    lo[y][tx] = (i < m && k < m) ? Y[(size_t)i * m + k] : 0.f;
    up[y][tx] = (i2 < m && k2 < m) ? Y[(size_t)i2 * m + k2] : 0.f;
  }
  __syncthreads();
  for (int y = ty; y < 32; y += SLAB_WARPS) {
    const int i = r0 + y, k = k0 + tx, i2 = k0 + y, k2 = r0 + tx;
    if (i < m && k < m) g_K[(size_t)i * m + k] = __fmul_rn(0.5f, __fadd_rn(lo[y][tx], up[tx][y]));
    if (ti != tj && i2 < m && k2 < m)
      g_K[(size_t)i2 * m + k2] = __fmul_rn(0.5f, __fadd_rn(up[y][tx], lo[tx][y]));
  }
}

// ---------------------------------------------------------------------------
// Launchers (C interface: ops/cuda_kernels.py)
// ---------------------------------------------------------------------------

static bool packed_m(int m) { return m > 32 * MAX_ROWS; }

static bool shape_ok(int b, int m, int r) {
  return b >= 1 && m >= 1 && r >= 1 && m <= 32 * PACKED_ROWS;
}

static size_t fwd_smem(int m, int r) {
  const size_t ld = row_stride(m);
  if (packed_m(m))
    return sizeof(float) * ((size_t)packed_a_end(m, r) + m + (size_t)(m + r) * PANEL_STRIDE);
  return sizeof(float) * ((size_t)(m + r) * ld + m);
}

static size_t bwd_smem(int m, int r) {
  const size_t ld = row_stride(m);
  return sizeof(float) * (2 * (size_t)m * ld + 3 * (size_t)r * m + m);
}

static size_t cols_smem(int m, int r) {
  return sizeof(float) * ((size_t)tri(m) + 3 * (size_t)r * m + m);
}

static size_t rows_smem(int m) { return sizeof(float) * ((size_t)tri(m) + m); }

static int slabs(int n) { return (n + SLAB_COLS - 1) / SLAB_COLS; }

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
  auto kernel = packed_m(m) ? draw_solve_fwd_packed_kernel : draw_solve_fwd_kernel;
  const int threads = packed_m(m) ? PACKED_FWD_THREADS : FWD_THREADS;
  cudaError_t e = prepare(kernel, threads, smem, occupancy);
  if (e == cudaSuccess && !occupancy) {
    kernel<<<b, threads, smem, (cudaStream_t)stream>>>(K, u, v, jitter, L, a, nu, m,
                                                       r);
    e = cudaGetLastError();
  }
  return (int)e;
}

static int bwd_run(const float* L, const float* a, const float* v,
                   const float* g_nu, float* g_K, float* g_u, float* g_v, int b,
                   int m, int r, int* occupancy, void* stream) {
  if (!shape_ok(b, m, r) || packed_m(m)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(m, r);
  cudaError_t e = prepare(draw_solve_bwd_kernel, BWD_THREADS, smem, occupancy);
  if (e == cudaSuccess && !occupancy) {
    draw_solve_bwd_kernel<<<b, BWD_THREADS, smem, (cudaStream_t)stream>>>(
        L, a, v, g_nu, g_K, g_u, g_v, m, r);
    e = cudaGetLastError();
  }
  return (int)e;
}

// The packed backward's three launches, or with `occupancy` the resources of
// its kernel `stage` (0 columns, 1 rows, 2 symmetrisation).
static int slabs_run(const float* L, const float* a, const float* v,
                     const float* g_nu, float* W, float* g_K, float* g_u,
                     float* g_v, int b, int m, int r, int stage, int* occupancy,
                     void* stream) {
  if (!shape_ok(b, m, r) || !packed_m(m)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t cs = cols_smem(m, r), rs = rows_smem(m);
  if (occupancy) {
    if (stage == 0)
      return (int)prepare(draw_solve_bwd_cols_kernel, SLAB_THREADS, cs, occupancy);
    if (stage == 1)
      return (int)prepare(draw_solve_bwd_rows_kernel, SLAB_THREADS, rs, occupancy);
    return (int)prepare(draw_solve_bwd_sym_kernel, SLAB_THREADS, 0, occupancy);
  }
  cudaError_t e = prepare(draw_solve_bwd_cols_kernel, SLAB_THREADS, cs, nullptr);
  if (e == cudaSuccess)
    e = prepare(draw_solve_bwd_rows_kernel, SLAB_THREADS, rs, nullptr);
  if (e != cudaSuccess) return (int)e;
  draw_solve_bwd_cols_kernel<<<dim3(b, slabs(m + r)), SLAB_THREADS, cs, s>>>(
      L, a, v, g_nu, W, g_u, g_v, m, r);
  draw_solve_bwd_rows_kernel<<<dim3(b, slabs(m)), SLAB_THREADS, rs, s>>>(L, W, m);
  const int tiles = (m + 31) / 32;
  draw_solve_bwd_sym_kernel<<<dim3(b, tiles * (tiles + 1) / 2), SLAB_THREADS, 0, s>>>(
      W, g_K, m);
  return (int)cudaGetLastError();
}

// The forward on `stream`: K (b, m, m), u, v (b, r, m) in; L (b, m, m),
// a, nu (b, r, m) out. The packed kernel past m = 32 * MAX_ROWS.
extern "C" int gpode_draw_solve_fwd(const float* K, const float* u, const float* v,
                                    float jitter, float* L, float* a, float* nu,
                                    int b, int m, int r, void* stream) {
  return fwd_run(K, u, v, jitter, L, a, nu, b, m, r, nullptr, stream);
}

// The backward on `stream` (m <= 32 * MAX_ROWS): L (b, m, m), a, v, g_nu
// (b, r, m) in; g_K (b, m, m), g_u, g_v (b, r, m) out.
extern "C" int gpode_draw_solve_bwd(const float* L, const float* a, const float* v,
                                    const float* g_nu, float* g_K, float* g_u,
                                    float* g_v, int b, int m, int r, void* stream) {
  return bwd_run(L, a, v, g_nu, g_K, g_u, g_v, b, m, r, nullptr, stream);
}

// The packed backward on `stream` (32 * MAX_ROWS < m <= 32 * PACKED_ROWS):
// as gpode_draw_solve_bwd, with W (b, m, m) its work matrix.
extern "C" int gpode_draw_solve_bwd_slabs(const float* L, const float* a,
                                          const float* v, const float* g_nu,
                                          float* W, float* g_K, float* g_u,
                                          float* g_v, int b, int m, int r,
                                          void* stream) {
  return slabs_run(L, a, v, g_nu, W, g_K, g_u, g_v, b, m, r, 0, nullptr, stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of kernel `kernel` at (m, r): 0 the forward (square or packed
// by m), 1 the one-block backward, 2-4 the packed backward's columns, rows
// and symmetrisation kernels; launches nothing.
extern "C" int gpode_draw_solve_occupancy(int kernel, int m, int r, int* out) {
  if (kernel == 0)
    return fwd_run(nullptr, nullptr, nullptr, 0.f, nullptr, nullptr, nullptr, 1, m, r,
                   out, nullptr);
  if (kernel == 1)
    return bwd_run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                   m, r, out, nullptr);
  return slabs_run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, 1, m, r, kernel - 2, out, nullptr);
}
