// The wide-layout rhs for Hopper (sm_90a): the same sampled vector field as
// fused_rhs.cu, computed over PACKED operands that lay all D output dims side
// by side along one wide column axis of W = D*(Sp + Mp) columns:
//
//   t   = x @ B                 B = [omega_wide | z/ls^2 wide]      (Din, W)
//   xn  = x^2 @ invls2          invls2 = (1/ls^2)^T                 (Din, D)
//   act = [cos(t_rff + phase) | exp(t_gram - (xn + zn)/2)]          (N, W)
//   f   = act @ Wblk            Wblk block-diagonal, scales folded  (W, D)
//
// (the Gram exponent is the norm expansion |xd - zd|^2 = xn + zn - 2 xd.zd).
// Dim d's columns are its rff block [d*Sp, (d+1)*Sp) and its Gram block
// [D*Sp + d*Mp, D*Sp + (d+1)*Mp). Three entry points:
//   gpode_wide_fwd, dense=1: f = act @ Wblk with the dense (W, D) block
//     matrix, every column against all D outputs;
//   gpode_wide_fwd, dense=0: the same t/act, then each column times ONE flat
//     weight [wsc | nuvar] (W,) summed into its own dim (multiply-reduce);
//   gpode_wide_bwd: recompute t/act, then dact = g @ Wblk^T, dt, dx and the
//     five packed parameter cotangents db (Din, W), dwblk (W, D), dphase
//     (D*Sp), dzn (D*Mp), dinvls2 (Din, D).
//
// Replaces scripts/proto_wide_rhs.py `fused_rhs_wide` (:102, pallas_call
// :112), `fused_rhs_wide2` (:153, :168) and `fused_rhs_wide_bwd` (:294, :305).
//
// Bound: arithmetic, as for fused_rhs.cu: W cos/exp and about W*(Din + D)
// FMAs per row against Din + D floats of traffic; the packed operands (~75 KB
// at S=256, M=100, D=Din=5) are shared by all rows and stay in L1/L2. What
// decides the time is how many accurate cosf/sincosf/expf chains are in
// flight, so both directions run on the row tile of rhs_tile.cuh: a lane
// takes one packed column of a 32-column unit (units never straddle a dim's
// block: Sp and Mp are multiples of 32), loads its parameters once per tile
// of RT rows and runs the RT rows as independent chains, its sums over the
// tile in registers. All loops over Din and D have the compile-time bound DP
// >= max(Din, D) (operands zero beyond their width); every product is FFMA
// in float32 - the exponent is a difference of large terms, which TF32 would
// not survive.
//
// Forward: one tile per block; the block is G groups of D warps, warp
// (grp, d) takes dim d's units grp, grp + G, ... The dense contraction keeps
// RT * DP register sums [r * DP + e] (every column feeds all D outputs), the
// multiply-reduce RT sums [r] (a column feeds only its own dim); one
// transposing fold per tile sums them over the lanes, and the warps meet in
// shared memory, added in warp order.
//
// Backward: a 2-D grid of (row block, dim) blocks. Block (rb, d) takes dim
// d's columns only - the warps share its units - and walks its row block in
// tiles of RT rows. Per tile a lane adds, over the tile's rows, its column's
// cotangent shares db (Din), dwblk (D) and dt (1) in registers and then into
// the block's shared-memory accumulators (every address has exactly one
// owning lane); its dx shares (RT * DP) and dxn shares (RT, the row sums of
// dte over dim d's Gram block) stay in registers across its units and fold
// once per tile. So a block's slab covers only its dim's columns, the
// row-sum dxn never leaves the block, and dx leaves as one share per dim.
// `wide_reduce_kernel` adds the slabs over row blocks, in block order,
// straight into the packed layout, and dx's shares over dims, in dim order.
// No float atomics: reruns are bit-identical.
//
// Padded columns contribute exactly 0: padded rff columns have B = 0,
// phase = 0 and a zero Wblk row; padded Gram columns have zn = 1e30, so
// exp(-5e29) == 0. Rows past N are skipped by a warp-uniform row count and
// never stored. Accurate cosf/sincosf/expf (no --use_fast_math).

#include "rhs_tile.cuh"

struct WideParams {
  const float* b;       // (Din, W)
  const float* phase;   // (D*Sp)
  const float* zn;      // (D*Mp)
  const float* invls2;  // (Din, D)
  int din, d, sp, mp, w;
};

static inline WideParams make_wide(const float* b, const float* phase,
                                   const float* zn, const float* invls2, int din,
                                   int d, int sp, int mp) {
  WideParams p;
  p.b = b; p.phase = phase; p.zn = zn; p.invls2 = invls2;
  p.din = din; p.d = d; p.sp = sp; p.mp = mp; p.w = d * (sp + mp);
  return p;
}

// Packed column of lane `lane` in unit `unit` of dim d (rff units first).
__device__ __forceinline__ int wide_column(const WideParams& p, int d, int unit,
                                           int lane) {
  const int su = p.sp >> 5;
  return unit < su ? d * p.sp + (unit << 5) + lane
                   : p.d * p.sp + d * p.mp + ((unit - su) << 5) + lane;
}

// The first DP entries of column c of a row-major (rows, width) operand
// (zero beyond `rows`) and of row c of a (c, width) one (zero beyond
// `width`).
template <int DP>
__device__ __forceinline__ void wide_load_column(const float* src, int rows,
                                                 int width, int c, float (&v)[DP]) {
#pragma unroll
  for (int k = 0; k < DP; ++k) v[k] = (k < rows) ? src[(size_t)k * width + c] : 0.f;
}
template <int DP>
__device__ __forceinline__ void wide_load_row(const float* src, int width, int c,
                                              float (&v)[DP]) {
#pragma unroll
  for (int e = 0; e < DP; ++e) v[e] = (e < width) ? src[(size_t)c * width + e] : 0.f;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Shared memory (floats): xt (RT, tile_stride(DP)) rows of x | xn (RT, D) |
// red (warps, 32) the warps' folded sums.
__host__ __device__ constexpr int wide_fwd_smem_floats(int dp, int rt, int d,
                                                       int warps) {
  return rt * tile_stride(dp) + align4(rt * d) + 32 * warps;
}

// One warp's share of f over the first `rows` rows of a tile: the columns
// of dim d's units grp, grp + groups, ... DENSE: wts is Wblk (W, D), each
// column's activation times its Wblk row into sums [r * DP + e]; otherwise
// wts is the flat row (W,), each activation times its weight into sums [r].
// Writes the sums, each summed over the warp's lanes, to sums_w (32 floats).
template <int DP, int RT, bool DENSE>
__device__ __forceinline__ void wide_fwd_tile(const WideParams& p,
                                              const float* __restrict__ wts,
                                              const float* xt, const float* xn,
                                              int rows, int d, int grp, int groups,
                                              int lane, float* sums_w) {
  constexpr int XS = tile_stride(DP);
  constexpr int NV = DENSE ? RT * DP : RT;
  constexpr int V = fold_width(NV);
  static_assert(NV <= 32, "a tile's sums must fit one fold");
  constexpr int NW = DENSE ? DP : 1;
  const int su = p.sp >> 5, units = su + (p.mp >> 5);

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int unit = grp; unit < units; unit += groups) {
    const int c = wide_column(p, d, unit, lane);
    float bk[DP], wv[NW];
    wide_load_column<DP>(p.b, p.din, p.w, c, bk);
    if constexpr (DENSE)
      wide_load_row<NW>(wts, p.d, c, wv);
    else
      wv[0] = wts[c];
    if (unit < su) {  // warp-uniform
      const float ph = p.phase[c];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < rows) {
          float x[DP];
          tile_row<DP>(xt + r * XS, x);
          float t = 0.f;
#pragma unroll
          for (int k = 0; k < DP; ++k) t = fmaf(x[k], bk[k], t);
          const float a = cosf(t + ph);
#pragma unroll
          for (int e = 0; e < NW; ++e)
            acc[r * NW + e] = fmaf(a, wv[e], acc[r * NW + e]);
        }
      }
    } else {
      const float znj = p.zn[c - p.d * p.sp];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < rows) {
          float x[DP];
          tile_row<DP>(xt + r * XS, x);
          float t = 0.f;
#pragma unroll
          for (int k = 0; k < DP; ++k) t = fmaf(x[k], bk[k], t);
          const float a = expf(t - 0.5f * (xn[r * p.d + d] + znj));
#pragma unroll
          for (int e = 0; e < NW; ++e)
            acc[r * NW + e] = fmaf(a, wv[e], acc[r * NW + e]);
        }
      }
    }
  }

  const float total = LaneFold<V, 16>::run(acc, lane);
  constexpr int SHIFT = fold_shift(NV);
  if ((lane & ((1 << SHIFT) - 1)) == 0) sums_w[lane >> SHIFT] = total;
}

template <int DP, int RT, int MAXT, bool DENSE>
static __global__ void __launch_bounds__(MAXT)
wide_fwd_kernel(const float* __restrict__ x, WideParams p,
                const float* __restrict__ wts, float* __restrict__ out, int n,
                int groups) {
  extern __shared__ __align__(16) float smem[];
  constexpr int XS = tile_stride(DP);
  const int D = p.d;
  float* xt = smem;                      // (RT, XS) rows of x
  float* xn = xt + RT * XS;              // (RT, D) x^2 @ invls2
  float* red = xn + align4(RT * D);      // (warps, 32) folded sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = warp % D, grp = warp / D;
  const int row0 = blockIdx.x * RT;
  const int rows = min(RT, n - row0);

  tile_load_stages<DP, RT>(x, xt, 1, 0, row0, rows, p.din);
  __syncthreads();
  for (int i = threadIdx.x; i < RT * D; i += blockDim.x) {
    const int r = i / D, e = i % D;
    float v = 0.f;
    for (int k = 0; k < p.din; ++k) {
      const float xv = xt[r * XS + k];
      v = fmaf(xv * xv, p.invls2[k * D + e], v);
    }
    xn[i] = v;
  }
  __syncthreads();
  if (rows == RT)
    wide_fwd_tile<DP, RT, DENSE>(p, wts, xt, xn, RT, d, grp, groups, lane,
                                 red + warp * 32);
  else
    wide_fwd_tile<DP, RT, DENSE>(p, wts, xt, xn, rows, d, grp, groups, lane,
                                 red + warp * 32);
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, e = i % D;
    float v = 0.f;
    if constexpr (DENSE) {  // every warp's columns feed output e
      for (int w = 0; w < warps; ++w) v += red[w * 32 + r * DP + e];
    } else {      // only dim e's warps, in group order
      for (int g = 0; g < groups; ++g) v += red[(g * D + e) * 32 + r];
    }
    out[(size_t)row0 * D + i] = v;
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Shared memory (floats): xt, gt (RT, tile_stride(DP)) the tile's rows of x
// and g | xn (RT) dim d's x^2 . invls2 | red (warps, 32) the folded dx and dxn
// shares | dim d's accumulators, per column u of its Sp + Mp: db (Din, cols),
// dwblk (D, cols), dt (cols).
__host__ __device__ constexpr int wide_bwd_smem_floats(int dp, int rt, int din,
                                                       int d, int cols, int warps) {
  return 2 * rt * tile_stride(dp) + align4(rt) + 32 * warps + (din + d + 1) * cols;
}
// Floats of one (row block, dim) slab: db (Din, cols) | dwblk (cols, D) |
// dphase, dzn (cols) | dinvls2 (Din) of dim d.
__host__ __device__ constexpr int wide_slab_floats(int din, int d, int cols) {
  return (din + d + 1) * cols + din;
}

// One column's VJP over the first `rows` rows of a tile (RFF: the cos
// activation, its phase in `off`; else the Gram activation, zn in `off`,
// whose dt also feeds the dxn shares dxa[RT * DP + r]): adds the rows'
// shares of db (sdb), dwblk (sdw) and dt (sdt), and the dx shares
// dxa[r * DP + k].
template <int DP, int RT, int V, bool RFF>
__device__ __forceinline__ void wide_vjp_rows(const float* xt, const float* gt,
                                              const float* xn, int rows,
                                              const float (&bk)[DP],
                                              const float (&wv)[DP], float off,
                                              float (&sdb)[DP], float (&sdw)[DP],
                                              float& sdt, float (&dxa)[V]) {
  constexpr int XS = tile_stride(DP);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r < rows) {
      float x[DP], g[DP];
      tile_row<DP>(xt + r * XS, x);
      tile_row<DP>(gt + r * XS, g);
      float t = 0.f, dact = 0.f;
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        t = fmaf(x[k], bk[k], t);
        dact = fmaf(g[k], wv[k], dact);
      }
      float a, dt;
      if constexpr (RFF) {
        float sn;
        sincosf(t + off, &sn, &a);
        dt = -sn * dact;
      } else {
        a = expf(t - 0.5f * (xn[r] + off));
        dt = a * dact;
        dxa[RT * DP + r] += dt;
      }
      sdt += dt;
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        sdb[k] = fmaf(x[k], dt, sdb[k]);
        dxa[r * DP + k] = fmaf(dt, bk[k], dxa[r * DP + k]);
        sdw[k] = fmaf(a, g[k], sdw[k]);
      }
    }
  }
}

// VJP of f over the first `rows` rows of a tile, this warp's units of dim d
// (warp, warp + warps, ...). Adds its columns' cotangent shares to the
// block's accumulators `acc` (laid out as wide_bwd_smem_floats lists them)
// and writes its dx shares [r * DP + k] and dxn shares [RT * DP + r] (the
// sum of dte over its Gram columns), each summed over its lanes, to sums_w.
template <int DP, int RT>
__device__ __forceinline__ void wide_vjp_tile(const WideParams& p,
                                              const float* __restrict__ wblk,
                                              const float* xt, const float* gt,
                                              const float* xn, int rows, int d,
                                              int warp, int warps, int lane,
                                              float* acc, float* sums_w) {
  constexpr int NV = RT * (DP + 1);
  constexpr int V = fold_width(NV);
  static_assert(NV <= 32, "a tile's dx and dxn shares must fit one fold");
  const int din = p.din, D = p.d, cols = p.sp + p.mp;
  const int su = p.sp >> 5, units = su + (p.mp >> 5);
  float* acc_db = acc;                  // (Din, cols)
  float* acc_dw = acc_db + din * cols;  // (D, cols)
  float* acc_dt = acc_dw + D * cols;    // (cols)

  float dxa[V];
#pragma unroll
  for (int i = 0; i < V; ++i) dxa[i] = 0.f;

  for (int unit = warp; unit < units; unit += warps) {
    const int c = wide_column(p, d, unit, lane);
    const int u = (unit << 5) + lane;   // column within dim d
    float bk[DP], wv[DP], sdb[DP], sdw[DP];
    wide_load_column<DP>(p.b, din, p.w, c, bk);
    wide_load_row<DP>(wblk, D, c, wv);
#pragma unroll
    for (int k = 0; k < DP; ++k) { sdb[k] = 0.f; sdw[k] = 0.f; }
    float sdt = 0.f;
    if (unit < su)  // warp-uniform
      wide_vjp_rows<DP, RT, V, true>(xt, gt, xn, rows, bk, wv, p.phase[c], sdb,
                                     sdw, sdt, dxa);
    else
      wide_vjp_rows<DP, RT, V, false>(xt, gt, xn, rows, bk, wv,
                                      p.zn[c - D * p.sp], sdb, sdw, sdt, dxa);
#pragma unroll
    for (int k = 0; k < DP; ++k) {
      if (k < din) acc_db[k * cols + u] += sdb[k];
      if (k < D) acc_dw[k * cols + u] += sdw[k];
    }
    acc_dt[u] += sdt;
  }

  const float total = LaneFold<V, 16>::run(dxa, lane);
  constexpr int SHIFT = fold_shift(NV);
  if ((lane & ((1 << SHIFT) - 1)) == 0) sums_w[lane >> SHIFT] = total;
}

// Block (rb, d): rows [rb * rows_per_block, ...) of dim d. Writes dim d's dx
// share dx_part (D, N, Din) and its slab part (row blocks, D, slab).
template <int DP, int RT, int MAXT>
static __global__ void __launch_bounds__(MAXT)
wide_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                WideParams p, const float* __restrict__ wblk,
                float* __restrict__ dx_part, float* __restrict__ part, int n,
                int rows_per_block) {
  extern __shared__ __align__(16) float smem[];
  constexpr int XS = tile_stride(DP);
  const int din = p.din, D = p.d, cols = p.sp + p.mp;
  const int d = blockIdx.y;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xt = smem;                     // (RT, XS) rows of x
  float* gt = xt + RT * XS;             // (RT, XS) rows of g
  float* xn = gt + RT * XS;             // (RT) x^2 . invls2[:, d]
  float* red = xn + align4(RT);         // (warps, 32) folded shares
  float* acc = red + 32 * warps;        // dim d's column accumulators
  for (int i = threadIdx.x; i < (din + D + 1) * cols; i += blockDim.x) acc[i] = 0.f;
  float dinv = 0.f;                     // thread k < Din: dinvls2[k, d]

  const int first = blockIdx.x * rows_per_block;
  const int tile_end = min(n, first + rows_per_block);
  for (int row0 = first; row0 < tile_end; row0 += RT) {
    const int rows = min(RT, tile_end - row0);
    for (int i = threadIdx.x; i < RT * XS; i += blockDim.x) {
      const int r = i / XS, k = i % XS;
      xt[i] = (r < rows && k < din) ? x[(size_t)(row0 + r) * din + k] : 0.f;
      gt[i] = (r < rows && k < D) ? g[(size_t)(row0 + r) * D + k] : 0.f;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < RT; r += blockDim.x) {
      float v = 0.f;
      for (int k = 0; k < din; ++k) {
        const float xv = xt[r * XS + k];
        v = fmaf(xv * xv, p.invls2[k * D + d], v);
      }
      xn[r] = v;
    }
    __syncthreads();
    if (rows == RT)
      wide_vjp_tile<DP, RT>(p, wblk, xt, gt, xn, RT, d, warp, warps, lane, acc,
                            red + warp * 32);
    else
      wide_vjp_tile<DP, RT>(p, wblk, xt, gt, xn, rows, d, warp, warps, lane, acc,
                            red + warp * 32);
    __syncthreads();
    // dim d's dx share: dt @ B^T over its columns plus the xn chain
    // 2 x * dxn * invls2[:, d], dxn = -1/2 * (row sum of dte); both sums over
    // the warps in warp order
    for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
      const int r = i / din, k = i % din;
      float v = 0.f, s = 0.f;
      for (int w = 0; w < warps; ++w) {
        v += red[w * 32 + r * DP + k];
        s += red[w * 32 + RT * DP + r];
      }
      const float xv = xt[r * XS + k];
      dx_part[((size_t)d * n + row0 + r) * din + k] =
          v + 2.f * xv * (-0.5f * s) * p.invls2[k * D + d];
    }
    if (threadIdx.x < din) {  // dinvls2[k, d] += (x^2)[:, k] . dxn
      const int k = threadIdx.x;
      for (int r = 0; r < rows; ++r) {
        float s = 0.f;
        for (int w = 0; w < warps; ++w) s += red[w * 32 + RT * DP + r];
        const float xv = xt[r * XS + k];
        dinv = fmaf(xv * xv, -0.5f * s, dinv);
      }
    }
    __syncthreads();  // the next tile overwrites xt, gt, xn and red
  }

  const float* acc_dw = acc + din * cols;
  const float* acc_dt = acc_dw + D * cols;
  float* slab = part + ((size_t)blockIdx.x * D + d) * wide_slab_floats(din, D, cols);
  for (int i = threadIdx.x; i < din * cols; i += blockDim.x) slab[i] = acc[i];
  slab += din * cols;
  for (int i = threadIdx.x; i < cols * D; i += blockDim.x)
    slab[i] = acc_dw[(i % D) * cols + i / D];
  slab += cols * D;
  for (int i = threadIdx.x; i < cols; i += blockDim.x)
    slab[i] = (i < p.sp) ? acc_dt[i] : -0.5f * acc_dt[i];  // dphase | dzn
  slab += cols;
  if (threadIdx.x < din) slab[threadIdx.x] = dinv;
}

// The packed cotangents from the slabs, out = [db (Din, W) | dwblk (W, D) |
// dphase (D*Sp) | dzn (D*Mp) | dinvls2 (Din, D)]: each entry the sum over
// row blocks, in block order, of its (dim, column) slab entry. Then dx
// (N, Din): the dims' shares added in dim order.
static __global__ void wide_reduce_kernel(const float* __restrict__ part,
                                          const float* __restrict__ dx_part,
                                          float* __restrict__ out,
                                          float* __restrict__ dx, int row_blocks,
                                          int n, int din, int D, int sp, int mp) {
  const int cols = sp + mp, W = D * cols, ds = D * sp;
  const int slab = wide_slab_floats(din, D, cols);
  const int n_out = W * (din + D + 1) + din * D;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n_out) {
    const int i = (int)j;
    int dd, src;  // the dim whose slabs hold entry i, and its offset there
    if (i >= (din + D + 1) * W) {  // dinvls2[k, e]: dim e's slab
      const int q = i - (din + D + 1) * W;
      dd = q % D;
      src = (din + D + 1) * cols + q / D;
    } else {
      int c, base, stride;  // packed column, its entry at base + u * stride
      if (i < din * W) {                  // db[k, c]
        c = i % W;
        base = (i / W) * cols;
        stride = 1;
      } else if (i < (din + D) * W) {     // dwblk[c, e]
        const int q = i - din * W;
        c = q / D;
        base = din * cols + q % D;
        stride = D;
      } else {                            // dphase | dzn
        c = i - (din + D) * W;
        base = (din + D) * cols;
        stride = 1;
      }
      dd = c < ds ? c / sp : (c - ds) / mp;
      const int u = c < ds ? c % sp : sp + (c - ds) % mp;
      src = base + u * stride;
    }
    float v = 0.f;
    for (int rb = 0; rb < row_blocks; ++rb)
      v += part[((size_t)rb * D + dd) * slab + src];
    out[i] = v;
  } else if (j < n_out + (long long)n * din) {
    const size_t i = (size_t)(j - n_out);
    float v = 0.f;
    for (int dd = 0; dd < D; ++dd) v += dx_part[(size_t)dd * n * din + i];
    dx[i] = v;
  }
}

// ---------------------------------------------------------------------------
// Entry points
// ---------------------------------------------------------------------------

// The instantiated variants (DP, RT, MAXT), one per range of max(Din, D): DP
// bounds the loops over Din and D, RT is the tile's rows (RT * DP sums of
// the dense forward, RT * (DP + 1) dx and dxn shares of the backward fit
// one fold), MAXT bounds the block and with it the registers per thread
// (65536 / MAXT). Every one builds at 0 B of spill (ptxas).
#define WIDE_FWD_VARIANTS(X) X(4, 8, 640) X(5, 6, 640) X(8, 4, 640) X(16, 2, 512)
#define WIDE_BWD_VARIANTS(X) X(4, 6, 640) X(5, 5, 640) X(8, 3, 512) X(16, 1, 512)

static inline bool wide_dims_ok(int din, int d, int sp, int mp, int dp) {
  return din >= 1 && d >= 1 && din <= dp && d <= dp && sp >= 32 && mp >= 32 &&
         sp % 32 == 0 && mp % 32 == 0;
}

template <int DP, int RT, int MAXT, bool DENSE>
static cudaError_t wide_fwd_launch(const float* x, const WideParams& p,
                                   const float* wts, float* out, int n, int groups,
                                   int threads, size_t smem, int* occupancy,
                                   cudaStream_t stream) {
  cudaError_t e = prepare_kernel(wide_fwd_kernel<DP, RT, MAXT, DENSE>, threads,
                                 smem, occupancy);
  if (e != cudaSuccess || occupancy) return e;
  wide_fwd_kernel<DP, RT, MAXT, DENSE><<<(n + RT - 1) / RT, threads, smem, stream>>>(
      x, p, wts, out, n, groups);
  return cudaGetLastError();
}

// The forward kernel on `stream`; with `occupancy` non-null nothing is
// launched and the kernel's occupancy_report at this geometry is written
// there instead.
static int wide_fwd_run(const float* x, const float* b, const float* phase,
                        const float* zn, const float* invls2, const float* wts,
                        float* out, int n, int din, int d, int sp, int mp, int dense,
                        int dp, int rt, int groups, int maxt, int* occupancy,
                        void* stream) {
  if (!wide_dims_ok(din, d, sp, mp, dp) || n < 1 || groups < 1 ||
      32 * d * groups > maxt)
    return (int)cudaErrorInvalidValue;
  const WideParams p = make_wide(b, phase, zn, invls2, din, d, sp, mp);
  const int threads = 32 * d * groups;
  const size_t smem = sizeof(float) * (size_t)wide_fwd_smem_floats(dp, rt, d, d * groups);
  cudaError_t e = cudaErrorInvalidValue;
#define X(DP_, RT_, MAXT_)                                                      \
  if (dp == DP_ && rt == RT_ && maxt == MAXT_)                                  \
    e = dense ? wide_fwd_launch<DP_, RT_, MAXT_, true>(x, p, wts, out, n, groups, \
                                                       threads, smem, occupancy,  \
                                                       (cudaStream_t)stream)      \
              : wide_fwd_launch<DP_, RT_, MAXT_, false>(x, p, wts, out, n,        \
                                                        groups, threads, smem,    \
                                                        occupancy,                \
                                                        (cudaStream_t)stream);
  WIDE_FWD_VARIANTS(X)
#undef X
  return (int)e;
}

extern "C" int gpode_wide_fwd(const float* x, const float* b, const float* phase,
                              const float* zn, const float* invls2,
                              const float* wts, float* out, int n, int din, int d,
                              int sp, int mp, int dense, int dp, int rt, int groups,
                              int maxt, void* stream) {
  return wide_fwd_run(x, b, phase, zn, invls2, wts, out, n, din, d, sp, mp, dense,
                      dp, rt, groups, maxt, nullptr, stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the forward kernel at this geometry; launches nothing.
extern "C" int gpode_wide_fwd_occupancy(int din, int d, int sp, int mp, int dense,
                                        int dp, int rt, int groups, int maxt,
                                        int* out) {
  return wide_fwd_run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      rt, din, d, sp, mp, dense, dp, rt, groups, maxt, out, nullptr);
}

// The backward kernel and its fixed-order reduction on `stream`; with
// `occupancy` non-null nothing is launched and the kernel's occupancy_report
// at this geometry is written there instead. dx_part: (D, N, Din) scratch;
// part: (row blocks, D, slab) scratch; out: the packed cotangents.
static int wide_bwd_run(const float* x, const float* g, const float* b,
                        const float* phase, const float* zn, const float* invls2,
                        const float* wblk, float* dx, float* dx_part, float* part,
                        float* out, int n, int din, int d, int sp, int mp,
                        int rows_per_block, int dp, int rt, int warps, int maxt,
                        int* occupancy, void* stream) {
  if (!wide_dims_ok(din, d, sp, mp, dp) || n < 1 || warps < 1 || 32 * warps > maxt ||
      rt < 1 || rows_per_block < rt || rows_per_block % rt != 0)
    return (int)cudaErrorInvalidValue;
  const WideParams p = make_wide(b, phase, zn, invls2, din, d, sp, mp);
  const int threads = 32 * warps, cols = sp + mp;
  const int row_blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem =
      sizeof(float) * (size_t)wide_bwd_smem_floats(dp, rt, din, d, cols, warps);
  cudaError_t e = cudaErrorInvalidValue;
#define X(DP_, RT_, MAXT_)                                                        \
  if (dp == DP_ && rt == RT_ && maxt == MAXT_) {                                  \
    e = prepare_kernel(wide_bwd_kernel<DP_, RT_, MAXT_>, threads, smem, occupancy); \
    if (e == cudaSuccess && !occupancy) {                                         \
      wide_bwd_kernel<DP_, RT_, MAXT_>                                            \
          <<<dim3(row_blocks, d), threads, smem, (cudaStream_t)stream>>>(         \
              x, g, p, wblk, dx_part, part, n, rows_per_block);                   \
      e = cudaGetLastError();                                                     \
    }                                                                             \
  }
  WIDE_BWD_VARIANTS(X)
#undef X
  if (e != cudaSuccess || occupancy) return (int)e;
  const long long total = (long long)p.w * (din + d + 1) + din * d + (long long)n * din;
  wide_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      part, dx_part, out, dx, row_blocks, n, din, d, sp, mp);
  return (int)cudaGetLastError();
}

extern "C" int gpode_wide_bwd(const float* x, const float* g, const float* b,
                              const float* phase, const float* zn,
                              const float* invls2, const float* wblk, float* dx,
                              float* dx_part, float* part, float* out, int n,
                              int din, int d, int sp, int mp, int rows_per_block,
                              int dp, int rt, int warps, int maxt, void* stream) {
  return wide_bwd_run(x, g, b, phase, zn, invls2, wblk, dx, dx_part, part, out, n,
                      din, d, sp, mp, rows_per_block, dp, rt, warps, maxt, nullptr,
                      stream);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers,
// local bytes} of the backward kernel at this geometry; launches nothing.
extern "C" int gpode_wide_bwd_occupancy(int din, int d, int sp, int mp, int dp,
                                        int rt, int warps, int maxt, int* out) {
  return wide_bwd_run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, nullptr, nullptr, rt, din, d, sp, mp, rt, dp,
                      rt, warps, maxt, out, nullptr);
}
