// Shared device code for the GPODE Hopper kernels (fused_rhs.cu,
// fused_dopri5.cu, fused_rk4.cu, fused_rhs_wide.cu): the sampled-vector-field
// rhs for one (row, output dim), its VJP in two forms, and the fixed-order
// reduction of per-block parameter cotangents.
//
// Replaces the tile functions of gpode_tpu/ops/pallas_kernels.py:
// `_rhs_tile` (:200) and `_rhs_vjp_tile` (:274, the VPU loop form).
//
// What bounds this work on an H100: arithmetic. One rhs evaluation of one
// row costs D*(S*(2*Din+3) + M*(3*Din+3)) flops and D*(S+M) cos/exp against
// a few hundred bytes of state; the parameters (Omega, phase, w, Z, nu:
// ~40 KB at S=256, M=100, D=5) are shared by every row and stay in L1/L2.
// The accurate sincosf/expf cost tens of instructions each, so what decides
// the time is how many of them are in flight: independent chains per thread
// and resident warps per SM.
//
// Row form (`rhs_row_dim`, `rhs_vjp_row_dim`; the forward kernels and the
// fused_rhs backward): one warp owns one (row, output dim d); its 32 lanes
// split the S random features and the M inducing points, then combine with
// xor-shuffle sums. The VJP keeps per-warp accumulators in shared memory and
// updates them once per row.
//
// Tile form (`rhs_vjp_tile`; the two segment backward kernels, which are six
// and 4 * substeps VJPs of every row): a lane owns a column (a random feature
// or an inducing point of one dim) for the whole kernel. It loads the
// column's parameters once per tile of RT rows, runs the RT rows as RT
// independent sincosf/expf chains with the column's cotangent sums in
// registers, and touches the block's shared-memory accumulators once per
// column and tile instead of once per row. The dx shares of a tile stay in
// registers and are summed over the lanes by one transposing fold (31
// shuffles for up to 32 values, not 5 per value). All loops over Din have
// compile-time bounds (template DP >= Din; DP = 5 is exact for the MoCap
// models), 1/lengthscale and the lengthscale shares live in shared memory,
// and dvar follows from dw and dnu, so the kernel holds 84-96 registers
// with no spill and two 10-warp blocks are resident per SM.
//
// Parameter cotangents: the TPU kernel summed them across its sequential grid
// with `+=` into one output block. Hopper blocks run concurrently, so a block
// keeps its sums in shared memory - every address has exactly one owning lane
// - writes them as a per-block slab, and `sum_slabs_kernel` adds the slabs in
// block order. No float atomics: results are bit-reproducible run to run.
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

// ---------------------------------------------------------------------------
// The row-tile VJP of the segment backward kernels (fused_dopri5.cu,
// fused_rk4.cu).
//
// A block is G groups of D warps; warp (grp, d) owns, for the whole kernel,
// every G-th 32-column unit of dim d's ceil(S/32) feature units and
// ceil(M/32) inducing-point units, one column per lane (units interleave, so
// the warps of a dim carry equal shares of sincosf and expf work). One call
// of `rhs_vjp_tile` handles one stage of a tile of RT rows. Rows past the end
// are skipped by a warp-uniform test, columns past S or M by zero weights:
// nothing is padded with values that reach a stored sum.
// ---------------------------------------------------------------------------

// Floats rounded up to whole float4s (regions of shared memory stay 16-byte
// aligned).
__host__ __device__ constexpr int align4(int floats) { return (floats + 3) & ~3; }

// Sum N register values over the 32 lanes: at each step a lane keeps the half
// of the values its lane bit selects and adds its partner's share of that
// half. Afterwards every lane holds the total of value `lane >> (5 - log2 N)`;
// the order of the additions is fixed by the lane numbers.
template <int N, int OFF>
struct LaneFold {
  static __device__ __forceinline__ float run(float* v, int lane) {
    if constexpr (N > 1) {
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if constexpr (OFF > 1) return LaneFold<N / 2, OFF / 2>::run(v, lane);
      return v[0];
    } else {
      float t = v[0];
#pragma unroll
      for (int off = OFF; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
      return t;
    }
  }
};

// Floats between the rows of a tile in shared memory: a row loads as 16-byte
// vectors.
__host__ __device__ constexpr int tile_stride(int dp) { return align4(dp); }

// The first DP floats of one row of a tile into registers.
template <int DP>
__device__ __forceinline__ void tile_row(const float* row, float (&x)[DP]) {
  const float4* row4 = reinterpret_cast<const float4*>(row);
  float xx[tile_stride(DP)];
#pragma unroll
  for (int q = 0; q < tile_stride(DP) / 4; ++q) {
    const float4 v = row4[q];
    xx[4 * q] = v.x; xx[4 * q + 1] = v.y; xx[4 * q + 2] = v.z; xx[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < DP; ++k) x[k] = xx[k];
}

// VJP of f_d over the first `rows` rows of a tile. All pointers but those in
// `p` are shared memory: xt (RT, tile_stride(DP)), zero beyond Din;
// g[r * Din] the cotangent of f_d at row r; il_s dim d's 1/lengthscale (DP
// floats, zero beyond Din). Adds the parameter cotangents of this warp's
// columns to `acc` (dim d's block accumulators, laid out as VjpAcc) and the
// lanes' lengthscale shares to dls_w[k * 32 + lane] (this warp's DP * 32
// floats), and writes the warp's dx shares, summed over its lanes, to
// dx_out[r * DP + k] (32 floats). The variance cotangent needs no sum of its
// own: it follows from dw and dnu (tile_write_partials).
template <int DP, int RT>
__device__ __forceinline__ void rhs_vjp_tile(const RhsParams& p, const float* xt,
                                             const float* g, int rows, int d,
                                             int grp, int groups, int lane,
                                             float* acc, const float* il_s,
                                             float* dls_w, float* dx_out) {
  constexpr int XS = tile_stride(DP);
  constexpr int V = RT * DP <= 8 ? 8 : RT * DP <= 16 ? 16 : 32;  // the fold's width
  static_assert(RT * DP <= 32, "a tile's dx shares must fit one fold");
  const int din = p.din, S = p.s, M = p.m;
  float* acc_domega = acc;
  float* acc_dphase = acc_domega + din * S;
  float* acc_dw = acc_dphase + S;
  float* acc_dnu = acc_dw + S;
  float* acc_dz = acc_dnu + M;
  const float* omd = p.omega + (size_t)d * din * S;
  const float* phd = p.phase + (size_t)d * S;
  const float* wd = p.w + (size_t)d * S;
  const float* nud = p.nu + (size_t)d * M;
  const float vd = p.var[d];  // formed per call: they hold no register between
  const float scale = sqrtf(2.f * vd / (float)S);

  float dxa[RT * DP];
#pragma unroll
  for (int i = 0; i < RT * DP; ++i) dxa[i] = 0.f;

  const int feat_units = (S + 31) >> 5;
  const int units = feat_units + ((M + 31) >> 5);
  for (int unit = grp; unit < units; unit += groups) {
    if (unit < feat_units) {  // warp-uniform
      const int s = (unit << 5) + lane;
      const bool live = s < S;
      const int sc = live ? s : S - 1;
      float om[DP], cs[DP];
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        om[k] = (k < din) ? omd[(size_t)k * S + sc] : 0.f;
        cs[k] = 0.f;
      }
      const float ph = phd[sc];
      const float wv = live ? wd[sc] : 0.f;  // a dead lane's dxo and dx are 0
      float cph = 0.f, cw = 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < rows) {
          float x[DP];
          tile_row<DP>(xt + r * XS, x);
          const float gr = g[r * p.din];
          float xo = 0.f;
#pragma unroll
          for (int k = 0; k < DP; ++k) xo = fmaf(x[k], om[k], xo);
          float sn, c;
          sincosf(xo + ph, &sn, &c);
          const float dphi = gr * wv;
          const float dxo = -sn * scale * dphi;
          cw = fmaf(c * scale, gr, cw);
          cph += dxo;
#pragma unroll
          for (int k = 0; k < DP; ++k) {
            cs[k] = fmaf(x[k], dxo, cs[k]);
            dxa[r * DP + k] = fmaf(dxo, om[k], dxa[r * DP + k]);
          }
        }
      }
      if (live) {
        acc_dw[s] += cw;
        acc_dphase[s] += cph;
#pragma unroll
        for (int k = 0; k < DP; ++k)
          if (k < din) acc_domega[k * S + s] += cs[k];
      }
    } else {
      const int j = ((unit - feat_units) << 5) + lane;
      const bool live = j < M;
      const int jc = live ? j : M - 1;
      float zj[DP], cz[DP], cl[DP];
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        zj[k] = (k < din) ? p.z[(size_t)jc * din + k] : 0.f;
        cz[k] = 0.f;
        cl[k] = 0.f;
      }
      const float nuv = live ? nud[jc] : 0.f;  // a dead lane's dsq is 0
      float cnu = 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < rows) {
          float x[DP], u[DP];
          tile_row<DP>(xt + r * XS, x);
          const float gr = g[r * p.din];
          float sq = 0.f;
#pragma unroll
          for (int k = 0; k < DP; ++k) {  // u = (x - z) / lengthscale
            u[k] = (x[k] - zj[k]) * il_s[k];
            sq = fmaf(u[k], u[k], sq);
          }
          const float gram = vd * expf(-0.5f * sq);
          const float dgram = gr * nuv;
          cnu = fmaf(gram, gr, cnu);
          const float dsq = -0.5f * gram * dgram;
#pragma unroll
          for (int k = 0; k < DP; ++k) {
            const float t = dsq * u[k];  // dx = 2 t / ls, dz = -dx, dls = -2 t u / ls
            dxa[r * DP + k] = fmaf(2.f * il_s[k], t, dxa[r * DP + k]);
            cz[k] += t;
            cl[k] = fmaf(t, u[k], cl[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < DP; ++k)
        dls_w[k * 32 + lane] += -2.f * il_s[k] * cl[k];  // 0 in a dead lane
      if (live) {
        acc_dnu[j] += cnu;
#pragma unroll
        for (int k = 0; k < DP; ++k)
          if (k < din) acc_dz[j * din + k] += -2.f * il_s[k] * cz[k];
      }
    }
  }

  float fold[V];
#pragma unroll
  for (int i = 0; i < V; ++i) fold[i] = (i < RT * DP) ? dxa[i] : 0.f;
  const float total = LaneFold<V, 16>::run(fold, lane);
  constexpr int SHIFT = (V == 32) ? 0 : (V == 16) ? 1 : 2;
  if ((lane & ((1 << SHIFT) - 1)) == 0) dx_out[lane >> SHIFT] = total;
}

// Shared memory of a segment backward block. The tile's regions come first,
// at compile-time offsets (so their addresses hold no registers): xt (STAGES,
// RT, tile_stride(DP)) stage inputs, PLANES planes of tile_plane<DP, RT>()
// floats, each indexed [r * Din + k], and il (DP, DP) 1/lengthscale. Then,
// sized at run time: the accumulators (D * vjp_acc_floats), dls (warps, DP,
// 32) lengthscale shares, dxw (warps, 32) dx shares.
template <int DP, int RT>
__host__ __device__ constexpr int tile_plane() { return align4(RT * DP); }

template <int DP, int RT, int STAGES, int PLANES>
struct TileSmem {
  static constexpr int xt = 0;
  static constexpr int planes = STAGES * RT * tile_stride(DP);
  static constexpr int il = planes + PLANES * tile_plane<DP, RT>();
  static constexpr int acc = il + DP * DP;
};

// Floats of a block's shared memory: TileSmem's fixed part and the rest.
__host__ __device__ constexpr int tile_smem_floats(int dp, int rt, int stages,
                                                   int planes, int acc_floats,
                                                   int warps) {
  return stages * rt * tile_stride(dp) + planes * align4(rt * dp) + dp * dp +
         align4(acc_floats) + 32 * dp * warps + 32 * warps;
}

// Stage 1/lengthscale (D, Din) as il_s (D, DP) in shared memory, zero padded
// (D == Din <= DP in the segment kernels).
template <int DP>
__device__ __forceinline__ void tile_load_inv_ls(const RhsParams& p, float* il_s) {
  for (int i = threadIdx.x; i < p.d * DP; i += blockDim.x)
    il_s[i] = (i % DP < p.din) ? p.inv_ls[(i / DP) * p.din + i % DP] : 0.f;
}

// Load the stage inputs of one tile: `stages` planes of xs (stage, N, Din)
// from row0 into xt (stage, RT, tile_stride(DP)), zero beyond Din and `rows`.
template <int DP, int RT>
__device__ __forceinline__ void tile_load_stages(const float* __restrict__ xs,
                                                 float* xt, int stages,
                                                 size_t plane, int row0, int rows,
                                                 int din) {
  constexpr int XS = tile_stride(DP);
  for (int i = threadIdx.x; i < stages * RT * XS; i += blockDim.x) {
    const int k = i % XS, r = (i / XS) % RT, st = i / (RT * XS);
    xt[i] = (r < rows && k < din)
                ? xs[(size_t)st * plane + (size_t)(row0 + r) * din + k]
                : 0.f;
  }
}

// v = sum over the block's warps, in warp order, of their dx shares of
// (row r, input k): the cotangent of one stage input.
template <int DP>
__device__ __forceinline__ float tile_dx_sum(const float* dxw, int warps, int r,
                                             int k) {
  float v = 0.f;
  for (int w = 0; w < warps; ++w) v += dxw[w * 32 + r * DP + k];
  return v;
}

// Write the block's slabs: part_main (blocks, D, main_slab_floats), part_dz
// (blocks, D, M*Din). `acc` holds the D per-dim accumulators, `dls` the
// (warps, DP, 32) lengthscale shares, added in group order, then over lanes.
// dvar_d = sum_s w_s dw_s / (2 var_d) + sum_j nu_j dnu_j / var_d, the chain
// rule through scale = sqrt(2 var / S) and gram = var * exp(.).
template <int DP>
__device__ __forceinline__ void tile_write_partials(const RhsParams& p,
                                                    const float* acc,
                                                    const float* dls, int groups,
                                                    float* part_main,
                                                    float* part_dz) {
  __syncthreads();  // the accumulators are complete
  const int din = p.din, D = p.d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qa = vjp_acc_floats(din, p.m, p.s);
  const int qm = main_slab_floats(din, p.m, p.s);
  const int n_dense = din * p.s + 2 * p.s + p.m;  // domega|dphase|dw|dnu
  const int mz = p.m * din;
  float* pm = part_main + (size_t)blockIdx.x * D * qm;
  float* pz = part_dz + (size_t)blockIdx.x * D * mz;
  for (int i = threadIdx.x; i < D * n_dense; i += blockDim.x) {
    const int dd = i / n_dense, c = i % n_dense;
    pm[dd * qm + c] = acc[dd * qa + c];
  }
  for (int i = threadIdx.x; i < D * mz; i += blockDim.x) {
    const int dd = i / mz, c = i % mz;
    pz[i] = acc[dd * qa + n_dense + c];
  }
  if (warp < D) {  // warp dd finishes dim dd's lengthscale and variance slots
    const int dd = warp;
    for (int k = 0; k < din; ++k) {
      float v = 0.f;
      for (int gq = 0; gq < groups; ++gq)
        v += dls[((gq * D + dd) * DP + k) * 32 + lane];
      v = warp_sum(v);
      if (lane == 0) pm[dd * qm + n_dense + k] = v;
    }
    const float* acc_dw = acc + dd * qa + din * p.s + p.s;
    const float* acc_dnu = acc_dw + p.s;
    float rff = 0.f, gram = 0.f;
    for (int s = lane; s < p.s; s += 32)
      rff = fmaf(p.w[(size_t)dd * p.s + s], acc_dw[s], rff);
    for (int j = lane; j < p.m; j += 32)
      gram = fmaf(p.nu[(size_t)dd * p.m + j], acc_dnu[j], gram);
    rff = warp_sum(rff);
    gram = warp_sum(gram);
    const float vd = p.var[dd];
    if (lane == 0) pm[dd * qm + n_dense + din] = rff / (2.f * vd) + gram / vd;
  }
}

// Registers, local bytes and resident blocks per SM of `kernel` launched with
// `threads` threads and `smem` bytes of dynamic shared memory:
// out = {blocks per SM, threads, smem bytes, registers, local bytes}.
template <class Kernel>
static cudaError_t occupancy_report(Kernel kernel, int threads, size_t smem,
                                    int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  out[0] = resident;
  out[1] = threads;
  out[2] = (int)smem;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return cudaSuccess;
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
