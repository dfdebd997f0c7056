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
// Three entry points:
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
// at S=256, M=100, D=Din=5) are shared by all rows and stay in L1/L2.
//
// Design. The TPU kernel holds a (256, W) tile of t/act in fast memory; here
// 7.5 KB per row would not fit, so the tile never exists: a warp takes a
// group of 32 neighbouring columns (one per lane; groups never straddle a
// dim's block because Sp and Mp are multiples of 32) for WIDE_R rows at a
// time, forms t and act in registers, and contracts them at once - into
// per-lane f accumulators (forward) or into the cotangents (backward). One
// load of a B column and a Wblk row serves WIDE_R rows. The warps of a block
// split the W/32 groups; their f / dx / dxn shares meet in shared memory and
// are added in warp order. All products are FFMA in float32: the exponent is
// a difference of large terms, which TF32 would not survive.
//
// Parameter cotangents: the TPU kernel summed them over its sequential grid
// with `+=`. Here a block keeps one accumulator per (operand row, column) in
// shared memory - a column belongs to one fixed lane of one fixed warp, so no
// two threads share an address - over all its rows, writes one slab
// [db | dwblk | dphase | dzn | dinvls2], and `sum_slabs_kernel` adds the
// slabs in block order. No float atomics: reruns are bit-identical.
//
// Padded columns contribute exactly 0: padded rff columns have B = 0,
// phase = 0 and a zero Wblk row; padded Gram columns have zn = 1e30, so
// exp(-5e29) == 0. Rows past N enter as x = 0, g = 0 and are never stored.
// Accurate cosf/sincosf/expf (no --use_fast_math).

#include "rhs_tile.cuh"

#define WIDE_R 4         // rows per warp pass
#define WIDE_THREADS 256  // most threads a block may have

struct WideParams {
  const float* b;       // (Din, W)
  const float* phase;   // (D*Sp)
  const float* zn;      // (D*Mp)
  const float* invls2;  // (Din, D)
  int din, d, sp, mp, w;
};

// t[r] = sum_k xs[r, k] * B[k, c] for the WIDE_R rows in shared memory.
__device__ __forceinline__ void wide_t(const WideParams& p, const float* xs, int c,
                                       float (&t)[WIDE_R]) {
#pragma unroll
  for (int r = 0; r < WIDE_R; ++r) t[r] = 0.f;
  for (int k = 0; k < p.din; ++k) {
    const float bk = p.b[(size_t)k * p.w + c];
#pragma unroll
    for (int r = 0; r < WIDE_R; ++r) t[r] = fmaf(xs[r * p.din + k], bk, t[r]);
  }
}

// Load WIDE_R rows of `src` (n, width) from row0 into shared memory, zeros
// past the last row.
__device__ __forceinline__ void wide_load_rows(const float* __restrict__ src,
                                               float* dst, int row0, int rows,
                                               int width) {
  for (int i = threadIdx.x; i < WIDE_R * width; i += blockDim.x)
    dst[i] = (i / width < rows) ? src[(size_t)row0 * width + i] : 0.f;
}

// xn[r, e] = sum_k xs[r, k]^2 * invls2[k, e].
__device__ __forceinline__ void wide_xn(const WideParams& p, const float* xs,
                                        float* xn) {
  for (int i = threadIdx.x; i < WIDE_R * p.d; i += blockDim.x) {
    const int r = i / p.d, e = i % p.d;
    float v = 0.f;
    for (int k = 0; k < p.din; ++k) {
      const float xv = xs[r * p.din + k];
      v = fmaf(xv * xv, p.invls2[k * p.d + e], v);
    }
    xn[i] = v;
  }
}

// Forward. DENSE: wts is Wblk (W, D); otherwise wts is the flat row (W,).
template <int DMAX, bool DENSE>
static __global__ void __launch_bounds__(WIDE_THREADS)
wide_fwd_kernel(const float* __restrict__ x, WideParams p,
                const float* __restrict__ wts, float* __restrict__ out, int n,
                int rows_per_block) {
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = smem;                  // (R, Din)
  float* xn = xs + WIDE_R * p.din;   // (R, D)
  float* part = xn + WIDE_R * p.d;   // (warps, R, D)
  const int ngroups = p.w >> 5;
  const int ds = p.d * p.sp;
  const int tile0 = blockIdx.x * rows_per_block;
  const int tile_end = min(n, tile0 + rows_per_block);
  for (int row0 = tile0; row0 < tile_end; row0 += WIDE_R) {
    const int rows = min(WIDE_R, n - row0);
    wide_load_rows(x, xs, row0, rows, p.din);
    __syncthreads();
    wide_xn(p, xs, xn);
    __syncthreads();

    float acc[WIDE_R][DMAX];
#pragma unroll
    for (int r = 0; r < WIDE_R; ++r)
#pragma unroll
      for (int e = 0; e < DMAX; ++e) acc[r][e] = 0.f;

    for (int grp = warp; grp < ngroups; grp += nw) {
      const int c = (grp << 5) + lane;
      float t[WIDE_R], a[WIDE_R];
      wide_t(p, xs, c, t);
      int dcol;
      if (c < ds) {  // warp-uniform: ds is a multiple of 32
        dcol = c / p.sp;
        const float ph = p.phase[c];
#pragma unroll
        for (int r = 0; r < WIDE_R; ++r) a[r] = cosf(t[r] + ph);
      } else {
        const int j = c - ds;
        dcol = j / p.mp;
        const float znj = p.zn[j];
#pragma unroll
        for (int r = 0; r < WIDE_R; ++r)
          a[r] = expf(t[r] - 0.5f * (xn[r * p.d + dcol] + znj));
      }
      if (DENSE) {
#pragma unroll
        for (int e = 0; e < DMAX; ++e) {
          if (e < p.d) {
            const float wv = wts[(size_t)c * p.d + e];
#pragma unroll
            for (int r = 0; r < WIDE_R; ++r) acc[r][e] = fmaf(a[r], wv, acc[r][e]);
          }
        }
      } else {
        const float wv = wts[c];
#pragma unroll
        for (int e = 0; e < DMAX; ++e) {
          if (e == dcol) {
#pragma unroll
            for (int r = 0; r < WIDE_R; ++r) acc[r][e] = fmaf(a[r], wv, acc[r][e]);
          }
        }
      }
    }

#pragma unroll
    for (int e = 0; e < DMAX; ++e) {
      if (e < p.d) {
#pragma unroll
        for (int r = 0; r < WIDE_R; ++r) {
          const float v = warp_sum(acc[r][e]);
          if (lane == 0) part[(warp * WIDE_R + r) * p.d + e] = v;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * p.d; i += blockDim.x) {
      const int r = i / p.d, e = i % p.d;
      float v = 0.f;
      for (int w = 0; w < nw; ++w) v += part[(w * WIDE_R + r) * p.d + e];
      out[(size_t)(row0 + r) * p.d + e] = v;
    }
    __syncthreads();  // the next pass overwrites xs / xn / part
  }
}

// Floats of one block's slab of packed parameter cotangents.
static inline int wide_slab_floats(int din, int d, int w) {
  return w * (din + d + 1) + din * d;
}

// Backward: dx (N, Din) and one slab per block,
// [db (Din, W) | dwblk (W, D) | dphase (D*Sp) | dzn (D*Mp) | dinvls2 (Din, D)].
template <int DMAX>
static __global__ void __launch_bounds__(WIDE_THREADS)
wide_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                WideParams p, const float* __restrict__ wblk,
                float* __restrict__ dx, float* __restrict__ part, int n,
                int rows_per_block) {
  extern __shared__ float smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = p.w;
  float* acc_db = smem;                       // (Din, W)
  float* acc_dw = acc_db + p.din * W;         // (D, W): dwblk, transposed
  float* acc_dc = acc_dw + p.d * W;           // (W): sum over rows of dt
  float* acc_dinv = acc_dc + W;               // (Din, D)
  float* xs = acc_dinv + p.din * p.d;         // (R, Din)
  float* gs = xs + WIDE_R * p.din;            // (R, D)
  float* xn = gs + WIDE_R * p.d;              // (R, D)
  float* dxn_s = xn + WIDE_R * p.d;           // (R, D)
  float* pdx = dxn_s + WIDE_R * p.d;          // (warps, R, Din)
  float* pdxn = pdx + nw * WIDE_R * p.din;    // (warps, R, D)
  const int n_acc = W * (p.din + p.d + 1) + p.din * p.d;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) smem[i] = 0.f;

  const int ngroups = W >> 5;
  const int ds = p.d * p.sp;
  const int tile0 = blockIdx.x * rows_per_block;
  const int tile_end = min(n, tile0 + rows_per_block);
  for (int row0 = tile0; row0 < tile_end; row0 += WIDE_R) {
    const int rows = min(WIDE_R, n - row0);
    wide_load_rows(x, xs, row0, rows, p.din);
    wide_load_rows(g, gs, row0, rows, p.d);
    __syncthreads();
    wide_xn(p, xs, xn);
    __syncthreads();

    float dxacc[WIDE_R][DMAX], dxnacc[WIDE_R][DMAX];
#pragma unroll
    for (int r = 0; r < WIDE_R; ++r)
#pragma unroll
      for (int e = 0; e < DMAX; ++e) { dxacc[r][e] = 0.f; dxnacc[r][e] = 0.f; }

    for (int grp = warp; grp < ngroups; grp += nw) {
      const int c = (grp << 5) + lane;
      float t[WIDE_R], a[WIDE_R], dt[WIDE_R], dact[WIDE_R];
      wide_t(p, xs, c, t);
      // dact = g @ Wblk^T, this column
#pragma unroll
      for (int r = 0; r < WIDE_R; ++r) dact[r] = 0.f;
      for (int e = 0; e < p.d; ++e) {
        const float wv = wblk[(size_t)c * p.d + e];
#pragma unroll
        for (int r = 0; r < WIDE_R; ++r) dact[r] = fmaf(gs[r * p.d + e], wv, dact[r]);
      }
      if (c < ds) {  // warp-uniform
        const float ph = p.phase[c];
#pragma unroll
        for (int r = 0; r < WIDE_R; ++r) {
          float sn, cs;
          sincosf(t[r] + ph, &sn, &cs);
          a[r] = cs;
          dt[r] = -sn * dact[r];
        }
      } else {
        const int j = c - ds;
        const int dcol = j / p.mp;
        const float znj = p.zn[j];
#pragma unroll
        for (int r = 0; r < WIDE_R; ++r) {
          a[r] = expf(t[r] - 0.5f * (xn[r * p.d + dcol] + znj));
          dt[r] = a[r] * dact[r];
        }
#pragma unroll
        for (int e = 0; e < DMAX; ++e) {
          if (e == dcol) {
#pragma unroll
            for (int r = 0; r < WIDE_R; ++r) dxnacc[r][e] += dt[r];
          }
        }
      }
      float sdt = 0.f;
#pragma unroll
      for (int r = 0; r < WIDE_R; ++r) sdt += dt[r];
      acc_dc[c] += sdt;
      // db[k, c] += x[:, k] . dt ; dx[:, k] += dt * B[k, c]
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < p.din) {
          const float bk = p.b[(size_t)k * W + c];
          float sdb = 0.f;
#pragma unroll
          for (int r = 0; r < WIDE_R; ++r) {
            sdb = fmaf(xs[r * p.din + k], dt[r], sdb);
            dxacc[r][k] = fmaf(dt[r], bk, dxacc[r][k]);
          }
          acc_db[k * W + c] += sdb;
        }
      }
      // dwblk[c, e] += act[:, c] . g[:, e]
      for (int e = 0; e < p.d; ++e) {
        float sdw = 0.f;
#pragma unroll
        for (int r = 0; r < WIDE_R; ++r) sdw = fmaf(a[r], gs[r * p.d + e], sdw);
        acc_dw[e * W + c] += sdw;
      }
    }

#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      if (k < p.din) {
#pragma unroll
        for (int r = 0; r < WIDE_R; ++r) {
          const float v = warp_sum(dxacc[r][k]);
          if (lane == 0) pdx[(warp * WIDE_R + r) * p.din + k] = v;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < DMAX; ++e) {
      if (e < p.d) {
#pragma unroll
        for (int r = 0; r < WIDE_R; ++r) {
          const float v = warp_sum(dxnacc[r][e]);
          if (lane == 0) pdxn[(warp * WIDE_R + r) * p.d + e] = v;
        }
      }
    }
    __syncthreads();
    // dxn[r, e] = -1/2 * rowsum of dte over dim e's Gram block
    for (int i = threadIdx.x; i < WIDE_R * p.d; i += blockDim.x) {
      const int r = i / p.d, e = i % p.d;
      float v = 0.f;
      for (int w = 0; w < nw; ++w) v += pdxn[(w * WIDE_R + r) * p.d + e];
      dxn_s[i] = -0.5f * v;
    }
    __syncthreads();
    // dx = dt @ B^T + 2 x * (dxn @ invls2^T)
    for (int i = threadIdx.x; i < rows * p.din; i += blockDim.x) {
      const int r = i / p.din, k = i % p.din;
      float v = 0.f;
      for (int w = 0; w < nw; ++w) v += pdx[(w * WIDE_R + r) * p.din + k];
      float corr = 0.f;
      for (int e = 0; e < p.d; ++e)
        corr = fmaf(dxn_s[r * p.d + e], p.invls2[k * p.d + e], corr);
      dx[(size_t)(row0 + r) * p.din + k] = v + 2.f * xs[r * p.din + k] * corr;
    }
    // dinvls2[k, e] += (x^2)[:, k] . dxn[:, e]
    for (int i = threadIdx.x; i < p.din * p.d; i += blockDim.x) {
      const int k = i / p.d, e = i % p.d;
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < WIDE_R; ++r) {
        const float xv = xs[r * p.din + k];
        v = fmaf(xv * xv, dxn_s[r * p.d + e], v);
      }
      acc_dinv[i] += v;
    }
    __syncthreads();  // the next pass overwrites xs / gs / the partials
  }

  __syncthreads();
  float* slab = part + (size_t)blockIdx.x * n_acc;
  for (int i = threadIdx.x; i < p.din * W; i += blockDim.x) slab[i] = acc_db[i];
  slab += p.din * W;
  for (int i = threadIdx.x; i < W * p.d; i += blockDim.x)
    slab[i] = acc_dw[(i % p.d) * W + i / p.d];
  slab += W * p.d;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    slab[i] = (i < ds) ? acc_dc[i] : -0.5f * acc_dc[i];  // dphase | dzn
  slab += W;
  for (int i = threadIdx.x; i < p.din * p.d; i += blockDim.x) slab[i] = acc_dinv[i];
}

static inline WideParams make_wide(const float* b, const float* phase,
                                   const float* zn, const float* invls2, int din,
                                   int d, int sp, int mp) {
  WideParams p;
  p.b = b; p.phase = phase; p.zn = zn; p.invls2 = invls2;
  p.din = din; p.d = d; p.sp = sp; p.mp = mp; p.w = d * (sp + mp);
  return p;
}

static inline bool wide_shape_ok(int din, int d, int sp, int mp, int warps) {
  return din >= 1 && d >= 1 && din <= 16 && d <= 16 && sp % 32 == 0 &&
         mp % 32 == 0 && sp + mp > 0 && warps >= 1 && 32 * warps <= WIDE_THREADS;
}

template <int DMAX>
static cudaError_t launch_wide_fwd(const float* x, const WideParams& p,
                                   const float* wts, float* out, int n, int dense,
                                   int rows_per_block, int warps,
                                   cudaStream_t stream) {
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * WIDE_R * (p.din + p.d + warps * p.d);
  if (dense)
    wide_fwd_kernel<DMAX, true><<<blocks, 32 * warps, smem, stream>>>(
        x, p, wts, out, n, rows_per_block);
  else
    wide_fwd_kernel<DMAX, false><<<blocks, 32 * warps, smem, stream>>>(
        x, p, wts, out, n, rows_per_block);
  return cudaGetLastError();
}

extern "C" int gpode_wide_fwd(const float* x, const float* b, const float* phase,
                              const float* zn, const float* invls2,
                              const float* wts, float* out, int n, int din, int d,
                              int sp, int mp, int dense, int rows_per_block,
                              int warps, void* stream) {
  if (!wide_shape_ok(din, d, sp, mp, warps) || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const WideParams p = make_wide(b, phase, zn, invls2, din, d, sp, mp);
  if (d <= 8)
    return (int)launch_wide_fwd<8>(x, p, wts, out, n, dense, rows_per_block, warps,
                                   (cudaStream_t)stream);
  return (int)launch_wide_fwd<16>(x, p, wts, out, n, dense, rows_per_block, warps,
                                  (cudaStream_t)stream);
}

template <int DMAX>
static cudaError_t launch_wide_bwd(const float* x, const float* g,
                                   const WideParams& p, const float* wblk,
                                   float* dx, float* part, int n,
                                   int rows_per_block, int warps, size_t smem,
                                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      wide_bwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  wide_bwd_kernel<DMAX><<<blocks, 32 * warps, smem, stream>>>(
      x, g, p, wblk, dx, part, n, rows_per_block);
  return cudaGetLastError();
}

// part: (blocks, slab) scratch; out: (slab,) the summed packed cotangents.
extern "C" int gpode_wide_bwd(const float* x, const float* g, const float* b,
                              const float* phase, const float* zn,
                              const float* invls2, const float* wblk, float* dx,
                              float* part, float* out, int n, int din, int d,
                              int sp, int mp, int rows_per_block, int warps,
                              void* stream) {
  if (!wide_shape_ok(din, d, sp, mp, warps) || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const WideParams p = make_wide(b, phase, zn, invls2, din, d, sp, mp);
  const int slab = wide_slab_floats(din, d, p.w);
  const size_t smem = sizeof(float) * ((size_t)slab + WIDE_R * (din + 3 * d) +
                                       (size_t)warps * WIDE_R * (din + d));
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  cudaError_t e;
  if (din <= 8 && d <= 8)
    e = launch_wide_bwd<8>(x, g, p, wblk, dx, part, n, rows_per_block, warps, smem,
                           (cudaStream_t)stream);
  else
    e = launch_wide_bwd<16>(x, g, p, wblk, dx, part, n, rows_per_block, warps,
                            smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  sum_slabs_kernel<<<(slab + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part, out, blocks, slab);
  return (int)cudaGetLastError();
}
