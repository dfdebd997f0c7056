"""Math substrate: constraint bijectors, packed-triangular storage, PSD helpers.

Counterpart of `gpode_tpu/ops/math.py`. Batched Cholesky factorizations and
triangular solves go to `torch.linalg` (the JAX package leaves them to XLA,
outside any Pallas kernel), apart from batches of tiny factors, which take
the unrolled elementwise algorithm (`cholesky_jittered_auto`).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

# Matches the reference's softplus lower bound.
SOFTPLUS_LOWER = 1e-12

# Default jitter for PSD factorizations.
DEFAULT_JITTER = 1e-5


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Positivity bijector: unconstrained -> constrained (> SOFTPLUS_LOWER)."""
    return F.softplus(x) + SOFTPLUS_LOWER


def invsoftplus(y, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`softplus`; accepts floats or tensors."""
    y = torch.as_tensor(y, dtype=dtype)
    ys = torch.clamp(y - SOFTPLUS_LOWER, min=torch.finfo(y.dtype).eps)
    return ys + torch.log(-torch.expm1(-ys))


@functools.lru_cache(maxsize=None)
def _tril_indices(n: int, device: torch.device) -> torch.Tensor:
    """(2, n(n+1)/2) lower-triangle indices, made once per size and device
    (a fresh host-to-device copy on every call would sync the stream)."""
    return torch.tril_indices(n, n, device=device)


def fill_tril(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Packed (..., n(n+1)/2) -> lower-triangular (..., n, n); row-major
    packing order, the same as `np.tril_indices`."""
    rows, cols = _tril_indices(n, packed.device)
    out = packed.new_zeros(packed.shape[:-1] + (n, n))
    out[..., rows, cols] = packed
    return out


def pack_tril(mat: torch.Tensor) -> torch.Tensor:
    """Gather the lower triangle of (..., n, n) into (..., n(n+1)/2)."""
    rows, cols = _tril_indices(mat.shape[-1], mat.device)
    return mat[..., rows, cols]


def add_jitter(mat: torch.Tensor, jitter: float = DEFAULT_JITTER) -> torch.Tensor:
    n = mat.shape[-1]
    return mat + jitter * torch.eye(n, dtype=mat.dtype, device=mat.device)


def cholesky_jittered(mat: torch.Tensor,
                      jitter: float = DEFAULT_JITTER) -> torch.Tensor:
    """Cholesky of `mat + jitter*I`, batched over leading dims. Like XLA's,
    a failed factorization yields non-finite entries instead of raising
    (`cholesky_ex` also skips the host sync of the error check)."""
    return torch.linalg.cholesky_ex(add_jitter(mat, jitter))[0]


# Trailing dim at or below this routes batched factorizations through the
# unrolled elementwise algorithm instead of `torch.linalg` (the JAX package's
# threshold). The (N, T-1, 5, 5) shooting-state factors are then plain
# elementwise work that a captured CUDA graph holds whole, with no batched
# solver library call inside the train step.
SMALL_CHOL_MAX_DIM = 8


def cholesky_small(a: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky–Crout for tiny trailing dims; batched over leading
    dims. The JAX package's `cholesky_small`: the same triangle and the same
    recurrence order, as D(D+1)/2 columns of plain tensor arithmetic,
    differentiable through it."""
    d = a.shape[-1]
    col = [[None] * d for _ in range(d)]
    for j in range(d):
        s = a[..., j, j]
        for k in range(j):
            s = s - col[j][k] * col[j][k]
        col[j][j] = torch.sqrt(s)
        inv_d = 1.0 / col[j][j]
        for i in range(j + 1, d):
            t = a[..., i, j]
            for k in range(j):
                t = t - col[i][k] * col[j][k]
            col[i][j] = t * inv_d
    zero = torch.zeros_like(a[..., 0, 0])
    rows = [torch.stack([col[i][j] if j <= i else zero for j in range(d)],
                        dim=-1) for i in range(d)]
    return torch.stack(rows, dim=-2)


def cholesky_jittered_auto(mat: torch.Tensor,
                           jitter: float = DEFAULT_JITTER) -> torch.Tensor:
    """`cholesky_jittered`, but trailing dims up to SMALL_CHOL_MAX_DIM take
    the unrolled algorithm: for batches of small state covariances. The
    (D, M, M) GP factors keep `cholesky_jittered`."""
    if mat.shape[-1] <= SMALL_CHOL_MAX_DIM:
        return cholesky_small(add_jitter(mat, jitter))
    return cholesky_jittered(mat, jitter)


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b with L lower triangular; batched over leading dims."""
    return torch.linalg.solve_triangular(L, b, upper=False)


def solve_upper_from_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b with L lower triangular; batched over leading dims."""
    return torch.linalg.solve_triangular(L.mT, b, upper=True)


def tri_logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log det(L L^T) = 2 * sum(log diag L); batched over leading dims."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def gaussian_logpdf(y, mean, var) -> torch.Tensor:
    """Elementwise diagonal-Gaussian log density."""
    return -0.5 * (math.log(2.0 * math.pi) + torch.log(var)
                   + torch.square(y - mean) / var)


def laplace_logpdf(y, loc, scale) -> torch.Tensor:
    """Elementwise Laplace log density."""
    return -torch.log(2.0 * scale) - torch.abs(y - loc) / scale


def kl_whitened_gaussian(mean: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """KL( N(mean, L L^T) || N(0, I) ) summed over leading batch dims:
    2 KL = ||m||^2 + ||L||_F^2 - log det(L L^T) - k. The raw scale's diagonal
    may be negative or tiny mid-optimization, hence log|diag| with a floor."""
    k = mean.shape[-1]
    L = torch.tril(chol)
    mahalanobis = torch.sum(torch.square(mean), dim=-1)
    trace = torch.sum(torch.square(L), dim=(-2, -1))
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet_q = 2.0 * torch.sum(torch.log(torch.abs(diag) + 1e-20), dim=-1)
    return 0.5 * torch.sum(mahalanobis + trace - logdet_q - k)


def kl_whitened_gaussian_diag(mean: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """Diagonal-covariance version of :func:`kl_whitened_gaussian`."""
    k = mean.shape[-1]
    mahalanobis = torch.sum(torch.square(mean), dim=-1)
    trace = torch.sum(torch.square(scale), dim=-1)
    logdet_q = torch.sum(torch.log(torch.square(scale)), dim=-1)
    return 0.5 * torch.sum(mahalanobis + trace - logdet_q - k)
