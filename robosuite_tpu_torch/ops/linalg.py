"""Small dense linear algebra on batched tensors (the JAX package's
ops/linalg.py): Cholesky with the same 1e-12 pivot floor, SPD solves and
the 3x3 adjugate inverse."""

from __future__ import annotations

import torch


def chol_factor(A):
    """Lower Cholesky factor of SPD A (..., n, n); pivots floored at 1e-12
    before the square root, as the JAX package's unrolled factor does.
    Column by column, with no write into a tensor already read (so a
    reverse-mode graph goes through it)."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        Lc = torch.stack(cols, dim=-1) if cols else A[..., :, :0]       # (..., n, j): the columns so far
        s = A[..., j, j] - torch.sum(Lc[..., j, :] * Lc[..., j, :], dim=-1)
        d = torch.sqrt(torch.clamp_min(s, 1e-12))
        off = A[..., j + 1:, j] - torch.sum(Lc[..., j + 1:, :] * Lc[..., j:j + 1, :], dim=-1)
        cols.append(torch.cat([torch.zeros_like(A[..., :j, j]), d[..., None], off * (1.0 / d)[..., None]], dim=-1))
    return torch.stack(cols, dim=-1)


def chol_solve(L, b):
    """Solve A x = b given L = chol_factor(A). b: (..., n) or (..., n, m)."""
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x


def solve_spd(A, b):
    return chol_solve(chol_factor(A), b)


def inv_spd(A):
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    return chol_solve(chol_factor(A), eye)


def inv3(A):
    """Closed-form inverse of (..., 3, 3) matrices via the adjugate, with the
    determinant floored away from 0 at 1e-12."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    rows = torch.stack(
        [torch.stack([A11, A12, A13], -1), torch.stack([A21, A22, A23], -1), torch.stack([A31, A32, A33], -1)],
        dim=-2,
    )
    return rows * inv_det[..., None, None]
