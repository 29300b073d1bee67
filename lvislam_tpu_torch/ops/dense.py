"""Dense linear algebra without host syncs.

``torch.linalg.cholesky`` and ``torch.linalg.solve`` read their LAPACK
``info`` back to raise on failure, which stalls the stream once a call. The
``_ex`` forms leave ``info`` on the device. Like ``jnp.linalg``, these
wrappers never raise: a failed factorization turns the result into NaN, which
the callers' cost comparisons and failure predicates reject.
"""

from __future__ import annotations

import torch


def _nan_where_failed(x: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    bad = (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n); NaN where A is not positive
    definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return _nan_where_failed(L, info)


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b for (..., n, n) and a vector (..., n) or matrix (..., n, k)
    right-hand side."""
    vec = b.dim() == A.dim() - 1
    x, info = torch.linalg.solve_ex(A, b[..., None] if vec else b)
    x = _nan_where_failed(x, info)
    return x[..., 0] if vec else x


def solve_triangular(T: torch.Tensor, b: torch.Tensor, lower: bool) -> torch.Tensor:
    """T⁻¹ b for triangular T and a vector or matrix right-hand side."""
    vec = b.dim() == T.dim() - 1
    x = torch.linalg.solve_triangular(T, b[..., None] if vec else b, upper=not lower)
    return x[..., 0] if vec else x


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ b for a lower Cholesky factor and a vector right-hand side."""
    return torch.cholesky_solve(b[..., None], L)[..., 0]
