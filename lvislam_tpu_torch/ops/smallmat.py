"""Closed-form small-matrix math — port of ``lvislam_tpu.ops.smallmat``.

Batched symmetric 3x3 eigensystems (trigonometric closed form, true
``arccos``), the spectral-projector eigenvector, the regularized algebraic
plane fit and a Cramer 3x3 solve. The op order follows the JAX module line
for line: this is the arithmetic kernel K2 (``ops.gn_partials``) repeats per
point on the card.
"""

from __future__ import annotations

import math

import torch

from ..core.lie import cross

_EPS = 1e-12
_TWO_PI_3 = 2.0 * math.pi / 3.0


def _eigvals_entries(a00, a01, a02, a11, a12, a22):
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    l2 = 3.0 * q - l1 - l3
    iso = p2 < 1e-20
    l1 = torch.where(iso, q, l1)
    l2 = torch.where(iso, q, l2)
    l3 = torch.where(iso, q, l3)
    return l1, l2, l3


def sym3x3_eigvals(A: torch.Tensor):
    """Eigenvalues of symmetric (..., 3, 3), descending."""
    return _eigvals_entries(A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
                            A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])


def _max_eigvec_entries(a00, a01, a02, a11, a12, a22, la, lb):
    """Dominant column of (A - la I)(A - lb I) for symmetric A given by its
    unique entries, normalized; the product's sums run k = 0, 1, 2 and the
    column is the first max of the column norms (``jnp.argmax``)."""
    Bm = ((a00 - la, a01, a02), (a01, a11 - la, a12), (a02, a12, a22 - la))
    Cm = ((a00 - lb, a01, a02), (a01, a11 - lb, a12), (a02, a12, a22 - lb))
    M = [[Bm[r][0] * Cm[0][c] + Bm[r][1] * Cm[1][c] + Bm[r][2] * Cm[2][c]
          for c in range(3)] for r in range(3)]
    cols = [torch.stack([M[0][c], M[1][c], M[2][c]], dim=-1) for c in range(3)]
    norms = torch.stack(
        [torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                    + v[..., 2] * v[..., 2]) for v in cols], dim=-1)
    col = torch.argmax(norms, dim=-1)
    v = torch.take_along_dim(torch.stack(cols, dim=-1), col[..., None, None],
                             dim=-1)[..., 0]
    nv = torch.take_along_dim(norms, col[..., None], dim=-1)
    return v / torch.clamp(nv, min=_EPS)


def _entries(A):
    return (A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
            A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])


def sym3x3_max_eigvec(A: torch.Tensor, l1, l2, l3):
    """Unit eigenvector of the largest eigenvalue: the dominant column of
    the spectral projector (A - l2 I)(A - l3 I)."""
    return _max_eigvec_entries(*_entries(A), l2, l3)


def scatter_entries(nbrs: torch.Tensor):
    """Mean and the unique entries of the centred scatter of (..., K, 3)
    neighbourhoods, every sum taken over k in order."""
    K = nbrs.shape[-2]
    tot = nbrs[..., 0, :]
    for k in range(1, K):
        tot = tot + nbrs[..., k, :]
    m = tot / K
    dev = nbrs - m[..., None, :]

    def s(i, j):
        acc = dev[..., 0, i] * dev[..., 0, j]
        for k in range(1, K):
            acc = acc + dev[..., k, i] * dev[..., k, j]
        return acc

    return m, (s(0, 0), s(0, 1), s(0, 2), s(1, 1), s(1, 2), s(2, 2))


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def plane_fit(nbrs: torch.Tensor, eps: float = 1e-8):
    """Regularized algebraic plane fit of (..., K, 3) neighbourhoods, the
    minimizer of |A x + 1|² + eps|x|², returned as (n, d0) with n·p + d0 ≈ 0.
    Computed stably by Sherman-Morrison in the centred scatter's eigenbasis
    (see the JAX module's docstring for why neither the raw normal
    equations nor a total-least-squares fit will do)."""
    K = nbrs.shape[-2]
    m, S = scatter_entries(nbrs)
    l1, l2, l3 = _eigvals_entries(*S)
    v1 = _max_eigvec_entries(*S, l2, l3)
    v3 = _max_eigvec_entries(*S, l2, l1)  # min eigenvector: l1, l3 swapped
    m1 = _dot3(v1, m)[..., None]
    m3 = _dot3(v3, m)[..., None]
    reg = (eps + 1e-6 * l1)[..., None]
    w1 = 1.0 / (l1[..., None] + reg)
    w2 = 1.0 / (l2[..., None] + reg)
    w3 = 1.0 / (l3[..., None] + reg)
    bim = w1 * m1 * v1 + w3 * m3 * v3 + w2 * (m - m1 * v1 - m3 * v3)
    s = _dot3(m, bim)[..., None]
    x = -K * bim / (1.0 + K * s)
    ps = torch.clamp(torch.sqrt(_dot3(x, x)), min=_EPS)
    n = x / ps[..., None]
    d0 = 1.0 / ps
    return n, d0


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve via Cramer's rule (cross-product form)."""
    c0, c1, c2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    cb = cross(c1, c2)
    det = torch.sum(c0 * cb, dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(det) > _EPS, det,
                                torch.full_like(det, math.inf))
    x0 = torch.sum(b * cb, dim=-1) * inv_det
    x1 = torch.sum(b * cross(c2, c0), dim=-1) * inv_det
    x2 = torch.sum(b * cross(c0, c1), dim=-1) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)
