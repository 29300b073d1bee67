"""Triangulation and two-view relative pose — port of
``lvislam_tpu.ops.triangulate``.

- ``triangulate_two_view``: DLT, batched over points;
- ``triangulate_multiview``: multi-view DLT with masked rows, batched over
  features by leading dimensions;
- ``relative_pose``: the essential matrix from normalized-coordinate 8-point
  RANSAC, then the 4-way decomposition with cheirality voting.

The RANSAC draws are an input, as in ``ops.ransac``: `idx` injects the
sampled indices, or `sampler` makes them from the sampling weights (the tests
feed JAX's draws through either); otherwise they come from a
``torch.Generator`` seeded with `seed` on every call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ransac import _solve_min_eigvec, fundamental_ransac, hypothesis_weights


def _dehomogenize(v: torch.Tensor) -> torch.Tensor:
    w = v[..., 3:]
    inf = torch.full_like(w, float("inf"))
    return v[..., :3] / torch.where(torch.abs(w) > 1e-12, w, inf)


def triangulate_two_view(
    P0: torch.Tensor,  # (3, 4) projection matrix of view 0 ([R|t] world->cam)
    P1: torch.Tensor,  # (3, 4)
    x0: torch.Tensor,  # (..., 2) normalized image coords in view 0
    x1: torch.Tensor,  # (..., 2)
) -> torch.Tensor:
    """Batched DLT triangulation -> world points (..., 3)."""
    rows = torch.stack(
        [
            x0[..., 0, None] * P0[2] - P0[0],
            x0[..., 1, None] * P0[2] - P0[1],
            x1[..., 0, None] * P1[2] - P1[0],
            x1[..., 1, None] * P1[2] - P1[1],
        ],
        dim=-2,
    )  # (..., 4, 4)
    return _dehomogenize(_solve_min_eigvec(rows))


def triangulate_multiview(
    Rs: torch.Tensor,  # (..., K, 3, 3) world->cam rotations per view
    ts: torch.Tensor,  # (..., K, 3)
    obs: torch.Tensor,  # (..., K, 2) normalized observations
    valid: torch.Tensor,  # (..., K) which views observe the point
):
    """Multi-view DLT with masked rows. Returns (point (..., 3),
    depth-in-view0 (...,))."""
    P = torch.cat([Rs, ts[..., None]], dim=-1)  # (..., K, 3, 4)
    r1 = obs[..., 0, None] * P[..., 2, :] - P[..., 0, :]
    r2 = obs[..., 1, None] * P[..., 2, :] - P[..., 1, :]
    rows = torch.cat([r1, r2], dim=-2)  # (..., 2K, 4)
    w = torch.cat([valid, valid], dim=-1).to(rows.dtype)
    pt = _dehomogenize(_solve_min_eigvec(rows * w[..., None]))
    depth0 = (Rs[..., 0, :, :] @ pt[..., None])[..., 2, 0] + ts[..., 0, 2]
    return pt, depth0


class RelPose(NamedTuple):
    R: torch.Tensor  # (3, 3) rotation l->cur:  x_cur = R x_l + t
    t: torch.Tensor  # (3,) unit-norm translation
    inliers: torch.Tensor  # (N,)
    ok: torch.Tensor  # ()


def relative_pose(
    x0: torch.Tensor,  # (N, 2) normalized coords, frame l
    x1: torch.Tensor,  # (N, 2) normalized coords, current frame
    valid: torch.Tensor,
    threshold: float = 0.3 / 460.0,
    n_hyp: int = 256,
    seed: int = 0,
    idx: torch.Tensor | None = None,  # (n_hyp, 8) sampled indices
    sampler=None,  # (weights, n_hyp, k) -> indices, as the tracker's
) -> RelPose:
    """Essential-matrix relative pose with cheirality voting."""
    if idx is None and sampler is not None:
        idx = sampler(hypothesis_weights(valid), n_hyp, 8)
    fr = fundamental_ransac(x0, x1, valid, threshold=threshold, n_hyp=n_hyp,
                            seed=seed, idx=idx)
    E = fr.F  # normalized coords => F == E (up to scale)
    dtype, device = E.dtype, E.device
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=dtype, device=device)

    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tu = U[:, 2]

    P0 = torch.eye(3, 4, dtype=dtype, device=device)

    def count_cheirality(R, t):
        # triangulate with P0=[I|0], P1=[R|t]; count points in front of both
        X = triangulate_two_view(P0, torch.cat([R, t[:, None]], dim=1), x0, x1)
        z0 = X[..., 2]
        z1 = (X @ R.T + t)[..., 2]
        return torch.sum((z0 > 0) & (z1 > 0) & fr.inliers)

    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([tu, -tu, tu, -tu])
    counts = torch.stack([count_cheirality(R, t) for R, t in zip(Rs, ts)])
    best = torch.argmax(counts)
    ok = (fr.n_inliers > 12) & (counts[best] > 0.7 * torch.clamp(fr.n_inliers, min=1))
    return RelPose(R=Rs[best], t=ts[best], inliers=fr.inliers, ok=ok)
