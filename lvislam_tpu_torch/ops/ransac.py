"""Batched-hypothesis RANSAC — port of ``lvislam_tpu.ops.ransac``: the
fundamental-matrix model the feature tracker runs and the PnP model the
loop detector verifies candidates with.

``fundamental_ransac`` is cv::findFundamentalMat(FM_RANSAC, F_THRESHOLD)
as the tracker's outlier rejection uses it (`feature_tracker.cpp:209-242`
rejectWithF): every hypothesis's normalized 8-point model is solved in one
batched call and inliers are counted for all hypotheses at once.

The sampled indices are an input. JAX draws them with
``jax.random.choice(replace=False, p=w)``, which torch cannot reproduce, so
the tests feed JAX's own draws through ``idx``. Without ``idx`` the port
draws by Gumbel top-k over ``log(w)`` from a ``torch.Generator`` seeded
with ``seed`` on every call: the same validity mask gives the same
hypotheses, as JAX's fixed key does, and fewer than 8 valid points (even
none) still give indices instead of an error. ``pnp_ransac`` takes its
draws the same way (6 points a hypothesis, JAX's key ``seed + 1``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import lie
from . import dense


def hypothesis_weights(valid: torch.Tensor) -> torch.Tensor:
    """Sampling weights: uniform over the valid points (JAX's ``w``)."""
    w = valid.to(torch.float32)
    return w / torch.clamp(torch.sum(w), min=1.0)


def sample_indices(weights: torch.Tensor, n_hyp: int, k: int,
                   generator: torch.Generator) -> torch.Tensor:
    """(n_hyp, k) indices drawn without replacement, weighted by
    `weights`, by Gumbel top-k. Zero-weight points come last (in index
    order), so the draw never fails. The uniform numbers are made on the
    generator's device: a host generator gives the card the draws of a CPU
    run."""
    u = torch.rand((n_hyp, weights.shape[0]), generator=generator,
                   device=generator.device, dtype=torch.float32).to(weights.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-30)))
    keys = torch.log(weights)[None, :] + gumbel
    return torch.sort(keys, dim=1, descending=True, stable=True).indices[:, :k]


def _solve_min_eigvec(A: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Smallest right-singular vector of batched A (..., m, n) by inverse
    power iteration on AᵀA (JAX's form, kept for parity)."""
    AtA = A.transpose(-1, -2) @ A
    n = AtA.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    M = AtA + 1e-6 * tr * eye + 1e-7 * eye
    LU, piv, _ = torch.linalg.lu_factor_ex(M)  # _ex: no host sync on info
    v = torch.ones(AtA.shape[:-1], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        v = torch.linalg.lu_solve(LU, piv, v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    return v


class FRansacResult(NamedTuple):
    inliers: torch.Tensor  # (N,) bool
    F: torch.Tensor  # (3, 3)
    n_inliers: torch.Tensor  # ()


def _mean_seq(x: torch.Tensor) -> torch.Tensor:
    """Mean over axis 1 summed in index order, as XLA reduces a short axis
    (``torch.mean`` sums pairwise: one ulp apart, and an 8-point model can
    turn one ulp into a different F)."""
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc / x.shape[1]


def _normalize(p: torch.Tensor):
    """Hartley normalization of each hypothesis's points (H, 8, 2)."""
    mu = _mean_seq(p)[:, None, :]
    c = p - mu
    d = _mean_seq(torch.sqrt(c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]))
    s = torch.full_like(d, math.sqrt(2.0)) / torch.clamp(d, min=1e-6)
    z, o = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, z, -s * mu[:, 0, 0]], -1),
        torch.stack([z, s, -s * mu[:, 0, 1]], -1),
        torch.stack([z, z, o], -1),
    ], dim=1)
    return (p - mu) * s[:, None, None], T


def fundamental_ransac(
    pts1: torch.Tensor,  # (N, 2) pixel coords (virtual pinhole)
    pts2: torch.Tensor,  # (N, 2)
    valid: torch.Tensor,  # (N,)
    threshold: float = 1.0,  # pixels (F_THRESHOLD)
    n_hyp: int = 256,
    seed: int = 0,
    idx: torch.Tensor | None = None,  # (n_hyp, 8) sampled indices
    generator: torch.Generator | None = None,
) -> FRansacResult:
    """Normalized 8-point RANSAC; inlier metric = symmetric epipolar
    distance (OpenCV FM_RANSAC semantics)."""
    N = pts1.shape[0]
    if idx is None:
        if generator is None:
            generator = torch.Generator(device=pts1.device).manual_seed(seed)
        idx = sample_indices(hypothesis_weights(valid), n_hyp, 8, generator)
    p1n, T1 = _normalize(pts1[idx])
    p2n, T2 = _normalize(pts2[idx])

    # 8-point rows [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1]
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)],
        dim=-1,
    )  # (H, 8, 9)
    F = _solve_min_eigvec(A).reshape(-1, 3, 3)
    F = T2.transpose(1, 2) @ F @ T1
    F = F / torch.clamp(torch.abs(F[:, 2:3, 2:3]), min=1e-9)

    ones = torch.ones((N, 1), dtype=pts1.dtype, device=pts1.device)
    h1 = torch.cat([pts1, ones], dim=-1)  # (N, 3)
    h2 = torch.cat([pts2, ones], dim=-1)
    Fx1 = torch.einsum("hij,nj->hni", F, h1)  # (H, N, 3)
    Ftx2 = torch.einsum("hji,nj->hni", F, h2)
    x2Fx1 = torch.einsum("ni,hni->hn", h2, Fx1)
    d2 = x2Fx1**2 * (
        1.0 / torch.clamp(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2, min=1e-12)
        + 1.0 / torch.clamp(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2, min=1e-12)
    )
    inl = (d2 < threshold**2) & valid[None, :]
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts)
    return FRansacResult(inliers=inl[best], F=F[best], n_inliers=counts[best])


class PnPResult(NamedTuple):
    trans: torch.Tensor  # (3,) world -> camera
    quat: torch.Tensor  # (4,)
    inliers: torch.Tensor  # (N,)
    n_inliers: torch.Tensor  # ()


def _sum_seq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over a short axis in index order (XLA's order)."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _dlt_pose(X: torch.Tensor, uv: torch.Tensor):
    """Batched 6+ point DLT for P = [R|t] from world points X (H, K, 3) and
    normalized image points uv (H, K, 2), object points Hartley-normalized
    first. Returns (R (H, 3, 3), t (H, 3)); R by 6 Newton steps of the polar
    decomposition R = M (MᵀM)^(-1/2)."""
    H, K, _ = X.shape
    c = (_sum_seq(X, 1) / K)[:, None, :]
    spread = _sum_seq(lie.norm3(X - c), 1) / K
    s = math.sqrt(3.0) / torch.clamp(spread, min=1e-6)
    X = (X - c) * s[:, None, None]
    zeros = torch.zeros((H, K, 4), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, torch.ones((H, K, 1), dtype=X.dtype, device=X.device)], dim=-1)
    r1 = torch.cat([Xh, zeros, -uv[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -uv[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=1)  # (H, 2K, 12)
    P = _solve_min_eigvec(A).reshape(-1, 3, 4)
    # a proper rotation needs det(M) > 0 (cheirality: the inlier gate)
    P = P * torch.sign(torch.linalg.det(P[:, :, :3]))[:, None, None]
    M = P[:, :, :3]
    scale = torch.clamp(torch.linalg.det(M), min=1e-12) ** (1.0 / 3.0)
    R = M / scale[:, None, None]
    t = P[:, :, 3] / scale[:, None]
    for _ in range(6):
        R = 0.5 * (R + torch.linalg.inv_ex(R.transpose(1, 2))[0])
    # undo the normalization: x ∝ R(s(X - c)) + t_n = s[R X + (t_n/s - R c)]
    t = t / s[:, None] - torch.einsum("hij,hj->hi", R, c[:, 0, :])
    return R, t


def pnp_ransac(
    obj_pts: torch.Tensor,  # (N, 3) world points
    img_pts: torch.Tensor,  # (N, 2) normalized-plane observations
    valid: torch.Tensor,  # (N,)
    threshold: float = 10.0 / 460.0,  # reprojection gate (normalized units)
    n_hyp: int = 128,
    refine_iters: int = 5,
    seed: int = 0,
    idx: torch.Tensor | None = None,  # (n_hyp, 6) sampled indices
    generator: torch.Generator | None = None,
) -> PnPResult:
    """Parallel-hypothesis PnP (cv::solvePnPRansac + iterative refine): a
    6-point DLT a hypothesis, inliers by reprojection error and positive
    depth, then Gauss-Newton on the best model's inliers (forward-mode
    Jacobian). No host read."""
    if idx is None:
        if generator is None:
            generator = torch.Generator(device=obj_pts.device).manual_seed(seed + 1)
        idx = sample_indices(hypothesis_weights(valid), n_hyp, 6, generator)
    R, t = _dlt_pose(obj_pts[idx], img_pts[idx])

    Pc = torch.einsum("hij,nj->hni", R, obj_pts) + t[:, None, :]  # (H, N, 3)
    proj = Pc[..., :2] / torch.clamp(Pc[..., 2:3], min=1e-6)
    d = proj - img_pts[None]
    err = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    inl = (err < threshold) & valid[None, :] & (Pc[..., 2] > 0.05)
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts)
    Rb, tb = R[best], t[best]
    inliers = inl[best]

    q0 = lie.matrix_to_quat(Rb)
    w = inliers[:, None].to(obj_pts.dtype)

    def residual(x):
        q = lie.quat_multiply(q0, lie.so3_exp_quat(x[:3]))
        pc = lie.quat_rotate(q[None], obj_pts) + x[3:6][None]
        pr = pc[..., :2] / torch.clamp(pc[..., 2:3], min=1e-6)
        r = ((pr - img_pts) * w).reshape(-1)
        return r, r

    jac = torch.func.jacfwd(residual, has_aux=True)
    eye6 = torch.eye(6, dtype=obj_pts.dtype, device=obj_pts.device)
    x = torch.cat([torch.zeros(3, dtype=obj_pts.dtype, device=obj_pts.device), tb])
    for _ in range(refine_iters):
        J, r = jac(x)
        x = x - dense.solve(J.T @ J + 1e-8 * eye6, J.T @ r)
    q = lie.quat_normalize(lie.quat_multiply(q0, lie.so3_exp_quat(x[:3])))
    return PnPResult(trans=x[3:6], quat=q, inliers=inliers, n_inliers=counts[best])
