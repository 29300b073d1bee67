"""A plain reference for the LIO step's loop-closure mechanism: the ICP
that verifies a revisit and the pose-graph solve that a loop factor
triggers, in float64 torch on the CPU, importing nothing of the program.

Both follow the upstream's ``mapOptimization.cpp`` (``performLoopClosure``,
``addLoopFactor``, ``correctPoses``) as the program's docstrings cite it,
with these departures, each shared with the program so that both answer
the same question:

- ICP runs a fixed number of iterations (the configuration's ``icp_iters``)
  where PCL's ``IterativeClosestPoint`` stops at its transformation and
  fitness epsilons or 100 iterations; a correspondence counts within
  ``max_corr_dist`` (PCL's ``setMaxCorrespondenceDistance``), and the
  fitness is the mean squared distance of those correspondences (PCL's
  ``getFitnessScore`` with that range).
- The pose graph is solved in one batch, to a step-norm tolerance, where
  the upstream's iSAM2 relinearizes incrementally. Its between residual is
  on SO(3) x R^3, [Log(Z_R^T R_i^T R_j), R_i^T (t_j - t_i) - Z_t], not
  GTSAM's Pose3 Logmap, which couples the two parts at second order; the
  tangent is [phi, t] with the rotation perturbed on the right and the
  translation additively.
- The normal equations carry the program's Levenberg damping (``damping``
  on their diagonal, 1e-4). The prior on the first keyframe has the
  upstream's variances (1e-2, 1e-2, pi^2 rad^2, 1e8 m^2), so the graph's
  position is all but free; undamped, a solve would move the whole graph
  to put the first keyframe on its prior. Damped, the position stays where
  the solves before left it, as in the program. Every other direction of
  the graph is held at least 1e3 times more stiffly than the damping, so
  the damped iteration converges to the undamped optimum there.

``icp_point2point`` takes the nearest neighbour of every source point from
the full distance matrix; ``pose_graph_solve`` builds the dense normal
equations from hand-written residuals and Jacobians and solves them by
Cholesky.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
CHUNK = 512  # source rows a block of the distance matrix


def _d(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", F64)


# ---------------------------------------------------------------------------
# Rotations, [w, x, y, z] quaternions
# ---------------------------------------------------------------------------

def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    R = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return R.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Unit quaternions of rotation matrices, w >= 0."""
    return so3_exp_quat(so3_log(R))


def so3_exp_quat(phi: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.norm(phi, dim=-1, keepdim=True)
    k = torch.where(th > 1e-12, torch.sin(th / 2) / th.clamp(min=1e-300),
                    torch.full_like(th, 0.5))
    return torch.cat([torch.cos(th / 2), k * phi], -1)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    return quat_to_matrix(so3_exp_quat(phi))


def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    x, y, w = v.unbind(-1)
    return torch.stack([z, -w, y, w, z, -x, -y, x, z], -1).reshape(v.shape[:-1] + (3, 3))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vectors of rotation matrices (angles below pi)."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.linalg.norm(v, dim=-1, keepdim=True)
    c = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1)[..., None] / 2
    th = torch.atan2(s, c)
    return torch.where(s > 1e-12, th / s.clamp(min=1e-300), torch.ones_like(s)) * v


def right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Jr^-1(phi): Log(Exp(phi) Exp(d)) = phi + Jr^-1(phi) d to first order."""
    th = torch.linalg.norm(phi, dim=-1)[..., None, None]
    P = skew(phi)
    small = th < 1e-6
    ths = th.clamp(min=1e-6)
    c = torch.where(small, torch.full_like(th, 1.0 / 12.0),
                    1 / ths ** 2 - (1 + torch.cos(ths)) / (2 * ths * torch.sin(ths)))
    return torch.eye(3, dtype=phi.dtype) + 0.5 * P + c * (P @ P)


# ---------------------------------------------------------------------------
# Point-to-point ICP
# ---------------------------------------------------------------------------

def nearest(moved: torch.Tensor, dst: torch.Tensor):
    """(index, squared distance) of each row's nearest `dst` row, from the
    full distance matrix, a block of rows at a time."""
    idx, sqd = [], []
    for a in range(0, moved.shape[0], CHUNK):
        d2 = torch.sum((moved[a:a + CHUNK, None, :] - dst[None, :, :]) ** 2, -1)
        m = torch.min(d2, dim=1)
        idx.append(m.indices)
        sqd.append(m.values)
    return torch.cat(idx), torch.cat(sqd)


def kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """The rotation and translation that take `src` onto `dst` in the
    weighted least-squares sense (SVD of the weighted cross-covariance)."""
    ws = w.sum()
    mu_s = (src * w[:, None]).sum(0) / ws
    mu_d = (dst * w[:, None]).sum(0) / ws
    S = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)
    U, _, Vt = torch.linalg.svd(S)
    V = Vt.T
    D = torch.diag(torch.stack([torch.ones((), dtype=F64), torch.ones((), dtype=F64),
                                torch.sign(torch.linalg.det(V @ U.T))]))
    R = V @ D @ U.T
    return R, mu_d - R @ mu_s


def icp_point2point(src, src_valid, dst, dst_valid, init_trans, init_quat,
                    max_corr_dist: float, iters: int) -> dict:
    """ICP of the valid `src` points onto the valid `dst` points from the
    initial pose: each iteration pairs every moved source point with its
    nearest target point, keeps the pairs closer than `max_corr_dist` and
    re-aligns by Kabsch. Returns the pose (``trans``, ``quat``, ``R``), the
    ``fitness`` (mean squared distance of the final pairs kept) and
    ``num_corr``."""
    src, dst = _d(src), _d(dst)[_d(dst_valid).bool()]
    sv = _d(src_valid).bool()
    R, t = quat_to_matrix(_d(init_quat)), _d(init_trans)
    gate = max_corr_dist ** 2
    for _ in range(iters):
        moved = src @ R.T + t
        idx, sqd = nearest(moved, dst)
        w = (sv & (sqd < gate)).to(F64)
        dR, dt = kabsch(moved, dst[idx], w)
        R, t = dR @ R, dR @ t + dt
    _, sqd = nearest(src @ R.T + t, dst)
    keep = sv & (sqd < gate)
    n = int(keep.sum())
    fitness = float(sqd[keep].sum()) / max(n, 1)
    return {"trans": t, "quat": matrix_to_quat(R), "R": R, "fitness": fitness, "num_corr": n}


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------

def _between(Ri, ti, Rj, tj, ZR, Zt):
    """Residuals (F, 6) of between factors and their Jacobians (F, 6, 6)
    with respect to node i's and node j's [phi, t]."""
    E = ZR.transpose(-1, -2) @ Ri.transpose(-1, -2) @ Rj
    r_rot = so3_log(E)
    dt = tj - ti
    u = (Ri.transpose(-1, -2) @ dt[..., None])[..., 0]
    r = torch.cat([r_rot, u - Zt], -1)
    Jinv = right_jacobian_inv(r_rot)
    F = r.shape[0]
    Ji = torch.zeros(F, 6, 6, dtype=F64)
    Jj = torch.zeros(F, 6, 6, dtype=F64)
    Ji[:, 0:3, 0:3] = -Jinv @ Rj.transpose(-1, -2) @ Ri
    Jj[:, 0:3, 0:3] = Jinv
    Ji[:, 3:6, 0:3] = skew(u)
    Ji[:, 3:6, 3:6] = -Ri.transpose(-1, -2)
    Jj[:, 3:6, 3:6] = Ri.transpose(-1, -2)
    return r, Ji, Jj


def _prior(R0, t0, ZR, Zt):
    r_rot = so3_log(ZR.T @ R0)
    J = torch.zeros(6, 6, dtype=F64)
    J[0:3, 0:3] = right_jacobian_inv(r_rot)
    J[3:6, 3:6] = torch.eye(3, dtype=F64)
    return torch.cat([r_rot, t0 - Zt]), J


class _Graph:
    """The graph's factors in float64 over its valid nodes, compacted."""

    def __init__(self, g):
        valid = _d(g.node_valid).bool()
        self.nodes = torch.nonzero(valid)[:, 0]
        slot = torch.full((valid.shape[0],), -1, dtype=torch.long)
        slot[self.nodes] = torch.arange(len(self.nodes))
        bv = _d(g.bf_valid).bool()
        self.bi, self.bj = slot[_d(g.bf_i).long()[bv]], slot[_d(g.bf_j).long()[bv]]
        if (self.bi < 0).any() or (self.bj < 0).any():
            raise ValueError("a valid between factor names an invalid node")
        self.bR = quat_to_matrix(_d(g.bf_quat)[bv])
        self.bt, self.bw = _d(g.bf_trans)[bv], _d(g.bf_sqrtw)[bv]
        uv = _d(g.up_valid).bool()
        self.uk = slot[_d(g.up_k).long()[uv]]
        self.upos, self.uw = _d(g.up_pos)[uv], _d(g.up_sqrtw)[uv]
        self.pR, self.pt, self.pw = quat_to_matrix(_d(g.prior_quat)), _d(g.prior_trans), \
            _d(g.prior_sqrtw)
        if slot[0] != 0:
            raise ValueError("the prior's node 0 is not valid")

    def linearize(self, R, t):
        """(weighted residual vector, weighted Jacobian blocks) of every factor."""
        r, Ji, Jj = _between(R[self.bi], t[self.bi], R[self.bj], t[self.bj], self.bR, self.bt)
        r, Ji, Jj = r * self.bw, Ji * self.bw[..., None], Jj * self.bw[..., None]
        ur = (t[self.uk] - self.upos) * self.uw
        pr, pJ = _prior(R[0], t[0], self.pR, self.pt)
        return r, Ji, Jj, ur, pr * self.pw, pJ * self.pw[:, None]

    def error(self, R, t) -> float:
        r, _, _, ur, pr, _ = self.linearize(R, t)
        return float((r ** 2).sum() + (ur ** 2).sum() + (pr ** 2).sum())

    def normal_equations(self, R, t):
        """The dense H = J^T J (6N, 6N) and gradient J^T r (6N,)."""
        N = len(self.nodes)
        r, Ji, Jj, ur, pr, pJ = self.linearize(R, t)
        H = torch.zeros(N, N, 6, 6, dtype=F64)
        g = torch.zeros(N, 6, dtype=F64)
        JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
        for a, Ja, JaT in ((self.bi, Ji, JiT), (self.bj, Jj, JjT)):
            g.index_put_((a,), (JaT @ r[..., None])[..., 0], accumulate=True)
            for b, Jb in ((self.bi, Ji), (self.bj, Jj)):
                H.index_put_((a, b), JaT @ Jb, accumulate=True)
        sel = torch.zeros(3, 6, dtype=F64)
        sel[:, 3:6] = torch.eye(3, dtype=F64)
        uJ = sel * self.uw[:, :, None]
        H.index_put_((self.uk, self.uk), uJ.transpose(-1, -2) @ uJ, accumulate=True)
        g.index_put_((self.uk,), (uJ.transpose(-1, -2) @ ur[..., None])[..., 0],
                     accumulate=True)
        H[0, 0] += pJ.T @ pJ
        g[0] += pJ.T @ pr
        return H.permute(0, 2, 1, 3).reshape(6 * N, 6 * N), g.reshape(-1)


def pose_graph_solve(g, damping: float = 1e-4, step_tol: float = 1e-10,
                     max_iters: int = 100) -> dict:
    """Gauss-Newton over every valid node of a pose graph `g` (an object with
    the program's ``PoseGraph`` fields: node poses, between factors, unary
    position factors, the prior on node 0), each step the Cholesky solve of
    the dense damped normal equations, until the step's norm falls below
    `step_tol`. The step's norm leaves out its mean translation: a shift of
    the whole graph changes only the prior's residual, at its variance of
    1e8 m^2, so the damped iteration moves the graph's position by 1e-4 of
    the prior's pull a step and never settles it; compare solves in their
    first node's frame. Returns the valid nodes' ``nodes`` (indices), ``trans``,
    ``quat``, ``R``, the ``total_error`` (the sum of squared weighted
    residuals) before and after, the ``iters`` and the last ``step_norm``."""
    G = _Graph(g)
    R = quat_to_matrix(_d(g.quat)[G.nodes])
    t = _d(g.trans)[G.nodes].clone()
    e0 = G.error(R, t)
    step = math.inf
    it = 0
    while it < max_iters and step >= step_tol:
        H, grad = G.normal_equations(R, t)
        H = H + damping * torch.eye(H.shape[0], dtype=F64)
        L = torch.linalg.cholesky(H)
        dx = -torch.cholesky_solve(grad[:, None], L)[:, 0].reshape(-1, 6)
        R = R @ so3_exp(dx[:, 0:3])
        t = t + dx[:, 3:6]
        dx[:, 3:6] -= dx[:, 3:6].mean(0)  # the gauge's creep: see the docstring
        step = float(torch.linalg.norm(dx))
        it += 1
    return {"nodes": G.nodes, "trans": t, "quat": matrix_to_quat(R), "R": R,
            "total_error_before": e0, "total_error": G.error(R, t), "iters": it,
            "step_norm": step}
