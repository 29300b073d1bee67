"""Keyframe pose-graph solver — port of ``lvislam_tpu.ops.posegraph``:
batch Gauss-Newton over all keyframe poses with a matrix-free
preconditioned-CG inner solve, over fixed-capacity factor blocks (prior on
node 0, between factors, GPS unary position factors).

Factor Jacobians come from forward-mode autodiff (``torch.func.jacfwd``
under ``torch.func.vmap``), as the JAX module uses ``jax.jacfwd``. The
per-node scatter-adds are fixed-order segment sums (``ops.segment``).

Pose tangent: [phi(3), t(3)] with right rotation perturbation
q' = q ⊗ exp(phi) and additive translation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..core import lie
from .segment import scatter_add


class PoseGraph(NamedTuple):
    trans: torch.Tensor  # (K, 3)
    quat: torch.Tensor  # (K, 4)
    node_valid: torch.Tensor  # (K,)
    bf_i: torch.Tensor  # (F,) int32
    bf_j: torch.Tensor  # (F,)
    bf_trans: torch.Tensor  # (F, 3)
    bf_quat: torch.Tensor  # (F, 4)
    bf_sqrtw: torch.Tensor  # (F, 6)
    bf_valid: torch.Tensor  # (F,)
    up_k: torch.Tensor  # (G,) int32
    up_pos: torch.Tensor  # (G, 3)
    up_sqrtw: torch.Tensor  # (G, 3)
    up_valid: torch.Tensor  # (G,)
    prior_trans: torch.Tensor  # (3,)
    prior_quat: torch.Tensor  # (4,)
    prior_sqrtw: torch.Tensor  # (6,)


def empty_graph(max_nodes: int, max_between: int, max_unary: int,
                dtype=torch.float32, device=None) -> PoseGraph:
    K, F, G = max_nodes, max_between, max_unary
    qi = lie.quat_identity(dtype, device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return PoseGraph(
        trans=z(K, 3), quat=qi.repeat(K, 1), node_valid=z(K, dt=torch.bool),
        bf_i=z(F, dt=torch.int32), bf_j=z(F, dt=torch.int32),
        bf_trans=z(F, 3), bf_quat=qi.repeat(F, 1), bf_sqrtw=z(F, 6),
        bf_valid=z(F, dt=torch.bool),
        up_k=z(G, dt=torch.int32), up_pos=z(G, 3), up_sqrtw=z(G, 3),
        up_valid=z(G, dt=torch.bool),
        prior_trans=z(3), prior_quat=qi.clone(), prior_sqrtw=z(6),
    )


PRIOR_SQRTW = tuple(1.0 / (v**0.5) for v in (1e-2, 1e-2, 9.8696044, 1e8, 1e8, 1e8))
ODOM_SQRTW = tuple(1.0 / (v**0.5) for v in (1e-6, 1e-6, 1e-6, 1e-4, 1e-4, 1e-4))


def _between_residual(ti, qi, tj, qj, t_m, q_m):
    qi_inv = lie.quat_conjugate(qi)
    q_ij = lie.quat_multiply(qi_inv, qj)
    t_ij = lie.quat_rotate(qi_inv, tj - ti)
    r_rot = lie.quat_log(lie.quat_multiply(lie.quat_conjugate(q_m), q_ij))
    return torch.cat([r_rot, t_ij - t_m])


def _retract(t, q, delta):
    return t + delta[3:6], lie.quat_multiply(q, lie.so3_exp_quat(delta[0:3]))


def _between_jac(ti, qi, tj, qj, t_m, q_m):
    def f(d):
        ti2, qi2 = _retract(ti, qi, d[0:6])
        tj2, qj2 = _retract(tj, qj, d[6:12])
        return _between_residual(ti2, qi2, tj2, qj2, t_m, q_m)

    return jacfwd(f)(torch.zeros(12, dtype=ti.dtype, device=ti.device))


def _prior_residual(t0, q0, t_m, q_m):
    r_rot = lie.quat_log(lie.quat_multiply(lie.quat_conjugate(q_m), q0))
    return torch.cat([r_rot, t0 - t_m])


def _prior_jac(t0, q0, t_m, q_m):
    def f(d):
        t2, q2 = _retract(t0, q0, d)
        return _prior_residual(t2, q2, t_m, q_m)

    return jacfwd(f)(torch.zeros(6, dtype=t0.dtype, device=t0.device))


class _Lin(NamedTuple):
    bf_J: torch.Tensor  # (F, 6, 12)
    bf_r: torch.Tensor  # (F, 6)
    up_J: torch.Tensor  # (G, 3, 6)
    up_r: torch.Tensor  # (G, 3)
    pr_J: torch.Tensor  # (6, 6)
    pr_r: torch.Tensor  # (6,)


def _linearize(g: PoseGraph) -> _Lin:
    bi, bj = g.bf_i.long(), g.bf_j.long()
    ti, qi, tj, qj = g.trans[bi], g.quat[bi], g.trans[bj], g.quat[bj]
    bf_r = vmap(_between_residual)(ti, qi, tj, qj, g.bf_trans, g.bf_quat)
    bf_J = vmap(_between_jac)(ti, qi, tj, qj, g.bf_trans, g.bf_quat)
    w = torch.where(g.bf_valid[:, None], g.bf_sqrtw, torch.zeros_like(g.bf_sqrtw))
    bf_r = bf_r * w
    bf_J = bf_J * w[:, :, None]

    uw = torch.where(g.up_valid[:, None], g.up_sqrtw, torch.zeros_like(g.up_sqrtw))
    up_r = (g.trans[g.up_k.long()] - g.up_pos) * uw
    G = g.up_k.shape[0]
    sel = torch.cat([torch.zeros((3, 3), dtype=g.trans.dtype, device=g.trans.device),
                     torch.eye(3, dtype=g.trans.dtype, device=g.trans.device)], dim=1)
    up_J = sel[None].repeat(G, 1, 1) * uw[:, :, None]

    pr_r = _prior_residual(g.trans[0], g.quat[0], g.prior_trans, g.prior_quat)
    pr_J = _prior_jac(g.trans[0], g.quat[0], g.prior_trans, g.prior_quat)
    return _Lin(bf_J=bf_J, bf_r=bf_r, up_J=up_J, up_r=up_r,
                pr_J=pr_J * g.prior_sqrtw[:, None], pr_r=pr_r * g.prior_sqrtw)


def _add_at(x, idx, v):
    return scatter_add(x, idx, v)


def _add_node0(x, v):
    return torch.cat([x[:1] + v[None], x[1:]], dim=0)


def _gradient(g: PoseGraph, lin: _Lin) -> torch.Tensor:
    K = g.trans.shape[0]
    grad = torch.zeros((K, 6), dtype=g.trans.dtype, device=g.trans.device)
    gi = torch.einsum("fab,fa->fb", lin.bf_J[:, :, 0:6], lin.bf_r)
    gj = torch.einsum("fab,fa->fb", lin.bf_J[:, :, 6:12], lin.bf_r)
    grad = _add_at(grad, g.bf_i, gi)
    grad = _add_at(grad, g.bf_j, gj)
    grad = _add_at(grad, g.up_k, torch.einsum("gab,ga->gb", lin.up_J, lin.up_r))
    grad = _add_node0(grad, lin.pr_J.T @ lin.pr_r)
    return -grad


def _hvp(g: PoseGraph, lin: _Lin, v: torch.Tensor, damping) -> torch.Tensor:
    vi = v[g.bf_i.long()]
    vj = v[g.bf_j.long()]
    Jv = (torch.einsum("fab,fb->fa", lin.bf_J[:, :, 0:6], vi)
          + torch.einsum("fab,fb->fa", lin.bf_J[:, :, 6:12], vj))
    out = torch.zeros_like(v)
    out = _add_at(out, g.bf_i, torch.einsum("fab,fa->fb", lin.bf_J[:, :, 0:6], Jv))
    out = _add_at(out, g.bf_j, torch.einsum("fab,fa->fb", lin.bf_J[:, :, 6:12], Jv))
    uJv = torch.einsum("gab,gb->ga", lin.up_J, v[g.up_k.long()])
    out = _add_at(out, g.up_k, torch.einsum("gab,ga->gb", lin.up_J, uJv))
    out = _add_node0(out, lin.pr_J.T @ (lin.pr_J @ v[0]))
    return out + damping * v


def _block_precond(g: PoseGraph, lin: _Lin, damping) -> torch.Tensor:
    K = g.trans.shape[0]
    Ji = lin.bf_J[:, :, 0:6]
    Jj = lin.bf_J[:, :, 6:12]
    diag = torch.zeros((K, 6, 6), dtype=g.trans.dtype, device=g.trans.device)
    diag = _add_at(diag, g.bf_i, torch.einsum("fab,fac->fbc", Ji, Ji))
    diag = _add_at(diag, g.bf_j, torch.einsum("fab,fac->fbc", Jj, Jj))
    diag = _add_at(diag, g.up_k, torch.einsum("gab,gac->gbc", lin.up_J, lin.up_J))
    diag = _add_node0(diag, lin.pr_J.T @ lin.pr_J)
    diag = diag + (damping + 1e-6) * torch.eye(6, dtype=diag.dtype, device=diag.device)
    return torch.linalg.inv_ex(diag)[0]


def _pcg(g: PoseGraph, lin: _Lin, b, damping, iters: int):
    """Preconditioned CG for (JᵀJ + damping I) x = b, masked to valid nodes."""
    mask = g.node_valid[:, None].to(b.dtype)
    Minv = _block_precond(g, lin, damping)

    def apply_M(r):
        return torch.einsum("kab,kb->ka", Minv, r) * mask

    x = torch.zeros_like(b)
    r = b * mask
    z = apply_M(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = _hvp(g, lin, p, damping) * mask
        pAp = torch.sum(p * Ap)
        alpha = torch.where(pAp > 1e-12, rz / pAp, torch.zeros_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > 1e-12, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
    return x


def optimize(g: PoseGraph, gn_iters: int = 8, pcg_iters: int = 64,
             damping: float = 1e-4) -> PoseGraph:
    """Batch Gauss-Newton over the whole graph (fully relinearized)."""
    d = torch.as_tensor(damping, dtype=g.trans.dtype, device=g.trans.device)
    for _ in range(gn_iters):
        lin = _linearize(g)
        b = _gradient(g, lin)
        dx = _pcg(g, lin, b, d, pcg_iters)
        dx = dx * g.node_valid[:, None]
        new_t = g.trans + dx[:, 3:6]
        new_q = lie.quat_normalize(
            lie.quat_multiply(g.quat, lie.so3_exp_quat(dx[:, 0:3])))
        keep = g.node_valid[:, None]
        g = g._replace(trans=torch.where(keep, new_t, g.trans),
                       quat=torch.where(keep, new_q, g.quat))
    return g


def marginal_position_variance(g: PoseGraph, node: int) -> torch.Tensor:
    """Block-Jacobi approximation of the marginal x/y/z position variances
    of `node`."""
    lin = _linearize(g)
    Minv = _block_precond(g, lin, torch.zeros((), dtype=g.trans.dtype,
                                              device=g.trans.device))
    cov = Minv[node]
    return torch.stack([cov[3, 3], cov[4, 4], cov[5, 5]])


def total_error(g: PoseGraph) -> torch.Tensor:
    lin = _linearize(g)
    return (torch.sum(lin.bf_r ** 2) + torch.sum(lin.up_r ** 2)
            + torch.sum(lin.pr_r ** 2))


def dense_information(g: PoseGraph):
    """EXACT dense Gauss-Newton information matrix H = J^T J (6K, 6K) over
    all factor blocks (prior + between + unary), per-node layout
    [rot(3), trans(3)]: the normal-equations matrix whose inverse block is
    the reference's `isam->marginalCovariance(key)`
    (`mapOptimization.cpp:1437-1445`). Validation-scale only (O(F·(6K)^2)
    build, O((6K)^3) inverse): the product path gates GPS on the first-order
    proxy (`mapping._add_keyframe` `pose_cov_xy`), which this checks.
    Returned as float64 numpy on the host, as the JAX function returns it
    (the prior's 1e8 free-position variance makes the inverse ill-conditioned
    in float32). Invalid (unused) node slots are pinned with a unit prior so
    H stays invertible."""
    import numpy as np

    lin = _linearize(g)
    K = g.trans.shape[0]
    D = 6 * K
    H = np.zeros((D, D))

    bf_J = lin.bf_J.detach().cpu().numpy().astype(np.float64)
    bf_i = g.bf_i.cpu().numpy()
    bf_j = g.bf_j.cpu().numpy()
    for f in range(bf_J.shape[0]):
        i, j = int(bf_i[f]), int(bf_j[f])
        Jf = np.zeros((6, D))
        Jf[:, 6 * i:6 * i + 6] += bf_J[f, :, 0:6]
        Jf[:, 6 * j:6 * j + 6] += bf_J[f, :, 6:12]
        H += Jf.T @ Jf
    up_J = lin.up_J.detach().cpu().numpy().astype(np.float64)
    up_k = g.up_k.cpu().numpy()
    for u in range(up_J.shape[0]):
        k = int(up_k[u])
        Ju = np.zeros((3, D))
        Ju[:, 6 * k:6 * k + 6] = up_J[u]
        H += Ju.T @ Ju
    J0 = np.zeros((6, D))
    J0[:, 0:6] = lin.pr_J.detach().cpu().numpy().astype(np.float64)
    H += J0.T @ J0
    pin = np.repeat(~g.node_valid.cpu().numpy(), 6).astype(np.float64)
    H += np.diag(pin)
    return H


def dense_marginal_covariance(g: PoseGraph, node: int):
    """Exact (6, 6) marginal covariance of `node` (float64 numpy) — the
    dense-inverse equivalent of the reference's marginalCovariance gate read
    (`mapOptimization.cpp:1437-1445`: entries (3,3)/(4,4) are the x/y
    position variances, layout [rot(3), trans(3)]). Validation-scale only;
    see `dense_information`."""
    import numpy as np

    cov = np.linalg.inv(dense_information(g))
    return cov[6 * node:6 * node + 6, 6 * node:6 * node + 6]
