"""Scan-to-map LOAM registration — port of ``lvislam_tpu.ops.scan2map``:
Gauss-Newton over the pose [roll, pitch, yaw, tx, ty, tz] with point-to-line
(corner) and point-to-plane (surf) costs against the voxel-hash gated 5-NN
(``scan_to_map_hashed``) or the brute-force exact 5-NN (``scan_to_map``).

The JAX ``lax.while_loop`` becomes a host-synced Python loop: one
device-to-host read of the convergence flag per iteration
(``core.hostsync``). Flags mirror the JAX entry point:

- ``use_pallas``: the query tail runs through kernel K1 (``ops.knn_tail``);
- ``gather_once`` (needs ``use_pallas``): gather each query's 27-cell
  neighbourhood once at the initial pose and re-score it through K1 on the
  refresh schedule, one launch for both classes;
- ``use_pallas_gn``: coefficients + normal equations of both classes through
  one launch of kernel K2 (``ops.gn_partials``) per iteration.

On CPU tensors the kernels' plain versions run, so every combination is
testable here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import hostsync, lie
from . import gn_partials as gnp
from . import smallmat
from . import voxel_hash as vh

_BIG = 1e10


def knn(query, query_valid, ref, ref_valid, k: int = 5, chunk: int = 8192,
        block_elems: int = 1 << 25):
    """Exact k-NN against the full reference set via the expanded squared
    distance |q|² + |r|² - 2 q·r; ties to the lowest index. Returns
    (idx (Q,k), sqdist (Q,k)). Invalid reference points sit at +_BIG.

    The query dimension runs in blocks of at most `block_elems` distances,
    as the JAX function does; rows are independent, so the blocking changes
    no value. `chunk` is accepted for the JAX signature and unused."""
    r_sq = torch.sum(ref * ref, dim=-1)
    r_sq = torch.where(ref_valid, r_sq, torch.full_like(r_sq, _BIG))
    qb = max(1, min(query.shape[0], block_elems // max(ref.shape[0], 1)))
    idx, dist = [], []
    for q in torch.split(query, qb):
        d = torch.sum(q * q, dim=-1, keepdim=True) + r_sq[None, :] - 2.0 * (q @ ref.T)
        if k == 1:
            i = torch.argmin(d, dim=1, keepdim=True)  # first minimum
            idx.append(i)
            dist.append(torch.gather(d, 1, i))
        else:
            srt = torch.sort(d, dim=1, stable=True)
            idx.append(srt.indices[:, :k])
            dist.append(srt.values[:, :k])
    return torch.cat(idx), torch.clamp(torch.cat(dist), min=0.0)


class Coeffs(NamedTuple):
    normal: torch.Tensor  # (N, 3) s·n
    offset: torch.Tensor  # (N,) s·d
    valid: torch.Tensor  # (N,)


def _mat_rows(M: torch.Tensor, pts: torch.Tensor):
    """M p for (3, 3) M and (N, 3) p, each row's sum in index order."""
    return [pts[:, 0] * M[i, 0] + pts[:, 1] * M[i, 1] + pts[:, 2] * M[i, 2]
            for i in range(3)]


def apply_pose(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor):
    """R p + t, summed in the order kernel K2 uses."""
    return torch.stack([r + t[i] for i, r in enumerate(_mat_rows(R, pts))], dim=-1)


def _nbr_sqdist(nbrs, pts_world, has):
    dv = nbrs - pts_world[:, None, :]
    d = dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1] + dv[..., 2] * dv[..., 2]
    return torch.where(has, d, torch.full_like(d, _BIG))


def _masked(ok, s, n, off):
    zero = torch.zeros_like(off)
    return Coeffs(
        normal=torch.where(ok[:, None], s[:, None] * n, torch.zeros_like(n)),
        offset=torch.where(ok, off, zero),
        valid=ok,
    )


def corner_coeffs(pts_world, pts_valid, map_pts, nn_idx, nn_sqdist) -> Coeffs:
    """Point-to-line coefficients against `map_pts` rows `nn_idx` (N, 5)
    (`mapOptimization.cpp:1025-1096`); distances are recomputed exactly from
    the gathered neighbours, nn_idx < 0 marks a missing one."""
    has = nn_idx >= 0
    return corner_coeffs_nbrs(pts_world, pts_valid,
                              map_pts[torch.clamp(nn_idx, min=0).long()], has)


def surf_coeffs(pts_world, pts_lidar, pts_valid, map_pts, nn_idx, nn_sqdist) -> Coeffs:
    """Point-to-plane coefficients against `map_pts` rows `nn_idx`
    (`mapOptimization.cpp:1098-1167`), as `corner_coeffs`."""
    has = nn_idx >= 0
    return surf_coeffs_nbrs(pts_world, pts_lidar, pts_valid,
                            map_pts[torch.clamp(nn_idx, min=0).long()], has)


def corner_coeffs_nbrs(pts_world, pts_valid, nbrs, has) -> Coeffs:
    """Point-to-line coefficients on pre-gathered neighbour coordinates
    (`mapOptimization.cpp:1025-1096`)."""
    d_exact = _nbr_sqdist(nbrs, pts_world, has)
    ok = pts_valid & (torch.amax(d_exact, dim=1) < 1.0)
    center, S = smallmat.scatter_entries(nbrs)
    cov = tuple(a / 5.0 for a in S)
    l1, l2, l3 = smallmat._eigvals_entries(*cov)
    ok = ok & (l1 > 3.0 * l2)
    u = smallmat._max_eigvec_entries(*cov, l2, l3)
    pc = pts_world - center
    cr = lie.cross(pc, u)
    d = lie.norm3(cr)
    t = smallmat._dot3(pc, u)
    foot = center + t[:, None] * u
    n = (pts_world - foot) / torch.clamp(d, min=1e-9)[:, None]
    s = 1.0 - 0.9 * torch.abs(d)
    ok = ok & (s > 0.1)
    return _masked(ok, s, n, s * d)


def surf_coeffs_nbrs(pts_world, pts_lidar, pts_valid, nbrs, has) -> Coeffs:
    """Point-to-plane coefficients on pre-gathered neighbour coordinates
    (`mapOptimization.cpp:1098-1167`)."""
    d_exact = _nbr_sqdist(nbrs, pts_world, has)
    ok = pts_valid & (torch.amax(d_exact, dim=1) < 1.0) & torch.all(has, dim=1)
    n, d0 = smallmat.plane_fit(nbrs)
    plane_err = torch.abs(
        nbrs[..., 0] * n[:, None, 0] + nbrs[..., 1] * n[:, None, 1]
        + nbrs[..., 2] * n[:, None, 2] + d0[:, None])
    ok = ok & torch.all(plane_err <= 0.2, dim=1)
    pd2 = smallmat._dot3(pts_world, n) + d0
    rng = lie.norm3(pts_lidar)
    s = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(torch.sqrt(torch.clamp(rng, min=1e-9)))
    ok = ok & (s > 0.1)
    return _masked(ok, s, n, s * pd2)


def _euler_jac_mats(x6: torch.Tensor) -> torch.Tensor:
    """d(R)/d(roll, pitch, yaw) for R = Rz(y)Ry(p)Rx(r), stacked (3, 3, 3)."""
    r, p, y = x6[0], x6[1], x6[2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    z, o = torch.zeros_like(r), torch.ones_like(r)

    def m(rows):
        return torch.stack([torch.stack(rw) for rw in rows])

    Rz = m([[cy, -sy, z], [sy, cy, z], [z, z, o]])
    Ry = m([[cp, z, sp], [z, o, z], [-sp, z, cp]])
    Rx = m([[o, z, z], [z, cr, -sr], [z, sr, cr]])
    dRz = m([[-sy, -cy, z], [cy, -sy, z], [z, z, z]])
    dRy = m([[-sp, z, cp], [z, z, z], [-cp, z, -sp]])
    dRx = m([[z, z, z], [z, -sr, -cr], [z, cr, -sr]])
    return torch.stack([Rz @ Ry @ dRx, Rz @ dRy @ Rx, dRz @ Ry @ Rx])


def gn_rows(jacs: torch.Tensor, pts: torch.Tensor, coeffs: Coeffs):
    """The ``gn_update`` rows: J (N, 6) = [n·(Ja p), n·(Jb p), n·(Jc p), n]·w
    and b = -offset·w."""
    w = coeffs.valid.to(pts.dtype)
    n = coeffs.normal
    ang = []
    for a in range(3):
        jp = _mat_rows(jacs[a], pts)
        ang.append(n[:, 0] * jp[0] + n[:, 1] * jp[1] + n[:, 2] * jp[2])
    J = torch.cat([torch.stack(ang, dim=-1), n], dim=-1)
    return J * w[:, None], -coeffs.offset * w


class GNState(NamedTuple):
    x6: torch.Tensor  # (6,)
    it: torch.Tensor  # () int32
    converged: torch.Tensor  # () bool
    degenerate: torch.Tensor  # () bool
    proj: torch.Tensor  # (6, 6)
    num_residuals: torch.Tensor  # () int32


def gn_solve(x6, H, g, n_res, iter0: bool, proj_prev, degen_prev,
             eigen_thresh: float = 100.0):
    """The solve / degeneracy / convergence half of one GN step
    (`LMOptimization`, `mapOptimization.cpp:1190-1313`)."""
    if iter0:
        ew, ev = torch.linalg.eigh(H)  # only the projector is used
        good = (ew >= eigen_thresh).to(x6.dtype)
        proj = (ev * good[None, :]) @ ev.T
        degen = torch.any(ew < eigen_thresh)
    else:
        proj, degen = proj_prev, degen_prev
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    dx = torch.linalg.solve_ex(H + 1e-6 * eye, g)[0]
    dx = torch.where(degen, proj @ dx, dx)
    enough = n_res >= 50
    dx = torch.where(enough, dx, torch.zeros_like(dx))
    new_x = x6 + dx
    deltaR = torch.sqrt(torch.sum((dx[:3] * (180.0 / math.pi)) ** 2))
    deltaT = torch.sqrt(torch.sum((dx[3:] * 100.0) ** 2))
    converged = enough & (deltaR < 0.05) & (deltaT < 0.05)
    return new_x, converged, proj, degen, n_res


def gn_update(x6, pts, coeffs: Coeffs, iter0: bool, proj_prev, degen_prev,
              eigen_thresh: float = 100.0):
    """One Gauss-Newton step from coefficient rows."""
    J, b = gn_rows(_euler_jac_mats(x6), pts, coeffs)
    H = J.T @ J
    g = J.T @ b
    n_res = torch.sum(coeffs.valid, dtype=torch.int32)
    return gn_solve(x6, H, g, n_res, iter0, proj_prev, degen_prev,
                    eigen_thresh=eigen_thresh)


def scan_to_map_hashed(
    x6_init: torch.Tensor,  # (6,) initial guess
    corner_pts: torch.Tensor,  # (C, 3) lidar frame
    corner_valid: torch.Tensor,
    surf_pts: torch.Tensor,  # (S, 3)
    surf_valid: torch.Tensor,
    map_corner: torch.Tensor,  # (Mc, 3) map arrays (coefficient gathers)
    map_surf: torch.Tensor,  # (Ms, 3)
    corner_hash: vh.VoxelHash,
    surf_hash: vh.VoxelHash,
    max_iters: int = 20,
    eigen_thresh: float = 100.0,
    nn_refresh_every: int = 1,
    use_pallas: bool = False,
    gather_once: bool = False,
    use_pallas_gn: bool = False,
) -> GNState:
    """Scan-to-map GN with the voxel-hash gated 5-NN; iterates until
    converged or `max_iters` (see the module docstring for the flags)."""
    if gather_once and not use_pallas:
        raise ValueError("gather_once requires the kernel query tail")
    q_fn = vh.query_fused if use_pallas else vh.query
    dev, dt = x6_init.device, x6_init.dtype

    if use_pallas_gn:
        c_blk = gnp.pack_pts(corner_pts, corner_valid)
        s_blk = gnp.pack_pts(surf_pts, surf_valid)
    if gather_once:
        R0 = lie.x6_rotation(x6_init)
        g_corner = vh.query_gather(corner_hash, apply_pose(R0, x6_init[3:6], corner_pts))
        g_surf = vh.query_gather(surf_hash, apply_pose(R0, x6_init[3:6], surf_pts))

    def nn_idx(cw, sw):
        if gather_once:  # one K1 launch for both classes
            (ci, _), (si, _) = vh.query_score_pair(corner_hash, g_corner, cw,
                                                    surf_hash, g_surf, sw, 5)
        else:
            ci, _ = q_fn(corner_hash, cw, 5)
            si, _ = q_fn(surf_hash, sw, 5)
        return ci, si

    def gather_nbrs(map_pts, idx):
        return map_pts[torch.clamp(idx, min=0).long()], idx >= 0

    pts_all = torch.cat([corner_pts, surf_pts])
    st = GNState(
        x6=x6_init, it=torch.zeros((), dtype=torch.int32, device=dev),
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        degenerate=torch.zeros((), dtype=torch.bool, device=dev),
        proj=torch.eye(6, dtype=dt, device=dev),
        num_residuals=torch.zeros((), dtype=torch.int32, device=dev),
    )
    nbr_c = nbr_s = None
    for it in range(max_iters):
        t = st.x6[3:6]
        Rm = lie.x6_rotation(st.x6)
        refresh = it % nn_refresh_every == 0
        if refresh or not use_pallas_gn:
            cw = apply_pose(Rm, t, corner_pts)
            sw = apply_pose(Rm, t, surf_pts)
        if refresh:
            ci, si = nn_idx(cw, sw)
            nbr_c = gather_nbrs(map_corner, ci)
            nbr_s = gather_nbrs(map_surf, si)
            if use_pallas_gn:
                cn_blk = gnp.pack_nbrs(*nbr_c)
                sn_blk = gnp.pack_nbrs(*nbr_s)
        if use_pallas_gn:
            par = gnp.pack_pose(Rm, t, _euler_jac_mats(st.x6))
            H, g, n = gnp.gn_partials_pair(c_blk, cn_blk, s_blk, sn_blk, par)
            new_x, conv, proj, degen, n_res = gn_solve(
                st.x6, H, g, n, it == 0, st.proj, st.degenerate,
                eigen_thresh=eigen_thresh)
        else:
            cc = corner_coeffs_nbrs(cw, corner_valid, *nbr_c)
            sc = surf_coeffs_nbrs(sw, surf_pts, surf_valid, *nbr_s)
            coeffs = Coeffs(*(torch.cat([a, b]) for a, b in zip(cc, sc)))
            new_x, conv, proj, degen, n_res = gn_update(
                st.x6, pts_all, coeffs, it == 0, st.proj, st.degenerate,
                eigen_thresh=eigen_thresh)
        st = GNState(x6=new_x, it=st.it + 1, converged=conv, degenerate=degen,
                     proj=proj, num_residuals=n_res.to(torch.int32))
        if hostsync.host_bool(conv):
            break
    return st


def scan_to_map(
    x6_init: torch.Tensor,  # (6,) initial guess [r, p, y, tx, ty, tz]
    corner_pts: torch.Tensor,  # (C, 3) scan edge features (lidar frame)
    corner_valid: torch.Tensor,
    surf_pts: torch.Tensor,  # (S, 3)
    surf_valid: torch.Tensor,
    map_corner: torch.Tensor,  # (Mc, 3)
    map_corner_valid: torch.Tensor,
    map_surf: torch.Tensor,  # (Ms, 3)
    map_surf_valid: torch.Tensor,
    max_iters: int = 20,
    eigen_thresh: float = 100.0,
) -> GNState:
    """Full scan-to-map optimization with the brute-force exact 5-NN
    (`scan2MapOptimization`, `mapOptimization.cpp:1315-1343`): iterate the
    correspondence search and a weighted GN step until converged or
    `max_iters`, one host read of the convergence flag an iteration."""
    dev, dt = x6_init.device, x6_init.dtype
    st = GNState(
        x6=x6_init, it=torch.zeros((), dtype=torch.int32, device=dev),
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        degenerate=torch.zeros((), dtype=torch.bool, device=dev),
        proj=torch.eye(6, dtype=dt, device=dev),
        num_residuals=torch.zeros((), dtype=torch.int32, device=dev),
    )
    pts = torch.cat([corner_pts, surf_pts])
    for it in range(max_iters):
        Rm = lie.x6_rotation(st.x6)
        t = st.x6[3:6]
        cw = corner_pts @ Rm.T + t
        sw = surf_pts @ Rm.T + t
        ci, cd = knn(cw, corner_valid, map_corner, map_corner_valid, 5)
        si, sd = knn(sw, surf_valid, map_surf, map_surf_valid, 5)
        cc = corner_coeffs(cw, corner_valid, map_corner, ci, cd)
        sc = surf_coeffs(sw, surf_pts, surf_valid, map_surf, si, sd)
        coeffs = Coeffs(*(torch.cat([a, b]) for a, b in zip(cc, sc)))
        new_x, conv, proj, degen, n_res = gn_update(
            st.x6, pts, coeffs, it == 0, st.proj, st.degenerate, eigen_thresh=eigen_thresh)
        st = GNState(x6=new_x, it=st.it + 1, converged=conv, degenerate=degen,
                     proj=proj, num_residuals=n_res.to(torch.int32))
        if hostsync.host_bool(conv):
            break
    return st
