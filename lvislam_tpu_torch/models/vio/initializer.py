"""Visual-inertial initialization — port of
``lvislam_tpu.models.vio.initializer`` (the estimator's bootstrap path B).

Stages, each a fixed-shape batched op:

1. `find_reference_frame`: the earliest window frame with >= 20 px mean
   parallax (30/460 in normalized units against the newest frame).
2. `global_sfm`: up-to-scale structure from motion over the window:
   alternating resection (PnP Gauss-Newton, all frames in one batch) and
   intersection (multi-view triangulation, all features in one batch), then a
   joint bundle adjustment over all camera {q, t} and points.
3. `solve_gyro_bias`: least squares over SfM-vs-preintegration rotation
   increments, then repropagation.
4. `linear_alignment`: velocities, gravity and metric scale from the
   preintegration deltas (with the scale/100 conditioning trick);
   `refine_gravity` constrains ||g|| on the 2-dof tangent basis, 4 iterations.
5. `visual_initialize`: rotate everything into the gravity-aligned world
   (yaw-zeroed via `lie.g2R`), scale positions, seed velocities and biases.

Fixed-length scans are Python loops; nothing here reads a value back to the
host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ...core import lie
from ...ops import dense
from ...ops import preintegration as pre
from ...ops import triangulate as tri
from . import feature_manager as fm


class SfmResult(NamedTuple):
    Qs: torch.Tensor  # (W+1, 4) camera rotations (world=frame l)
    Ts: torch.Tensor  # (W+1, 3) camera translations (world->cam convention R,t)
    points: torch.Tensor  # (F, 3) world points
    point_valid: torch.Tensor  # (F,)
    ok: torch.Tensor  # ()
    ref_frame: torch.Tensor  # () the l index


def _norm2(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def find_reference_frame(table: fm.FeatureTable, window: int,
                         min_parallax: float = 30.0 / 460.0):
    """Per-candidate-frame mean parallax against the newest frame. Returns
    (l, parallax_ok (W,))."""
    W = window
    both = table.obs_valid[:, :W] & table.obs_valid[:, W:W + 1] & (table.ids >= 0)[:, None]
    par = _norm2(table.obs[:, :W] - table.obs[:, W:W + 1])
    n = torch.sum(both, dim=0)
    mean_par = torch.sum(torch.where(both, par, torch.zeros_like(par)), dim=0) / torch.clamp(n, min=1)
    ok = (mean_par > min_parallax) & (n >= 20)
    l = torch.argmax(ok.to(torch.uint8))  # earliest qualifying frame
    return l, ok


def _pnp_gn(obs, valid, pts, q0, t0, iters: int = 10):
    """Pose Gauss-Newton for K frames at once: minimize the reprojection of
    known 3D points. world->cam: x_c = R x_w + t. `obs` (K, F, 2), `valid`
    (K, F), `pts` (F, 3), `q0` (K, 4), `t0` (K, 3)."""

    def residual(x, q_base, obs_k, valid_k):
        q = lie.quat_multiply(q_base, lie.so3_exp_quat(x[:3]))
        Pc = lie.quat_rotate(q[None], pts) + x[3:6][None]
        proj = Pc[..., :2] / torch.clamp(Pc[..., 2:3], min=1e-3)
        w = (valid_k & (Pc[..., 2] > 0.1))[:, None]
        r = torch.where(w, proj - obs_k, torch.zeros_like(proj)).reshape(-1)
        return r, r

    jac = vmap(jacfwd(residual, has_aux=True))  # -> (J (K, 2F, 6), r (K, 2F))
    eye6 = 1e-6 * torch.eye(6, dtype=t0.dtype, device=t0.device)
    x = torch.cat([torch.zeros_like(t0), t0], dim=-1)
    for _ in range(iters):
        J, r = jac(x, q0, obs, valid)
        Jt = J.transpose(-1, -2)
        x = x - dense.solve(Jt @ J + eye6, (Jt @ r[..., None])[..., 0])
    q = lie.quat_normalize(lie.quat_multiply(q0, lie.so3_exp_quat(x[:, :3])))
    return q, x[:, 3:6]


def _sfm_ba(Qs, Ts, X, pt_valid, obs, obs_valid, l, W, iters: int = 8):
    """Joint bundle adjustment over all camera {q, t} AND points, with the
    frame-l rotation and the l / newest translations held constant as the
    scale and gauge anchor. Damped LM with gain-ratio accept/reject;
    world->cam convention (x_c = R x_w + t)."""
    F = X.shape[0]
    W1 = W + 1
    dt_f, device = Qs.dtype, Qs.device
    obs_ok = obs_valid & pt_valid[:, None]
    k = torch.arange(W1, device=device)
    rot_free = (k != l)[:, None].to(dt_f)
    tr_free = ((k != l) & (k != W))[:, None].to(dt_f)
    pt_free = pt_valid[:, None].to(dt_f)
    D = W1 * 6 + F * 3

    def split(d):
        return (d[: W1 * 3].reshape(W1, 3) * rot_free,
                d[W1 * 3: W1 * 6].reshape(W1, 3) * tr_free,
                d[W1 * 6:].reshape(F, 3) * pt_free)

    def residual(d):
        dq, dtr, dX = split(d)
        q = lie.quat_multiply(Qs, lie.so3_exp_quat(dq))
        Pc = lie.quat_rotate(q[None, :, :], (X + dX)[:, None, :]) + (Ts + dtr)[None]
        # clamp-only depth handling: a point pushed to or behind the image
        # plane projects with a huge residual instead of being masked out (a
        # state-dependent mask would let LM "win" by hiding points)
        proj = Pc[..., :2] / torch.clamp(Pc[..., 2:3], min=1e-2)
        r = torch.where(obs_ok[..., None], proj - obs, torch.zeros_like(proj)).reshape(-1)
        return r, r

    def cost(d):
        r = residual(d)[0]
        return torch.sum(r * r)

    jac = jacfwd(residual, has_aux=True)
    d0 = torch.zeros(D, dtype=dt_f, device=device)
    lam = torch.as_tensor(1e-3, dtype=dt_f, device=device)
    c0 = cost(d0)
    for _ in range(iters):
        J, r = jac(d0)
        diag = torch.sum(J * J, dim=0)
        g = J.T @ (-r)
        H = J.T @ J + lam * torch.diag(diag + 1e-8)
        step = dense.solve(H, g)
        d1 = d0 + step
        c1 = cost(d1)
        # gain-ratio acceptance: the predicted reduction of the damped
        # quadratic model. Low-parallax points have near-null ray directions;
        # a plain c1 < c0 test lets LM ride them with enormous steps for
        # noise-level gains.
        pred = torch.dot(step, lam * (diag + 1e-8) * step + g)
        rho = (c0 - c1) / torch.clamp(pred, min=1e-12)
        acc = (c1 < c0) & (rho > 1e-2)
        d0 = torch.where(acc, d1, d0)
        lam = torch.where(acc, torch.clamp(lam / 3.0, min=1e-5), lam * 10.0)
        c0 = torch.where(acc, c1, c0)
    dq, dtr, dX = split(d0)
    Qs2 = lie.quat_normalize(lie.quat_multiply(Qs, lie.so3_exp_quat(dq)))
    return Qs2, Ts + dtr, X + dX, c0


def global_sfm(table: fm.FeatureTable, window: int, rounds: int = 4, ba_iters: int = 8,
               sampler=None) -> SfmResult:
    """Alternating resection / intersection SfM in the frame-l camera world,
    finished by a joint window BA over all {q, t} + points. `sampler` makes
    the relative pose's RANSAC draws (``ops.triangulate.relative_pose``)."""
    W = window
    dtype, device = table.obs.dtype, table.obs.device
    l, par_ok = find_reference_frame(table, window)
    sfm_ok = torch.any(par_ok)

    feat_ok = table.ids >= 0
    obs_l = fm.column(table.obs, l)
    seen_l = fm.column(table.obs_valid, l)
    obs_n = table.obs[:, W]
    seen_n = table.obs_valid[:, W]

    rel = tri.relative_pose(obs_l, obs_n, feat_ok & seen_l & seen_n, sampler=sampler)
    q_rel = lie.matrix_to_quat(rel.R)

    # initial poses: frame l = identity; newest = (R, t); others start at l
    q_id = lie.quat_identity(dtype, device)
    z3 = torch.zeros(3, dtype=dtype, device=device)
    Qs = torch.cat([q_id.repeat(W, 1), q_rel[None]], dim=0)
    Ts = torch.cat([torch.zeros((W, 3), dtype=dtype, device=device), rel.t[None]], dim=0)

    # initial structure from l <-> newest
    P0 = torch.eye(3, 4, dtype=dtype, device=device)
    P1 = torch.cat([rel.R, rel.t[:, None]], dim=1)
    X0 = tri.triangulate_two_view(P0, P1, obs_l, obs_n)
    pt_valid = feat_ok & seen_l & seen_n & (X0[..., 2] > 0.1)
    X = torch.where(pt_valid[:, None], X0, torch.zeros_like(X0))

    is_l = (torch.arange(W + 1, device=device) == l)[:, None]
    obs_kf = table.obs.transpose(0, 1)  # (K, F, 2)
    valid_kf = table.obs_valid.transpose(0, 1)
    seen = table.obs_valid & feat_ok[:, None]
    nview = torch.sum(seen, dim=1)
    for _ in range(rounds):
        # resection: every frame PnP against current structure
        qs, ts = _pnp_gn(obs_kf, valid_kf & pt_valid[None, :], X, Qs, Ts)
        # keep frame l pinned at identity (gauge)
        qs = torch.where(is_l, q_id, qs)
        ts = torch.where(is_l, z3, ts)

        # intersection: multi-view triangulation of every feature
        Rs = lie.quat_to_matrix(qs)
        Xn, _ = tri.triangulate_multiview(Rs[None], ts[None], table.obs, seen)
        # cheirality in the anchor frame l
        Rl = torch.index_select(Rs, 0, l.reshape(1))[0]
        tl = torch.index_select(ts, 0, l.reshape(1))[0]
        Xl = Xn @ Rl.T + tl[None]
        good = feat_ok & (nview >= 2) & (Xl[:, 2] > 0.1) & torch.all(torch.isfinite(Xn), dim=1)
        Qs, Ts, pt_valid = qs, ts, good
        X = torch.where(good[:, None], Xn, torch.zeros_like(Xn))
    # final joint BA over all {q, t} + points
    if ba_iters > 0:
        Qs, Ts, X, _ = _sfm_ba(Qs, Ts, X, pt_valid, table.obs, seen, l, W, iters=ba_iters)
        # re-check cheirality in the anchor frame after the BA moved structure
        Rl = lie.quat_to_matrix(torch.index_select(Qs, 0, l.reshape(1))[0])
        Xl = X @ Rl.T + torch.index_select(Ts, 0, l.reshape(1))
        pt_valid = pt_valid & (Xl[:, 2] > 0.1) & torch.all(torch.isfinite(X), dim=1)
        X = torch.where(pt_valid[:, None], X, torch.zeros_like(X))
    ok = sfm_ok & rel.ok & (torch.sum(pt_valid) > 20)
    return SfmResult(Qs=Qs, Ts=Ts, points=X, point_valid=pt_valid, ok=ok, ref_frame=l)


# ---------------------------------------------------------------------------
# Visual-IMU alignment
# ---------------------------------------------------------------------------

def solve_gyro_bias(q_cam: torch.Tensor, pints: pre.PreintState, qic: torch.Tensor,
                    window: int) -> torch.Tensor:
    """LS gyro bias from rotation increments: for each pair,
    J^T J dbg = J^T 2*vec(q_preint^-1 * q_ij)."""
    # body rotations from camera SfM rotations: q_wb = q_wc * qic^-1
    q_wb = lie.quat_multiply(q_cam, lie.quat_conjugate(qic)[None])
    q_ij = lie.quat_multiply(lie.quat_conjugate(q_wb[:-1]), q_wb[1:])
    J = pints.jacobian[:, pre.O_R: pre.O_R + 3, pre.O_BG: pre.O_BG + 3]
    r = 2.0 * lie.quat_multiply(lie.quat_conjugate(pints.delta_q), q_ij)[:, 1:4]
    Jt = J.transpose(-1, -2)
    A = torch.sum(Jt @ J, dim=0) + 1e-8 * torch.eye(3, dtype=J.dtype, device=J.device)
    b = torch.sum((Jt @ r[..., None])[..., 0], dim=0)
    return dense.solve(A, b)


def _alignment_rows(Ps_cam, Qs_body, pints, tic, W: int, g_cols: torch.Tensor, n_g: int):
    """The (6W, n_state) system shared by `linear_alignment` and
    `refine_gravity`: state [v_0..v_W (3 each), gravity block (n_g columns),
    s]. `g_cols` (W, 3, n_g) multiplies the gravity block: Riᵀ, or Riᵀ times
    the tangent basis. Built for all k at once."""
    dtype, device = Ps_cam.dtype, Ps_cam.device
    n_state = (W + 1) * 3 + n_g + 1
    dt = pints.sum_dt[:, None, None]
    Ri = lie.quat_to_matrix(Qs_body[:-1])
    Rj = lie.quat_to_matrix(Qs_body[1:])
    RiT = Ri.transpose(-1, -2)
    eye = torch.eye(3, dtype=dtype, device=device).expand(W, 3, 3)
    # velocity columns: block k of row-block k holds `own`, block k+1 `nxt`
    onehot_k = torch.eye(W, W + 1, dtype=dtype, device=device)  # (W, W+1)
    onehot_k1 = torch.roll(onehot_k, 1, dims=1)

    def vel_cols(own, nxt):
        blocks = (onehot_k[:, None, :, None] * own[:, :, None, :]
                  + onehot_k1[:, None, :, None] * nxt[:, :, None, :])
        return blocks.reshape(W, 3, (W + 1) * 3)

    dp_cam = (RiT @ (Ps_cam[1:] - Ps_cam[:-1])[..., None]) / 100.0  # (W, 3, 1)
    zero = torch.zeros_like(eye)
    Ap = torch.cat([vel_cols(-dt * eye, zero), g_cols * dt * dt / 2.0, dp_cam], dim=-1)
    Av = torch.cat([vel_cols(-eye, RiT @ Rj), g_cols * dt, torch.zeros_like(dp_cam)], dim=-1)
    A = torch.cat([Ap, Av], dim=1).reshape(-1, n_state)
    bp = pints.delta_p + (RiT @ Rj @ tic) - tic
    bv = pints.delta_v
    return A, bp, bv, RiT, n_state


def _solve_alignment(A, b, n_state):
    H = A.T @ A * 1000.0 + 1e-8 * torch.eye(n_state, dtype=A.dtype, device=A.device)
    return dense.solve(H, A.T @ b * 1000.0)


def linear_alignment(
    Ps_cam: torch.Tensor,  # (W+1, 3) camera positions in the SfM frame (c0)
    Qs_body: torch.Tensor,  # (W+1, 4) body orientations in c0
    pints: pre.PreintState,
    tic: torch.Tensor,
    window: int,
    g_norm: float,
):
    """Velocities + gravity + scale. State x = [v_0..v_W (3 each), g(3),
    s(1)]; returns (x, s, g, ok)."""
    W = window
    RiT = lie.quat_to_matrix(Qs_body[:-1]).transpose(-1, -2)
    A, bp, bv, _, n_state = _alignment_rows(Ps_cam, Qs_body, pints, tic, W, RiT, 3)
    b = torch.cat([bp, bv], dim=1).reshape(-1)
    x = _solve_alignment(A, b, n_state)
    s = x[-1] / 100.0
    g = x[3 * (W + 1): 3 * (W + 1) + 3]
    ok = (s > 0.0) & (torch.abs(lie.norm3(g) - g_norm) < 1.0)
    return x, s, g, ok


def refine_gravity(Ps_cam, Qs_body, pints, tic, window: int, g_norm: float,
                   g0: torch.Tensor, iters: int = 4):
    """Tangent-basis gravity refinement: g = g_norm*ĝ + w1 b1 + w2 b2.
    Returns (g, x, s)."""
    W = window
    dtype, device = g0.dtype, g0.device
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=device)

    def basis(g):
        a = g / lie.norm3(g)
        tmp = torch.where(torch.abs(a[2]) > 0.9, ex, ez)
        b = tmp - a * torch.dot(a, tmp)
        b = b / lie.norm3(b)
        return torch.stack([b, lie.cross(a, b)], dim=1)  # (3, 2)

    RiT = lie.quat_to_matrix(Qs_body[:-1]).transpose(-1, -2)
    dt = pints.sum_dt[:, None]
    g, x = g0, None
    for _ in range(iters):
        lxly = basis(g)
        gdir = g / lie.norm3(g) * g_norm
        A, bp, bv, _, n_state = _alignment_rows(Ps_cam, Qs_body, pints, tic, W, RiT @ lxly, 2)
        Rg = RiT @ gdir  # (W, 3)
        b = torch.cat([bp - Rg * dt * dt / 2.0, bv - Rg * dt], dim=1).reshape(-1)
        x = _solve_alignment(A, b, n_state)
        g = gdir + lxly @ x[3 * (W + 1): 3 * (W + 1) + 2]
    return g, x, x[-1] / 100.0


def visual_initialize(
    table: fm.FeatureTable,
    pints: pre.PreintState,
    imu_bufs: tuple,  # (dts (W, M), accs, gyrs) raw buffers for repropagation
    tic: torch.Tensor,
    qic: torch.Tensor,
    window: int,
    g_norm: float,
    noise: pre.ImuNoise,
    sampler=None,
):
    """The full visual bootstrap: SfM -> gyro bias -> repropagate -> linear
    alignment -> gravity refinement -> rotate and scale the window into the
    gravity-aligned (yaw-zeroed) world.

    Returns (Ps, Qs, Vs, Bgs, pints, ok): body states for frames 0..W with
    frame-0 position at the origin."""
    W = window
    sfm = global_sfm(table, W, sampler=sampler)

    # camera poses in the SfM (frame-l) world: x_c = R x_w + t
    Rwc = lie.quat_to_matrix(sfm.Qs).transpose(-1, -2)  # cam->world
    q_wc = lie.matrix_to_quat(Rwc)
    p_c = -(Rwc @ sfm.Ts[..., None])[..., 0]  # camera centers

    # body orientations and gyro bias
    bg = solve_gyro_bias(q_wc, pints, qic, W)

    d, a, g_ = imu_bufs
    fresh = pre.preint_init(a[:, 0], g_[:, 0], torch.zeros_like(bg), bg, bg.dtype)
    pints2 = pre.preintegrate(fresh, d, a, g_, noise)  # W windows, one loop

    q_wb = lie.quat_multiply(q_wc, lie.quat_conjugate(qic)[None])
    x, s, g0, lin_ok = linear_alignment(p_c, q_wb, pints2, tic, W, g_norm)
    g_ref, x2, s2 = refine_gravity(p_c, q_wb, pints2, tic, W, g_norm, g0)

    # rotate the SfM world so the estimated gravity direction maps to +z with
    # zero yaw
    R0 = lie.g2R(g_ref)
    q0 = lie.matrix_to_quat(R0)

    # body positions: p_b = s·p_cam - R_wb·tic, then shift frame 0 to origin
    Rb = lie.quat_to_matrix(q_wb)
    p_b = s2 * p_c - Rb @ tic
    p_b = p_b - p_b[0:1]
    # velocities: x2 layout [v_0..v_W (body-frame), dg(2), s]
    v_body = x2[: (W + 1) * 3].reshape(W + 1, 3)
    v_w = (Rb @ v_body[..., None])[..., 0]

    Ps = p_b @ R0.T
    Vs = v_w @ R0.T
    Qs = lie.quat_normalize(lie.quat_multiply(q0[None], q_wb))
    Bgs = bg[None].repeat(W + 1, 1)

    ok = sfm.ok & lin_ok & (s2 > 0.01)
    return Ps, Qs, Vs, Bgs, pints2, ok
