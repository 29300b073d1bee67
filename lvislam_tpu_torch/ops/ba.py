"""Sliding-window visual-inertial bundle adjustment + QR marginalization —
port of ``lvislam_tpu.ops.ba``.

- parameter blocks = (W+1) poses + (W+1) speed/bias + extrinsic + td +
  per-feature inverse depths, flattened into one tangent vector
  delta = [frames(15 each) | extr(6) | td(1) | depths(F)];
- residual blocks = marginalization prior (linear FEJ replay), W whitened IMU
  preintegration factors (``ops.preintegration.evaluate``) and all projection
  factors with td compensation, sqrt_info = FOCAL_LENGTH/1.5; lidar-depth
  features held constant;
- the solver is damped Gauss-Newton (Levenberg-Marquardt accept/reject) with
  three linear solvers: "qr" (augmented QR, square-root form), "cholesky"
  (Jacobi-equilibrated normal equations) and "schur" (cholesky plus analytic
  elimination of the inverse depths);
- marginalization is QR elimination (SRIF): stack the factors touching the
  dropped states, order columns [dropped | kept], one QR; the trailing
  triangle is the new prior with first-estimate Jacobians.

Jacobians are forward-mode (``torch.func.jacfwd`` / ``jvp``), so everything
inside a residual is functional and mask-based. The LM loop is a Python loop
with one host read per iteration (the convergence flag), through
``core.hostsync``; the accept/reject stays ``torch.where``. Everything is
fixed-shape: invalid frames and features carry zero weights.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import jacfwd, jvp

from ..core import lie
from ..core.device import resolve as resolve_device
from ..core.hostsync import host_bool
from . import dense
from . import preintegration as pre


@dataclasses.dataclass(frozen=True)
class BAConfig:
    window: int = 10
    max_features: int = 512
    focal: float = 460.0  # FOCAL_LENGTH for sqrt_info
    iterations: int = 8
    damping: float = 1e-5
    estimate_td: bool = True
    estimate_extrinsic: bool = False
    cauchy_c: float = 1.0  # CauchyLoss(1.0) on projection factors
    # "qr": augmented-QR LM step (numerically safest). "cholesky": damped
    # normal equations with Jacobi column equilibration. "schur": cholesky
    # plus analytic elimination of the inverse depths: each depth column hits
    # only its own feature's projection rows, so the whole depth Jacobian
    # block is ONE jvp and the dense solve shrinks from d_total to d_state.
    solver: str = "qr"
    # early termination: stop once an ACCEPTED step improves the cost by less
    # than ftol*cost (Ceres' function_tolerance). 0.0 disables it.
    ftol: float = 1e-6

    @property
    def d_state(self) -> int:
        return (self.window + 1) * 15 + 6 + 1

    @property
    def d_total(self) -> int:
        return self.d_state + self.max_features


class WindowState(NamedTuple):
    """The estimator's window variables."""

    Ps: torch.Tensor  # (W+1, 3)
    Qs: torch.Tensor  # (W+1, 4)
    Vs: torch.Tensor  # (W+1, 3)
    Bas: torch.Tensor  # (W+1, 3)
    Bgs: torch.Tensor  # (W+1, 3)
    tic: torch.Tensor  # (3,)
    qic: torch.Tensor  # (4,)
    td: torch.Tensor  # ()


class Prior(NamedTuple):
    """Linear FEJ prior: r(x) = r0 + J0 @ (x [-] x_bar), where x_bar is the
    linearization (first-estimate) point."""

    J: torch.Tensor  # (Dp, d_state)
    r: torch.Tensor  # (Dp,)
    ws_bar: WindowState  # linearization point


def _zero_ws(cfg: BAConfig, dtype, device) -> WindowState:
    W1 = cfg.window + 1
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    q1 = lie.quat_identity(dtype, device)
    return WindowState(Ps=z(W1, 3), Qs=q1.repeat(W1, 1), Vs=z(W1, 3), Bas=z(W1, 3),
                       Bgs=z(W1, 3), tic=z(3), qic=q1, td=z())


def empty_prior(cfg: BAConfig, dtype=torch.float32, device=None) -> Prior:
    """The all-zero prior on `device` (the card unless named)."""
    device = resolve_device(device)
    return Prior(
        J=torch.zeros((cfg.d_state, cfg.d_state), dtype=dtype, device=device),
        r=torch.zeros(cfg.d_state, dtype=dtype, device=device),
        ws_bar=_zero_ws(cfg, dtype, device),
    )


def _qdiff(q_bar, q):
    return lie.quat_log(lie.quat_multiply(lie.quat_conjugate(q_bar), q))


def state_minus(ws: WindowState, ws_bar: WindowState, cfg: BAConfig) -> torch.Tensor:
    """Tangent difference x [-] x_bar in the delta layout."""
    frames = torch.cat(
        [ws.Ps - ws_bar.Ps, _qdiff(ws_bar.Qs, ws.Qs), ws.Vs - ws_bar.Vs,
         ws.Bas - ws_bar.Bas, ws.Bgs - ws_bar.Bgs], dim=-1
    ).reshape(-1)
    dex = torch.cat([ws.tic - ws_bar.tic, _qdiff(ws_bar.qic, ws.qic)])
    return torch.cat([frames, dex, (ws.td - ws_bar.td)[None]])


def _retract_window(ws: WindowState, d_state: torch.Tensor, cfg: BAConfig) -> WindowState:
    W1 = cfg.window + 1
    dd = d_state[: W1 * 15].reshape(W1, 15)
    ex = d_state[W1 * 15: W1 * 15 + 6]
    ext_on = 1.0 if cfg.estimate_extrinsic else 0.0
    return WindowState(
        Ps=ws.Ps + dd[:, 0:3],
        Qs=lie.quat_multiply(ws.Qs, lie.so3_exp_quat(dd[:, 3:6])),
        Vs=ws.Vs + dd[:, 6:9],
        Bas=ws.Bas + dd[:, 9:12],
        Bgs=ws.Bgs + dd[:, 12:15],
        tic=ws.tic + ex[0:3] * ext_on,
        qic=lie.quat_multiply(ws.qic, lie.so3_exp_quat(ex[3:6] * ext_on)),
        # scaled as a 1-vector, then indexed: under torch.func a () tensor times
        # a Python float comes out float64
        td=ws.td + (d_state[W1 * 15 + 6: W1 * 15 + 7] * (1.0 if cfg.estimate_td else 0.0))[0],
    )


def projection_residuals(
    ws: WindowState,
    inv_depth: torch.Tensor,  # (F,)
    obs: torch.Tensor,  # (F, W+1, 2)
    vel: torch.Tensor,  # (F, W+1, 2)
    obs_valid: torch.Tensor,  # (F, W+1)
    start_frame: torch.Tensor,  # (F,)
    feat_valid: torch.Tensor,  # (F,)
    td0: torch.Tensor,  # () td at feature observation time
    cfg: BAConfig,
    rt: torch.Tensor | None = None,  # (F, W+1) rolling-shutter row times (s)
):
    """(F, W+1, 2) whitened projection residuals + mask: the observation in
    frame i un-projected by inverse depth, moved through the body+extrinsic
    chain into frame j, compared on the image plane; td shifts both
    observations along their velocities, plus the per-observation
    rolling-shutter row-readout time."""
    F, W1, _ = obs.shape
    dt_td = ws.td - td0

    # td- and row-time-corrected observations
    shift = dt_td if rt is None else dt_td + rt[..., None]
    obs_c = obs - vel * shift

    sf = torch.clamp(start_frame, 0, W1 - 1).long()
    obs_i = torch.take_along_dim(obs_c, sf[:, None, None], dim=1)[:, 0]
    depth = 1.0 / torch.clamp(inv_depth, min=1e-6)
    pts_cam_i = torch.cat([obs_i, torch.ones_like(obs_i[:, :1])], dim=-1) * depth[:, None]

    # camera i -> world
    pts_imu_i = lie.quat_rotate(ws.qic[None], pts_cam_i) + ws.tic[None]
    pts_w = lie.quat_rotate(ws.Qs[sf], pts_imu_i) + ws.Ps[sf]

    # world -> camera j for all frames: (F, W1, 3)
    pts_imu_j = lie.quat_rotate(lie.quat_conjugate(ws.Qs)[None], pts_w[:, None] - ws.Ps[None])
    pts_cam_j = lie.quat_rotate(lie.quat_conjugate(ws.qic)[None, None], pts_imu_j - ws.tic)
    zj = pts_cam_j[..., 2]
    proj = pts_cam_j[..., :2] / torch.clamp(zj, min=1e-3)[..., None]
    r = proj - obs_c

    anchor_ok = torch.take_along_dim(obs_valid, sf[:, None], dim=1)[:, 0]
    mask = (
        obs_valid
        & feat_valid[:, None]
        & anchor_ok[:, None]
        & (inv_depth > 0)[:, None]
        & (torch.arange(W1, device=obs.device)[None, :] != start_frame[:, None])
    )
    sqrt_info = cfg.focal / 1.5
    r = torch.where(mask[..., None], r * sqrt_info, torch.zeros_like(r))
    return r, mask


def imu_whiteners(pints: pre.PreintState, dtype=torch.float32) -> torch.Tensor:
    """(W, 15, 15) inverse Cholesky factors of the preintegration
    covariances. State-independent: hoisted out of the LM iteration so
    neither the repeated cost evaluations nor the Jacobian tangents go
    through a batched 15x15 cholesky + triangular solve."""
    eye = torch.eye(15, dtype=dtype, device=pints.covariance.device)
    L = dense.cholesky(pints.covariance + 1e-10 * eye)
    return dense.solve_triangular(L, eye.expand(L.shape), lower=True)


def imu_residuals(ws: WindowState, pints: pre.PreintState, frame_valid: torch.Tensor,
                  gravity: torch.Tensor, cfg: BAConfig,
                  whiten: torch.Tensor | None = None) -> torch.Tensor:
    """(W, 15) whitened IMU residuals between consecutive frames. `whiten`:
    optional precomputed `imu_whiteners` (applied as a matmul; identical to
    the triangular solve up to rounding)."""
    r = pre.evaluate(
        pints,
        ws.Ps[:-1], ws.Qs[:-1], ws.Vs[:-1], ws.Bas[:-1], ws.Bgs[:-1],
        ws.Ps[1:], ws.Qs[1:], ws.Vs[1:], ws.Bas[1:], ws.Bgs[1:],
        gravity,
    )
    if whiten is not None:
        rs = (whiten @ r[..., None])[..., 0]
    else:
        eye = torch.eye(15, dtype=r.dtype, device=r.device)
        L = dense.cholesky(pints.covariance + 1e-10 * eye)
        rs = dense.solve_triangular(L, r, lower=True)
    ok = frame_valid[1:, None] & frame_valid[:-1, None]
    return torch.where(ok, rs, torch.zeros_like(rs))


def robust_weights(r_proj: torch.Tensor, mask: torch.Tensor, c: float) -> torch.Tensor:
    """IRLS weights for the Cauchy loss rho(s) = c^2 log(1 + s/c^2):
    w = sqrt(rho'(s)) = 1/sqrt(1 + s/c^2), per observation (F, W+1)."""
    s = torch.sum(r_proj * r_proj, dim=-1)
    w = torch.rsqrt(1.0 + s / (c * c))
    return torch.where(mask, w, torch.ones_like(w))


def full_residual(
    delta: torch.Tensor,
    ws: WindowState,
    inv_depth0: torch.Tensor,
    table_obs, table_vel, table_obs_valid, table_start, feat_valid, lidar_flag,
    pints: pre.PreintState,
    frame_valid: torch.Tensor,
    prior: Prior,
    gravity: torch.Tensor,
    td0: torch.Tensor,
    cfg: BAConfig,
    proj_weights: torch.Tensor | None = None,
    table_rt: torch.Tensor | None = None,
    imu_whiten: torch.Tensor | None = None,
) -> torch.Tensor:
    d_state = delta[: cfg.d_state]
    d_depth = delta[cfg.d_state:]
    ws2 = _retract_window(ws, d_state, cfg)
    # lidar-depth features constant
    inv_depth = inv_depth0 + torch.where(lidar_flag, torch.zeros_like(d_depth), d_depth)

    r_prior = prior.r + prior.J @ state_minus(ws2, prior.ws_bar, cfg)
    r_imu = imu_residuals(
        ws2, pints, frame_valid, gravity, cfg, whiten=imu_whiten
    ).reshape(-1)
    r_proj, _ = projection_residuals(
        ws2, inv_depth, table_obs, table_vel, table_obs_valid,
        table_start, feat_valid, td0, cfg, rt=table_rt,
    )
    if proj_weights is not None:
        r_proj = r_proj * proj_weights[..., None]
    return torch.cat([r_prior, r_imu, r_proj.reshape(-1)])


def _select(accept: torch.Tensor, new, old):
    """`new` where `accept` else `old`, over a tensor or a NamedTuple of
    tensors."""
    if isinstance(new, torch.Tensor):
        return torch.where(accept, new, old)
    return type(new)(*(_select(accept, a, b) for a, b in zip(new, old)))


def _lm_accept(ws, ws2, inv_depth, inv2, lam, cost, w_proj, eval_cost, cfg):
    """Shared LM accept/reject tail for every solver branch: evaluate the
    candidate, keep it iff the cost decreases, scale the damping, and flag
    convergence (an ACCEPTED step improving the cost by < ftol*cost)."""
    new_cost, w_new = eval_cost(ws2, inv2)
    accept = new_cost < cost
    done = accept & ((cost - new_cost) < cfg.ftol * cost)
    return (
        _select(accept, ws2, ws),
        torch.where(accept, inv2, inv_depth),
        torch.where(accept, torch.clamp(lam / 3.0, min=1e-7), lam * 10.0),
        torch.where(accept, new_cost, cost),
        torch.where(accept, w_new, w_proj),
        done,
    )


def _with_aux(fn):
    def wrapped(d):
        r = fn(d)
        return r, r
    return wrapped


class BAResult(NamedTuple):
    ws: WindowState
    inv_depth: torch.Tensor
    final_cost: torch.Tensor
    iterations: int  # LM steps taken (host value)


def solve(
    ws: WindowState,
    inv_depth: torch.Tensor,
    table_obs, table_vel, table_obs_valid, table_start, feat_valid, lidar_flag,
    pints: pre.PreintState,
    frame_valid: torch.Tensor,
    prior: Prior,
    gravity: torch.Tensor,
    td0: torch.Tensor,
    cfg: BAConfig,
    table_rt: torch.Tensor | None = None,
) -> BAResult:
    """Damped Gauss-Newton (adaptive Levenberg-Marquardt: reject
    cost-increasing steps, scale the damping) with the configured solver."""
    if cfg.solver not in ("qr", "cholesky", "schur"):
        raise ValueError(f"unknown BA solver {cfg.solver!r}")
    dt, device = ws.Ps.dtype, ws.Ps.device
    D, S, Fn = cfg.d_total, cfg.d_state, cfg.max_features
    W1 = cfg.window + 1
    zeros = lambda n: torch.zeros(n, dtype=dt, device=device)
    Linv_imu = imu_whiteners(pints, dtype=dt)
    frozen = lidar_flag | (~feat_valid)

    def eval_cost(ws_, inv_):
        # one projection sweep serves both the robust weights and the cost
        r0_proj, pmask = projection_residuals(
            ws_, inv_, table_obs, table_vel, table_obs_valid,
            table_start, feat_valid, td0, cfg, rt=table_rt,
        )
        w = robust_weights(r0_proj, pmask, cfg.cauchy_c)
        r_prior = prior.r + prior.J @ state_minus(ws_, prior.ws_bar, cfg)
        r_imu = imu_residuals(ws_, pints, frame_valid, gravity, cfg, whiten=Linv_imu).reshape(-1)
        r = torch.cat([r_prior, r_imu, (r0_proj * w[..., None]).reshape(-1)])
        return torch.sum(r * r), w

    def step(ws, inv_depth, lam, w_proj):
        """The LM step d (d_total,) at the incoming state. The robust weights
        at that state are what the previous accept/reject evaluation already
        computed."""

        def res(d):
            return full_residual(
                d, ws, inv_depth, table_obs, table_vel, table_obs_valid,
                table_start, feat_valid, lidar_flag, pints, frame_valid,
                prior, gravity, td0, cfg, proj_weights=w_proj,
                table_rt=table_rt, imu_whiten=Linv_imu,
            )

        if cfg.solver == "schur":
            n_pre = S + cfg.window * 15  # prior + IMU rows precede proj rows
            # state-block Jacobian: S tangent passes, the residual beside it
            J_s, r = jacfwd(_with_aux(lambda d_s: res(torch.cat([d_s, zeros(Fn)]))),
                            has_aux=True)(zeros(S))
            # depth-block Jacobian: depth columns are row-disjoint (each depth
            # touches only its feature's projection rows), so J_d @ 1 recovers
            # every nonzero entry: one jvp, no F-wide jacfwd
            _, Jd_rows = jvp(lambda d_d: res(torch.cat([zeros(S), d_d])),
                             (zeros(Fn),), (torch.ones(Fn, dtype=dt, device=device),))
            Jd = Jd_rows[n_pre:].reshape(Fn, W1 * 2)
            Js_proj = J_s[n_pre:].reshape(Fn, W1 * 2, S)
            r_proj_rows = r[n_pre:].reshape(Fn, W1 * 2)

            # Jacobi equilibration of the state columns (as in "cholesky")
            s = 1.0 / (torch.linalg.vector_norm(J_s, dim=0) + 1e-6)
            Js_sc = J_s * s[None, :]
            A = Js_sc.T @ Js_sc  # (S, S)
            g_s = Js_sc.T @ (-r)
            C = torch.sum(Jd * Jd, dim=1)  # (Fn,) diagonal depth block
            B = torch.einsum("fks,fk->sf", Js_proj * s[None, None, :], Jd)
            g_d = torch.sum(Jd * (-r_proj_rows), dim=1)
            # LM damping: lam*I on the scaled state block; the depth block's
            # scaled damping is lam*C (its own column norm²), i.e. C*(1+lam)
            Cd = C * (1.0 + lam) + 1e-8
            eyeS = torch.eye(S, dtype=dt, device=device)
            Hs = A - (B / Cd[None, :]) @ B.T + (lam + 1e-7) * eyeS
            rhs = g_s - B @ (g_d / Cd)
            y = dense.cho_solve(dense.cholesky(Hs), rhs)
            return torch.cat([s * y, (g_d - B.T @ y) / Cd])

        J, r = jacfwd(_with_aux(res), has_aux=True)(zeros(D))
        col = torch.linalg.vector_norm(J, dim=0) + 1e-6
        eyeD = torch.eye(D, dtype=dt, device=device)
        if cfg.solver == "cholesky":
            # damped normal equations, Jacobi-equilibrated: with column
            # scaling S = diag(1/col), solve (S J^T J S + lam I) y = S J^T b
            s = 1.0 / col
            Js = J * s[None, :]
            H = Js.T @ Js + lam * eyeD
            y = dense.cho_solve(dense.cholesky(H + 1e-7 * eyeD), Js.T @ (-r))
            return s * y
        # LM damping rows: sqrt(lam)*diag-scale per column, augmented QR
        A = torch.cat([J, torch.sqrt(lam) * torch.diag(col)], dim=0)
        b = torch.cat([-r, zeros(D)])
        Q, R = torch.linalg.qr(A)
        return dense.solve_triangular(R + 1e-8 * eyeD, Q.T @ b, lower=False)

    cost, w_proj = eval_cost(ws, inv_depth)
    lam = torch.as_tensor(1e-4, dtype=dt, device=device)
    n_it = 0
    for i in range(cfg.iterations):
        d = step(ws, inv_depth, lam, w_proj)
        ws2 = _retract_window(ws, d[:S], cfg)
        inv2 = inv_depth + torch.where(frozen, torch.zeros_like(d[S:]), d[S:])
        ws, inv_depth, lam, cost, w_proj, done = _lm_accept(
            ws, ws2, inv_depth, inv2, lam, cost, w_proj, eval_cost, cfg)
        n_it = i + 1
        if cfg.ftol > 0.0 and n_it < cfg.iterations and host_bool(done):
            break
    return BAResult(ws=ws, inv_depth=inv_depth, final_cost=cost, iterations=n_it)


# ---------------------------------------------------------------------------
# Marginalization (SRIF / QR elimination)
# ---------------------------------------------------------------------------

def _eliminate(A: torch.Tensor, r: torch.Tensor, n_drop: int):
    """QR-eliminate the first `n_drop` columns of the stacked factors (A, r).
    A tiny prior row per dropped variable keeps the elimination well-posed
    where a dropped variable is unobserved (zero column): a singular R11
    would let kept-variable constraints leak into the discarded rows. Returns
    the trailing triangle and its right-hand side."""
    reg = torch.cat(
        [1e-3 * torch.eye(n_drop, dtype=A.dtype, device=A.device),
         torch.zeros((n_drop, A.shape[1] - n_drop), dtype=A.dtype, device=A.device)], dim=1)
    A = torch.cat([A, reg], dim=0)
    ra = torch.cat([r, torch.zeros(n_drop, dtype=A.dtype, device=A.device)])
    Q, R = torch.linalg.qr(A)
    c = Q.T @ ra
    J_new = R[n_drop:, n_drop:]
    return J_new, c[n_drop: n_drop + J_new.shape[0]]


def marginalize_old(
    ws: WindowState,
    inv_depth: torch.Tensor,
    table_obs, table_vel, table_obs_valid, table_start, feat_valid, lidar_flag,
    pints: pre.PreintState,
    frame_valid: torch.Tensor,
    prior: Prior,
    gravity: torch.Tensor,
    td0: torch.Tensor,
    cfg: BAConfig,
    table_rt: torch.Tensor | None = None,
) -> Prior:
    """MARGIN_OLD: eliminate frame 0 (and the depths of features anchored
    there) from [prior + IMU(0,1) + frame-0 projections]; returns the new
    prior over the SHIFTED window layout (old frame k+1 -> new frame k), new
    frame W unconstrained."""
    dt, device = ws.Ps.dtype, ws.Ps.device
    D, S, W = cfg.d_total, cfg.d_state, cfg.window
    anchored = feat_valid & (table_start == 0)

    # robust rescaling at the marginalization point
    r0_proj, pmask = projection_residuals(
        ws, inv_depth, table_obs, table_vel, table_obs_valid,
        table_start, anchored, td0, cfg, rt=table_rt,
    )
    w_proj = robust_weights(r0_proj, pmask, cfg.cauchy_c)

    def res(d):
        d_depth = d[S:]
        ws2 = _retract_window(ws, d[:S], cfg)
        inv2 = inv_depth + torch.where(lidar_flag, torch.zeros_like(d_depth), d_depth)
        r_prior = prior.r + prior.J @ state_minus(ws2, prior.ws_bar, cfg)
        # IMU factor 0->1 only
        r_imu = imu_residuals(ws2, pints, frame_valid, gravity, cfg)[0]
        # projections of frame-0 anchored features only
        r_proj, _ = projection_residuals(
            ws2, inv2, table_obs, table_vel, table_obs_valid,
            table_start, anchored, td0, cfg, rt=table_rt,
        )
        r_proj = r_proj * w_proj[..., None]
        return torch.cat([r_prior, r_imu, r_proj.reshape(-1)])

    J, r0 = jacfwd(_with_aux(res), has_aux=True)(torch.zeros(D, dtype=dt, device=device))

    # column order: [frame0 (15) | anchored depths (F) | kept state]; the
    # depth columns of non-anchored features are zeroed (they do not appear
    # in these factors anyway) and stay out of the output
    A = torch.cat([J[:, 0:15], J[:, S:] * anchored[None, :], J[:, 15:S]], dim=1)
    J_new, r_new = _eliminate(A, r0, 15 + cfg.max_features)

    # shift window indices: kept state was [frames 1..W | extr | td]; the
    # new layout wants [frames 0..W-1 | (free frame W zeros) | extr | td]
    d_kept = S - 15
    Jp = torch.zeros((S, S), dtype=dt, device=device)
    rp = torch.zeros(S, dtype=dt, device=device)
    Jp[:d_kept, 0: W * 15] = J_new[:, 0: W * 15]
    Jp[:d_kept, (W + 1) * 15:] = J_new[:, W * 15:]
    rp[:d_kept] = r_new
    # linearization point: the current states relabeled to the post-slide
    # layout (old frame k+1 -> new frame k)
    roll = lambda x: torch.cat([x[1:], x[-1:]], dim=0)
    ws_bar = ws._replace(Ps=roll(ws.Ps), Qs=roll(ws.Qs), Vs=roll(ws.Vs),
                         Bas=roll(ws.Bas), Bgs=roll(ws.Bgs))
    return Prior(J=Jp, r=rp, ws_bar=ws_bar)


def marginalize_second_new(prior: Prior, cfg: BAConfig) -> Prior:
    """MARGIN_SECOND_NEW: drop pose/speedbias of frame W-1 from the prior
    only, then relabel frame W -> W-1."""
    W, d = cfg.window, cfg.d_state
    lo, hi = (W - 1) * 15, W * 15
    # reorder columns [dropped | kept]
    A = torch.cat([prior.J[:, lo:hi], prior.J[:, :lo], prior.J[:, hi:]], dim=1)
    J_new, r_new = _eliminate(A, prior.r, 15)
    d_kept = d - 15
    Jp = torch.zeros((d, d), dtype=prior.J.dtype, device=prior.J.device)
    rp = torch.zeros(d, dtype=prior.r.dtype, device=prior.r.device)
    # kept layout was [frames 0..W-2 | frame W | extr | td]; relabel frame W
    # to slot W-1 (it replaces the dropped one)
    Jp[:d_kept, 0: W * 15] = J_new[:, 0: W * 15]
    Jp[:d_kept, (W + 1) * 15:] = J_new[:, W * 15:]
    rp[:d_kept] = r_new
    wb = prior.ws_bar
    put = lambda x: torch.cat([x[:W - 1], x[W:W + 1], x[W:]], dim=0)
    ws_bar = wb._replace(Ps=put(wb.Ps), Qs=put(wb.Qs), Vs=put(wb.Vs),
                         Bas=put(wb.Bas), Bgs=put(wb.Bgs))
    return Prior(J=Jp, r=rp, ws_bar=ws_bar)
