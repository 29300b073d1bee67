"""Sliding-window visual-inertial estimator — port of
``lvislam_tpu.models.vio.estimator`` (the `Estimator` + `estimator_node`
equivalent).

Window state, preintegrations, feature table and the marginalization prior
are one NamedTuple; each camera frame drives:

- `process_imu`: midpoint propagation of the window-end state + the
  per-frame preintegration;
- `process_image`: feature-table insert + parallax keyframe flag,
  initialization (the seeded path A, or the visual path B), then BA
  (`ops.ba.solve`) + marginalization + window slide;
- failure detection as a predicate with `clearState` reboot semantics.

Where the JAX step has `lax.cond`, this one branches in Python, each
decision one host read through ``core.hostsync``: in steady state
`initialized`, the keyframe flag and the failure predicate, besides the BA
loop's convergence flags; before initialization, on a full window, whether
any window frame has the parallax the visual bootstrap needs (without one
it is not run) and whether it came out ok. `frame_count` changes only
by rules the host can follow (plus one per frame until the window is full,
back to zero on a reboot), so callers may pass its host mirror `frame_count`
to both entry points; without it the value is read back once a call.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ...core import lie
from ...core.device import resolve as resolve_device
from ...core.hostsync import host_bool
from ...ops import ba, handeye, triangulate
from ...ops import preintegration as pre
from . import feature_manager as fm
from . import initializer as vinit


@dataclasses.dataclass(frozen=True)
class VioParams:
    # the reference configuration's noise: VINS deliberately runs with
    # inflated IMU noise, which also keeps the whitened system conditioned
    acc_n: float = 0.4
    gyr_n: float = 0.15
    acc_w: float = 6.4e-3
    gyr_w: float = 3.6e-3
    g_norm: float = 9.81
    min_parallax: float = 10.0 / 460.0
    init_depth: float = 5.0
    # failure thresholds
    ba_threshold: float = 2.5
    bg_threshold: float = 1.0
    max_v_norm: float = 30.0
    jump_t: float = 5.0
    jump_z: float = 1.0
    # enable the visual-SfM bootstrap fallback (path B)
    use_visual_init: bool = True
    # ESTIMATE_EXTRINSIC=2 semantics: bootstrap the camera-IMU rotation online
    # via hand-eye calibration; initialization is blocked until it converges
    estimate_extrinsic_rotation: bool = False
    ex_min_pairs: int = 10


class VioState(NamedTuple):
    ws: ba.WindowState
    table: fm.FeatureTable
    pints: pre.PreintState  # stacked (W,) preintegrations between frames
    imu_bufs: tuple  # (dts (W, M), accs (W, M, 3), gyrs (W, M, 3)) raw buffers
    prior: ba.Prior
    frame_count: torch.Tensor  # () int32 frames currently in window (<= W+1)
    frame_valid: torch.Tensor  # (W+1,)
    initialized: torch.Tensor  # () bool — INITIAL vs NON_LINEAR
    failed: torch.Tensor  # () bool (failure this step)
    failure_count: torch.Tensor  # () int32 — doubles as the reset-id
    td0: torch.Tensor  # () reference td
    last_marg_old: torch.Tensor  # () bool
    # previous frame's post-solve newest pose for the jump checks
    last_P: torch.Tensor  # (3,)
    last_P_ok: torch.Tensor  # () bool
    # hand-eye extrinsic-rotation bootstrap ring
    ex_qcam: torch.Tensor  # (E, 4)
    ex_qimu: torch.Tensor  # (E, 4)
    ex_valid: torch.Tensor  # (E,)
    ex_count: torch.Tensor  # () int32
    ex_q: torch.Tensor  # (4,) running q_ic estimate
    ric_ok: torch.Tensor  # () bool — extrinsic rotation known/converged


def _empty_pints(W: int, dtype, device) -> pre.PreintState:
    z = torch.zeros((W, 3), dtype=dtype, device=device)
    return pre.PreintState(*(x.contiguous() for x in pre.preint_init(z, z, z, z, dtype)))


def vio_init(caps: fm.VioCaps, params: VioParams, dtype=torch.float32,
             device=None) -> VioState:
    """The empty estimator state on `device` (the card unless named)."""
    device = resolve_device(device)
    W, W1, M, E = caps.window, caps.window + 1, caps.imu_buf, caps.ex_pairs
    cfg = ba.BAConfig(window=caps.window, max_features=caps.max_features)
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    flag = lambda v: torch.tensor(v, dtype=torch.bool, device=device)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    q1 = lie.quat_identity(dtype, device)
    return VioState(
        ws=ba._zero_ws(cfg, dtype, device),
        table=fm.table_init(caps, dtype, device),
        pints=_empty_pints(W, dtype, device),
        imu_bufs=(z(W, M), z(W, M, 3), z(W, M, 3)),
        prior=ba.empty_prior(cfg, dtype, device),
        frame_count=i32(0),
        frame_valid=torch.zeros(W1, dtype=torch.bool, device=device),
        initialized=flag(False),
        failed=flag(False),
        failure_count=i32(0),
        td0=z(),
        last_marg_old=flag(True),
        last_P=z(3),
        last_P_ok=flag(False),
        ex_qcam=q1.repeat(E, 1),
        ex_qimu=q1.repeat(E, 1),
        ex_valid=torch.zeros(E, dtype=torch.bool, device=device),
        ex_count=i32(0),
        ex_q=q1,
        ric_ok=flag(not params.estimate_extrinsic_rotation),
    )


def _clear_state(state: VioState, caps: fm.VioCaps, params: VioParams) -> VioState:
    """`clearState` + `setParameter` reboot: full re-initialization keeping
    the extrinsic / td calibration. The caller increments `failure_count`,
    which is also the reset-id downstream consumers check."""
    fresh = vio_init(caps, params, state.ws.Ps.dtype, state.ws.Ps.device)
    return fresh._replace(
        ws=fresh.ws._replace(tic=state.ws.tic, qic=state.ws.qic, td=state.ws.td),
        td0=state.td0,
        failure_count=state.failure_count,
        failed=torch.ones_like(fresh.failed),
    )


def _noise(params: VioParams, like: torch.Tensor) -> pre.ImuNoise:
    return pre.ImuNoise.create(params.acc_n, params.gyr_n, params.acc_w, params.gyr_w,
                               like.dtype, like.device)


def _set_row(x: torch.Tensor, k: int, row: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[:k], row[None].to(x.dtype), x[k + 1:]], dim=0)


def process_imu(
    state: VioState,
    dts: torch.Tensor,  # (M,) padded with zeros
    accs: torch.Tensor,  # (M, 3)
    gyrs: torch.Tensor,
    caps: fm.VioCaps,
    params: VioParams,
    *,
    frame_count: int,  # the caller's host copy of state.frame_count
) -> VioState:
    """`processIMU` for the whole inter-frame buffer: preintegrate into slot
    frame_count-1 and propagate the newest state."""
    fc = frame_count
    k = min(max(fc - 1, 0), caps.window - 1)
    j = min(max(fc, 0), caps.window)
    ws = state.ws

    pint0 = pre.preint_init(accs[0], gyrs[0], ws.Bas[j], ws.Bgs[j])
    pint = pre.preintegrate(pint0, dts, accs, gyrs, _noise(params, accs))
    pints = pre.PreintState(*(_set_row(buf, k, x) for buf, x in zip(state.pints, pint)))
    d, a, g = state.imu_bufs
    imu_bufs = (_set_row(d, k, dts), _set_row(a, k, accs), _set_row(g, k, gyrs))

    # propagate newest window state (world frame, gravity down)
    G = torch.tensor([0.0, 0.0, -params.g_norm], dtype=accs.dtype, device=accs.device)
    nav = pre.NavState(pos=ws.Ps[j], quat=ws.Qs[j], vel=ws.Vs[j], ba=ws.Bas[j], bg=ws.Bgs[j])
    nav = pre.navstate_predict(nav, dts, accs, gyrs, G)
    ws = ws._replace(Ps=_set_row(ws.Ps, j, nav.pos), Qs=_set_row(ws.Qs, j, nav.quat),
                     Vs=_set_row(ws.Vs, j, nav.vel))
    return state._replace(ws=ws, pints=pints, imu_bufs=imu_bufs)


def _roll(x: torch.Tensor) -> torch.Tensor:
    """Drop row 0, repeat the last row."""
    return torch.cat([x[1:], x[-1:]], dim=0)


def _slide_window(state: VioState, marg_old: bool, caps: fm.VioCaps, cfg: ba.BAConfig):
    """`slideWindow` for a full window."""
    W = caps.window
    ws = state.ws
    if marg_old:
        # camera poses of old frame 0 and new frame 0 for depth re-anchor
        t0, q0 = lie.se3_compose(ws.Ps[0], ws.Qs[0], ws.tic, ws.qic)
        t1, q1 = lie.se3_compose(ws.Ps[1], ws.Qs[1], ws.tic, ws.qic)
        table = fm.slide_old(state.table, t0, lie.quat_to_matrix(q0), t1,
                             lie.quat_to_matrix(q1), caps)
        ws = ws._replace(Ps=_roll(ws.Ps), Qs=_roll(ws.Qs), Vs=_roll(ws.Vs),
                         Bas=_roll(ws.Bas), Bgs=_roll(ws.Bgs))
        pints = pre.PreintState(*(_roll(x) for x in state.pints))
        bufs = tuple(_roll(b) for b in state.imu_bufs)
        return state._replace(ws=ws, table=table, pints=pints, imu_bufs=bufs)
    table = fm.slide_new(state.table, caps)
    # frame W replaces W-1; the two trailing preintegrations merge
    put = lambda x: _set_row(x, W - 1, x[W])
    ws = ws._replace(Ps=put(ws.Ps), Qs=put(ws.Qs), Vs=put(ws.Vs),
                     Bas=put(ws.Bas), Bgs=put(ws.Bgs))
    a = pre.PreintState(*(x[W - 2] for x in state.pints))
    b = pre.PreintState(*(x[W - 1] for x in state.pints))
    merged = pre.preint_compose(a, b)
    pints = pre.PreintState(*(_set_row(buf, W - 2, m) for buf, m in zip(state.pints, merged)))
    return state._replace(ws=ws, table=table, pints=pints)


def _calibrate_extrinsic(state: VioState, fi: int, fc: int, caps, params, sampler):
    """ESTIMATE_EXTRINSIC=2: the epipolar rotation between the two newest
    frames paired with the newest preintegration delta_q, pushed into a ring
    and re-solved each frame until excitation suffices."""
    W = caps.window
    tb = state.table
    prev = max(fi - 1, 0)
    both = (tb.ids >= 0) & tb.obs_valid[:, prev] & tb.obs_valid[:, fi]
    rel = triangulate.relative_pose(tb.obs[:, prev], tb.obs[:, fi], both, n_hyp=128,
                                    sampler=sampler)
    if fc >= 1 and host_bool(rel.ok):
        # RelPose.R maps prev->cur; the hand-eye wants the same sense as the
        # preintegration delta_q (orientation of the NEW frame in the old): Rᵀ
        q_cam = lie.matrix_to_quat(rel.R.T)
        q_imu = state.pints.delta_q[min(max(fc - 1, 0), W - 1)]
        at = torch.arange(caps.ex_pairs, device=q_cam.device) == state.ex_count % caps.ex_pairs
        state = state._replace(
            ex_qcam=torch.where(at[:, None], q_cam, state.ex_qcam),
            ex_qimu=torch.where(at[:, None], q_imu, state.ex_qimu),
            ex_valid=state.ex_valid | at,
            ex_count=state.ex_count + 1,
        )
    res = handeye.calibrate_rotation(state.ex_qcam, state.ex_qimu, state.ex_valid, state.ex_q,
                                     min_pairs=params.ex_min_pairs)
    state = state._replace(ex_q=res.q_ic)
    if host_bool(res.ok):
        # switch to refine mode: fix qic; BA can keep polishing it
        state = state._replace(ws=state.ws._replace(qic=res.q_ic),
                               ric_ok=torch.ones_like(state.ric_ok))
    return state


def _triangulate_fresh(state: VioState, ws: ba.WindowState, caps) -> fm.FeatureTable:
    """Triangulate every feature without a lidar depth against `ws`."""
    tb = state.table
    keep = torch.where(tb.lidar_flag, tb.inv_depth, torch.full_like(tb.inv_depth, -1.0))
    return fm.triangulate_all(tb._replace(inv_depth=keep), ws.Ps, ws.Qs, ws.tic, ws.qic, caps)


def _try_initialize(state: VioState, lidar_odom: dict, window_full: bool, caps, params,
                    sampler) -> VioState:
    W = caps.window
    true = torch.ones_like(state.initialized)
    available = lidar_odom["available"]
    if isinstance(available, torch.Tensor):
        available = window_full and host_bool(available)
    if window_full and available:
        # path A: seed window states from lidar odometry, repropagate all
        # preintegrations with the seeded biases (W windows in one loop) and
        # triangulate
        ba_, bg_ = lidar_odom["ba"], lidar_odom["bg"]
        ws = state.ws._replace(Ps=lidar_odom["Ps"], Qs=lidar_odom["Qs"], Vs=lidar_odom["Vs"],
                               Bas=ba_[None].repeat(W + 1, 1), Bgs=bg_[None].repeat(W + 1, 1))
        d, a, g = state.imu_bufs
        fresh = pre.preint_init(a[:, 0], g[:, 0], ba_, bg_)
        pints = pre.preintegrate(fresh, d, a, g, _noise(params, d))
        return state._replace(ws=ws, pints=pints, table=_triangulate_fresh(state, ws, caps),
                              initialized=true)
    if not (params.use_visual_init and window_full):
        return state
    # path B: visual SfM + IMU alignment. Without a reference frame of
    # enough parallax the SfM cannot come out ok: not run at all
    if not host_bool(torch.any(vinit.find_reference_frame(state.table, W)[1])):
        return state
    Ps, Qs, Vs, Bgs, pints2, ok = vinit.visual_initialize(
        state.table, state.pints, state.imu_bufs, state.ws.tic, state.ws.qic, W,
        params.g_norm, _noise(params, state.ws.Ps), sampler=sampler)
    if not host_bool(ok):
        return state
    ws = state.ws._replace(Ps=Ps, Qs=Qs, Vs=Vs, Bgs=Bgs, Bas=torch.zeros_like(state.ws.Bas))
    return state._replace(ws=ws, pints=pints2, table=_triangulate_fresh(state, ws, caps),
                          initialized=true)


def process_image(
    state: VioState,
    ids: torch.Tensor,  # (N,)
    norm: torch.Tensor,  # (N, 2)
    vel: torch.Tensor,  # (N, 2)
    depth: torch.Tensor,  # (N,) lidar depth channel
    valid: torch.Tensor,  # (N,)
    lidar_odom: dict,  # seeded init: {available, Ps, Qs, Vs, ba, bg}
    caps: fm.VioCaps,
    params: VioParams,
    cfg: ba.BAConfig,
    rt: torch.Tensor | None = None,  # (N,) rolling-shutter row times, seconds
    *,
    frame_count: int,  # the caller's host copy of state.frame_count
    sampler=None,  # RANSAC draws of the epipolar solves, as the tracker's
):
    """`processImage`. Returns (state, outputs); `outputs["ba_iterations"]`
    and `outputs["frame_count"]` (the count to pass with the next frame) are
    host integers."""
    W = caps.window
    fc = frame_count
    fi = min(fc, W)
    window_full = fc >= W

    table, parallax_kf = fm.add_frame(
        state.table, fi, ids, norm, vel, depth, valid, caps,
        min_parallax=params.min_parallax, in_rt=rt,
    )
    at_fi = torch.arange(W + 1, device=table.ids.device) == fi
    state = state._replace(table=table, frame_valid=state.frame_valid | at_fi)
    initialized = host_bool(state.initialized)
    # lidar info forces MARGIN_OLD during init; the flag is read only where a
    # branch hangs on it (an initialized estimator with a full window)
    marg_old_t = parallax_kf | (~state.initialized)

    ric_ok = True
    if params.estimate_extrinsic_rotation:
        ric_ok = host_bool(state.ric_ok)
        if not ric_ok:
            state = _calibrate_extrinsic(state, fi, fc, caps, params, sampler)
            ric_ok = host_bool(state.ric_ok)

    # while the extrinsic rotation is uncalibrated, initialization is blocked
    if not initialized and ric_ok:
        state = _try_initialize(state, lidar_odom, window_full, caps, params, sampler)
        initialized = host_bool(state.initialized)

    ba_iterations = 0
    marg_old = True
    if initialized and window_full:
        marg_old = host_bool(marg_old_t)
        table = fm.triangulate_all(state.table, state.ws.Ps, state.ws.Qs, state.ws.tic,
                                   state.ws.qic, caps)
        G = torch.tensor([0.0, 0.0, params.g_norm], dtype=state.ws.Ps.dtype,
                         device=state.ws.Ps.device)
        res = ba.solve(
            state.ws, table.inv_depth, table.obs, table.vel, table.obs_valid,
            table.start_frame, table.ids >= 0, table.lidar_flag, state.pints,
            state.frame_valid, state.prior, G, state.td0, cfg, table_rt=table.rt,
        )
        ba_iterations = res.iterations
        table = table._replace(inv_depth=res.inv_depth)
        state = state._replace(ws=res.ws, table=table)
        if marg_old:
            prior = ba.marginalize_old(
                state.ws, table.inv_depth, table.obs, table.vel, table.obs_valid,
                table.start_frame, table.ids >= 0, table.lidar_flag, state.pints,
                state.frame_valid, state.prior, G, state.td0, cfg, table_rt=table.rt,
            )
        else:
            prior = ba.marginalize_second_new(state.prior, cfg)
        state = state._replace(prior=prior)

    # failure detection: bias / velocity sanity plus the pose-jump checks
    # against the previous frame's post-solve pose
    cur_P = state.ws.Ps[fi]
    failed_t = state.initialized & (
        (lie.norm3(state.ws.Bas[fi]) > params.ba_threshold)
        | (lie.norm3(state.ws.Bgs[fi]) > params.bg_threshold)
        | (lie.norm3(state.ws.Vs[fi]) > params.max_v_norm)
        | (state.last_P_ok & (lie.norm3(cur_P - state.last_P) > params.jump_t))
        | (state.last_P_ok & (torch.abs(cur_P[2] - state.last_P[2]) > params.jump_z))
    )
    # an uninitialized estimator cannot fail: no read
    if initialized and host_bool(failed_t):
        # failure -> clearState + setParameter; the incremented failure_count
        # is the reset-id downstream consumers see
        fresh = _clear_state(state, caps, params)
        state = fresh._replace(failure_count=state.failure_count + 1)
        fc = 0
    else:
        # record last_P BEFORE the slide
        state = state._replace(last_P=cur_P, last_P_ok=state.initialized)
        if window_full:
            # an uninitialized full window always slides its oldest frame out
            state = _slide_window(state, marg_old, caps, cfg)
        else:
            fc += 1
            state = state._replace(frame_count=state.frame_count + 1)
        state = state._replace(failed=torch.zeros_like(state.failed), last_marg_old=marg_old_t)

    j = min(fc, W)
    outputs = dict(
        pos=state.ws.Ps[j], quat=state.ws.Qs[j], vel=state.ws.Vs[j],
        initialized=state.initialized, failed=failed_t, is_keyframe=marg_old_t,
        ba_iterations=ba_iterations, frame_count=fc,
    )
    return state, outputs
