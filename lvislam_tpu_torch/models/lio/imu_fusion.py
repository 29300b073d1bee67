"""IMU-rate odometry fusion — port of ``lvislam_tpu.models.lio.imu_fusion``
(the `IMUPreintegration` + `TransformFusion` node pair).

An exactly marginalized two-state fixed-lag smoother: one Gauss-Newton over
the 30-dof (previous, current) state pair with

- the carried 15x15 sqrt-information prior on the previous state,
- the 15-dim whitened midpoint-preintegration factor,
- the lidar pose prior with the correction sigmas (or the degenerate ones).

Both the Gauss-Newton step and the marginalization are in square-root (QR)
form: forming JᵀJ in f32 wipes out the low-weight lidar-correction rows next
to the 1e4-weight whitened IMU rows. Failure detection and the reset-id
protocol are `torch.where` selects on every field, so ``fusion_correct``
never reads a value back to the host.

On a card ``fusion_correct`` replays a CUDA graph of `_correct` (the same
kernels on the same data, so the same bits), captured at the first call of
each signature of its inputs by ``core/cudagraph.py``; on the CPU and under
``torch.func`` or autograd `_correct` runs eagerly. Spans:
``lio.fusion_graph`` around each replay, ``lio.fusion_capture`` around each
capture; ``CAPTURES`` counts the captures.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ...core import cudagraph, lie
from ...core.device import resolve as resolve_device
from ...ops import dense
from ...ops import preintegration as pre


@dataclasses.dataclass(frozen=True)
class FusionParams:
    imuAccNoise: float = 3.9939570888238808e-03
    imuGyrNoise: float = 1.5636343949698187e-03
    imuAccBiasN: float = 6.4356659353532566e-05
    imuGyrBiasN: float = 3.5640318696367613e-05
    imuGravity: float = 9.80511
    # prior sigmas
    priorPoseSigma: float = 1e-2
    priorVelSigma: float = 1e4
    priorBiasSigma: float = 1e-3
    # lidar correction sigmas
    corrRotSigma: float = 0.05
    corrTransSigma: float = 0.1
    corrDegenerateSigma: float = 1.0
    # failure thresholds
    maxVelocity: float = 30.0
    maxBias: float = 1.0
    # lidar->IMU lever arm; zero on the shipped rig
    extTrans: tuple = (0.0, 0.0, 0.0)


class FusionState(NamedTuple):
    # previous optimized IMU-frame state (the prior anchor)
    pos: torch.Tensor  # (3,)
    quat: torch.Tensor  # (4,)
    vel: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    sqrt_info: torch.Tensor  # (15, 15) prior sqrt information
    initialized: torch.Tensor  # () bool
    failed: torch.Tensor  # () bool — failure detection fired this step
    reset_id: torch.Tensor  # () int32


def fusion_init(params: FusionParams, dtype=torch.float32, device=None) -> FusionState:
    """The uninitialized smoother state on `device` (the card unless named)."""
    device = resolve_device(device)
    z3 = torch.zeros(3, dtype=dtype, device=device)
    info = torch.tensor(
        [1.0 / params.priorPoseSigma] * 6 + [1.0 / params.priorVelSigma] * 3
        + [1.0 / params.priorBiasSigma] * 6, dtype=dtype, device=device)
    false = torch.zeros((), dtype=torch.bool, device=device)
    return FusionState(
        pos=z3, quat=lie.quat_identity(dtype, device), vel=z3, ba=z3, bg=z3,
        sqrt_info=torch.diag(info),
        initialized=false, failed=false,
        reset_id=torch.zeros((), dtype=torch.int32, device=device),
    )


def _retract15(pos, quat, vel, ba, bg, d):
    """d = [dp(3), phi(3), dv(3), dba(3), dbg(3)]."""
    return (
        pos + d[0:3],
        lie.quat_multiply(quat, lie.so3_exp_quat(d[3:6])),
        vel + d[6:9],
        ba + d[9:12],
        bg + d[12:15],
    )


def _state_minus(pos, quat, vel, ba, bg, pos0, quat0, vel0, ba0, bg0):
    """x ⊖ x0 in the same tangent layout."""
    return torch.cat([
        pos - pos0,
        lie.quat_log(lie.quat_multiply(lie.quat_conjugate(quat0), quat)),
        vel - vel0,
        ba - ba0,
        bg - bg0,
    ])


class _Constants(NamedTuple):
    """What a correction used to build on the host at every call, built once
    for each (params, dtype, device) with the same bits: a CUDA graph
    capture refuses the host copy that ``torch.tensor`` makes."""

    noise: pre.ImuNoise
    G: torch.Tensor  # (3,) [0, 0, imuGravity]
    corr_sigma: torch.Tensor  # (6,) [trans x 3, rot x 3]
    corr_sigma_degenerate: torch.Tensor  # (6,)
    fresh: FusionState  # `fusion_init`: the failure reset


@functools.cache
def _constants(params: FusionParams, dtype, device: torch.device) -> _Constants:
    return _Constants(
        noise=pre.ImuNoise.create(
            params.imuAccNoise, params.imuGyrNoise,
            params.imuAccBiasN, params.imuGyrBiasN, dtype, device,
        ),
        G=torch.tensor([0.0, 0.0, params.imuGravity], dtype=dtype, device=device),
        corr_sigma=torch.tensor([params.corrTransSigma] * 3 + [params.corrRotSigma] * 3,
                                dtype=dtype, device=device),
        corr_sigma_degenerate=torch.full((6,), params.corrDegenerateSigma, dtype=dtype,
                                         device=device),
        fresh=fusion_init(params, dtype, device),
    )


def fusion_correct(
    state: FusionState,
    dts: torch.Tensor,  # (N,) IMU sample dts since last correction (0 = pad)
    accs: torch.Tensor,  # (N, 3)
    gyrs: torch.Tensor,  # (N, 3)
    lidar_trans: torch.Tensor,  # (3,) lidar odometry position (IMU frame)
    lidar_quat: torch.Tensor,  # (4,)
    degenerate: torch.Tensor,  # () bool
    params: FusionParams,
    gn_iters: int = 4,
) -> FusionState:
    """One `odometryHandler` correction. Returns the new state. On a card it
    replays a CUDA graph of `_correct`, captured at the first call of each
    signature of its inputs (shapes, dtypes, device, `params`, `gn_iters`);
    on the CPU and under ``torch.func`` or autograd `_correct` runs eagerly."""
    args = (state, dts, accs, gyrs, lidar_trans, lidar_quat, degenerate)
    if not cudagraph.graphable(args):
        return _correct(*args, params, gn_iters,
                        _constants(params, state.pos.dtype, state.pos.device))
    with torch.cuda.device(state.pos.device):
        g = cudagraph.cached(_GRAPHS, _CorrectGraph, args, (params, gn_iters))
        cudagraph.replay(g.graph, "lio.fusion_graph")
        # the result must not alias the buffers the next call's replay writes
        return cudagraph.tmap(torch.clone, g.out)


def _correct(state: FusionState, dts, accs, gyrs, lidar_trans, lidar_quat, degenerate,
             params: FusionParams, gn_iters: int, consts: _Constants) -> FusionState:
    """`fusion_correct` on its inputs and `_constants(params, ...)`."""
    dtype, device = state.pos.dtype, state.pos.device
    noise, G = consts.noise, consts.G
    eye15 = torch.eye(15, dtype=dtype, device=device)

    # preintegrate the window at the current bias linearization point
    pint0 = pre.preint_init(accs[0], gyrs[0], state.ba, state.bg, dtype)
    pint = pre.preintegrate(pint0, dts, accs, gyrs, noise)
    # whitening: sqrt information of the 15x15 preint covariance
    Lc = dense.cholesky(pint.covariance + 1e-8 * eye15)
    imu_sqrt_info = dense.solve_triangular(Lc, eye15, lower=True)

    corr_sigma = torch.where(degenerate, consts.corr_sigma_degenerate, consts.corr_sigma)
    corr_w = 1.0 / corr_sigma

    # initial guess for the new state: IMU prediction
    nav0 = pre.NavState(pos=state.pos, quat=state.quat, vel=state.vel,
                        ba=state.ba, bg=state.bg)
    nav_pred = pre.navstate_predict(nav0, dts, accs, gyrs, -G)

    x0 = (state.pos, state.quat, state.vel, state.ba, state.bg)

    def residuals(d):
        d0, d1 = d[0:15], d[15:30]
        p0, q0, v0, ba0, bg0 = _retract15(*x0, d0)
        p1, q1, v1, ba1, bg1 = _retract15(
            nav_pred.pos, nav_pred.quat, nav_pred.vel, state.ba, state.bg, d1
        )
        r_prior = state.sqrt_info @ _state_minus(p0, q0, v0, ba0, bg0, *x0)
        r_imu = imu_sqrt_info @ pre.evaluate(
            pint, p0, q0, v0, ba0, bg0, p1, q1, v1, ba1, bg1, G
        )
        r_corr = corr_w * torch.cat([
            p1 - lidar_trans,
            lie.quat_log(lie.quat_multiply(lie.quat_conjugate(lidar_quat), q1)),
        ])
        r = torch.cat([r_prior, r_imu, r_corr])
        return r, r

    jac = torch.func.jacfwd(residuals, has_aux=True)  # d -> (J (36, 30), r)

    # square-root (QR) Gauss-Newton
    eye30 = torch.eye(30, dtype=dtype, device=device)
    d = torch.zeros(30, dtype=dtype, device=device)
    for _ in range(gn_iters):
        J, r = jac(d)
        Q, R = torch.linalg.qr(J)  # (36, 30), (30, 30)
        d = d + dense.solve_triangular(R + 1e-8 * eye30, -(Q.T @ r), lower=False)

    # Marginalization by QR elimination (square-root information filter):
    # with column order [x0 | x1], the trailing 15x15 block of R is the exact
    # sqrt information of the x1 marginal.
    J, _ = jac(d)
    _, Rfac = torch.linalg.qr(J)
    new_sqrt_info = Rfac[15:30, 15:30]

    p1, q1, v1, ba1, bg1 = _retract15(
        nav_pred.pos, nav_pred.quat, nav_pred.vel, state.ba, state.bg, d[15:30]
    )
    q1 = lie.quat_normalize(q1)

    failed = (
        (lie.norm3(v1) > params.maxVelocity)
        | (lie.norm3(ba1) > params.maxBias)
        | (lie.norm3(bg1) > params.maxBias)
    )

    fresh = consts.fresh
    return FusionState(
        pos=torch.where(failed, fresh.pos, p1),
        quat=torch.where(failed, fresh.quat, q1),
        vel=torch.where(failed, fresh.vel, v1),
        ba=torch.where(failed, fresh.ba, ba1),
        bg=torch.where(failed, fresh.bg, bg1),
        sqrt_info=torch.where(failed, fresh.sqrt_info, new_sqrt_info),
        initialized=~failed,
        failed=failed,
        reset_id=state.reset_id + failed.to(torch.int32),
    )


# ---------------------------------------------------------------------------
# CUDA graphs: `_correct` captured once per signature and replayed
# ---------------------------------------------------------------------------

CAPTURES = 0  # graphs captured in this process
_GRAPHS: dict = {}  # signature -> captured graph


def _capture(fn):
    global CAPTURES
    out = cudagraph.capture(fn, "lio.fusion_capture")
    CAPTURES += 1
    return out


class _CorrectGraph(cudagraph.Graphed):
    """`_correct` captured on static arguments; its constants are static
    inputs that no call reloads (the key fixes them)."""

    def __init__(self, args, key):
        super().__init__(args)
        params, gn_iters = key
        pos = self.args[0].pos
        consts = _constants(params, pos.dtype, pos.device)
        self.graph, self.out = _capture(lambda: _correct(*self.args, params, gn_iters, consts))


def fusion_initialize(state: FusionState, lidar_trans: torch.Tensor,
                      lidar_quat: torch.Tensor, params: FusionParams) -> FusionState:
    """System initialization at the first lidar correction."""
    fresh = fusion_init(params, state.pos.dtype, state.pos.device)
    return fresh._replace(
        pos=lidar_trans,
        quat=lidar_quat,
        initialized=torch.ones_like(fresh.initialized),
        reset_id=state.reset_id,
    )


def predict_imu_rate(state: FusionState, dts, accs, gyrs, params: FusionParams):
    """IMU-rate odometry stream: per-sample (pos (N, 3), quat (N, 4),
    vel (N, 3)) dead-reckoned from the latest optimized state."""
    G = torch.tensor([0.0, 0.0, -params.imuGravity], dtype=state.pos.dtype,
                     device=state.pos.device)
    return pre.predict_seq_history(state.pos, state.quat, state.vel, state.ba, state.bg,
                                   dts, accs, gyrs, G)


def transform_fusion(
    lidar_odom_trans, lidar_odom_quat,
    imu_odom_front_trans, imu_odom_front_quat,
    imu_odom_back_trans, imu_odom_back_quat,
):
    """`TransformFusion::imuOdometryHandler`: latest map odometry ∘ (imu odom
    at map time)⁻¹ ∘ (latest imu odom)."""
    ti, qi = lie.se3_relative(
        imu_odom_front_trans, imu_odom_front_quat,
        imu_odom_back_trans, imu_odom_back_quat,
    )
    return lie.se3_compose(lidar_odom_trans, lidar_odom_quat, ti, qi)
