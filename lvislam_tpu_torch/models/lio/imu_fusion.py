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
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ...core import lie
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
    """One `odometryHandler` correction. Returns the new state."""
    dtype, device = state.pos.dtype, state.pos.device
    noise = pre.ImuNoise.create(
        params.imuAccNoise, params.imuGyrNoise,
        params.imuAccBiasN, params.imuGyrBiasN, dtype, device,
    )
    G = torch.tensor([0.0, 0.0, params.imuGravity], dtype=dtype, device=device)
    eye15 = torch.eye(15, dtype=dtype, device=device)

    # preintegrate the window at the current bias linearization point
    pint0 = pre.preint_init(accs[0], gyrs[0], state.ba, state.bg, dtype)
    pint = pre.preintegrate(pint0, dts, accs, gyrs, noise)
    # whitening: sqrt information of the 15x15 preint covariance
    Lc = dense.cholesky(pint.covariance + 1e-8 * eye15)
    imu_sqrt_info = dense.solve_triangular(Lc, eye15, lower=True)

    corr_sigma = torch.where(
        degenerate,
        torch.full((6,), params.corrDegenerateSigma, dtype=dtype, device=device),
        torch.tensor([params.corrTransSigma] * 3 + [params.corrRotSigma] * 3,
                     dtype=dtype, device=device),
    )
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

    fresh = fusion_init(params, dtype, device)
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
