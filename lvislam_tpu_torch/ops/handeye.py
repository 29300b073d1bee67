"""Hand-eye extrinsic rotation self-calibration — port of
``lvislam_tpu.ops.handeye``.

Solves the camera-IMU rotation q_ic from pairs of per-frame camera relative
rotations (epipolar) and IMU preintegration rotations, via

    q_cam_k ⊗ q_ic = q_ic ⊗ q_imu_k          (for every frame pair k)

Each pair contributes 4 rows  huber_k · (L(q_cam_k) − R(q_imu_k))  to a
(4N, 4) system whose least-squares null vector is q_ic. Success requires at
least `min_pairs` pairs and the second-smallest singular value > 0.25. The
pairs live in a fixed-capacity ring and the whole weighted system re-solves in
one batch, iterated twice so the Huber weights see the fresh estimate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import lie


def _quat_LR(q: torch.Tensor, sign: float) -> torch.Tensor:
    """Left (sign +1) or right (−1) multiplication matrix in the [vec, w]
    layout; q is wxyz, rows and columns ordered (x, y, z, w)."""
    w = q[..., 0]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat(
        [w[..., None, None] * eye + sign * lie.skew(q[..., 1:4]), q[..., 1:4, None]], dim=-1)
    bot = torch.cat([-q[..., None, 1:4], w[..., None, None]], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _quat_L(q):
    return _quat_LR(q, 1.0)


def _quat_R(q):
    return _quat_LR(q, -1.0)


class HandEyeResult(NamedTuple):
    q_ic: torch.Tensor  # (4,) wxyz camera->IMU rotation estimate
    ok: torch.Tensor  # () bool: enough pairs + excitation
    sv2: torch.Tensor  # () second-smallest singular value (excitation measure)


def calibrate_rotation(
    q_cam: torch.Tensor,  # (N, 4) wxyz camera delta rotations
    q_imu: torch.Tensor,  # (N, 4) wxyz IMU preintegration delta_q
    valid: torch.Tensor,  # (N,)
    q_init: torch.Tensor,  # (4,) current q_ic estimate (identity to bootstrap)
    min_pairs: int = 10,
    sv_thresh: float = 0.25,
    iters: int = 2,
) -> HandEyeResult:
    """Batched `CalibrationExRotation`. `q_cam[k]` is the camera-frame
    rotation over the same interval and in the same sense as the IMU
    preintegration `delta_q` (orientation of frame k+1 expressed in frame k):
    the transpose of `triangulate.RelPose.R`."""
    n = torch.sum(valid)
    q_ic, sv2 = q_init, None
    for _ in range(iters):
        q_g = lie.quat_multiply(
            lie.quat_multiply(lie.quat_conjugate(q_ic)[None], q_imu), q_ic[None])
        dot = torch.abs(torch.sum(lie.quat_normalize(q_cam) * lie.quat_normalize(q_g), -1))
        ang = 2.0 * torch.arccos(torch.clamp(dot, 0.0, 1.0)) * (180.0 / math.pi)
        huber = torch.where(ang > 5.0, 5.0 / torch.clamp(ang, min=1e-9), torch.ones_like(ang))
        w = torch.where(valid, huber, torch.zeros_like(huber))
        A = (w[:, None, None] * (_quat_L(q_cam) - _quat_R(q_imu))).reshape(-1, 4)
        # null vector via eigh of AᵀA (4x4 — avoids a tall SVD)
        ew, ev = torch.linalg.eigh(A.T @ A)  # ascending
        x = ev[:, 0]  # [vec, w] layout
        q_est = lie.quat_normalize(torch.stack([x[3], x[0], x[1], x[2]]))
        q_ic = lie.quat_conjugate(q_est)
        sv2 = torch.sqrt(torch.clamp(ew[1], min=0.0))
    ok = (n >= min_pairs) & (sv2 > sv_thresh)
    return HandEyeResult(q_ic=q_ic, ok=ok, sv2=sv2)
