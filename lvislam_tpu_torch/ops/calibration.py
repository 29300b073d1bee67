"""Camera intrinsic calibration — port of ``lvislam_tpu.ops.calibration``,
the camera_model package's calibration tool (`camera_model/src/
intrinsic_calib.cc`, `calib/CameraCalibration.cc`,
`CostFunctionFactory.cc`).

The reference detects chessboard corners (OpenCV) then runs a Ceres
reprojection BA over [intrinsics + per-view extrinsics]. Here, as in the
JAX package, one batched Levenberg-Marquardt over all views at once: every
reprojection residual lives in one (V, N, 2) tensor, the Jacobian over the
4-9 intrinsics and 6 x V pose columns comes from forward-mode autodiff
(``torch.func.jacfwd``), and each step solves the damped system by QR and a
triangular solve. The JAX ``lax.scan`` is a Python loop whose accept /
reject is a ``torch.where`` on the device: no host read in an iteration.
Runs on the device and in the dtype of its inputs (float32, as the JAX
package runs without x64).

Supports the PINHOLE and MEI models (the shipped config's model); the board
is the standard planar grid (object z = 0). Corner detection is input:
`ops.chessboard.find_chessboard` or synthetic corners.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from . import camera


def _project(v: torch.Tensor, pts_cam: torch.Tensor, model_type: str):
    """Project camera-frame points with an intrinsics VECTOR:
    pinhole: [fx, fy, cx, cy, k1, k2, p1, p2]
    mei:     [xi, fx, fy, cx, cy, k1, k2, p1, p2]."""
    if model_type == "MEI":
        xi, fx, fy, cx, cy, k1, k2, p1, p2 = (v[i] for i in range(9))
        norm = torch.sqrt(torch.sum(pts_cam * pts_cam, dim=-1, keepdim=True))
        Ps = pts_cam / torch.clamp(norm, min=1e-9)
        z = Ps[..., 2] + xi
        p_u = Ps[..., :2] / torch.clamp(z, min=1e-9)[..., None]
    else:
        fx, fy, cx, cy, k1, k2, p1, p2 = (v[i] for i in range(8))
        p_u = pts_cam[..., :2] / torch.clamp(pts_cam[..., 2:3], min=1e-9)
    p_d = p_u + camera._radtan(p_u, k1, k2, p1, p2)
    return torch.stack([fx * p_d[..., 0] + cx, fy * p_d[..., 1] + cy], dim=-1)


class CalibResult(NamedTuple):
    intrinsics: torch.Tensor  # parameter vector (see _project)
    rvecs: torch.Tensor  # (V, 3) board-to-camera rotations
    tvecs: torch.Tensor  # (V, 3)
    rms_px: torch.Tensor  # () final reprojection RMS


def calibrate(
    board_pts: torch.Tensor,  # (N, 2) planar board coordinates (z = 0)
    image_pts: torch.Tensor,  # (V, N, 2) detected corners per view
    valid: torch.Tensor,  # (V, N)
    intr0: torch.Tensor,  # initial intrinsics vector
    rvecs0: torch.Tensor,  # (V, 3) initial board poses
    tvecs0: torch.Tensor,  # (V, 3)
    model_type: str = "PINHOLE",
    iterations: int = 15,
) -> CalibResult:
    V, N, _ = image_pts.shape
    D_int = intr0.shape[0]
    D = D_int + 6 * V
    obj = torch.cat([board_pts, torch.zeros_like(board_pts[:, :1])], dim=-1)
    okf = valid[..., None]

    def unpack(x):
        return (x[:D_int], x[D_int:D_int + 3 * V].reshape(V, 3),
                x[D_int + 3 * V:].reshape(V, 3))

    def residuals(x):
        intr, rv, tv = unpack(x)
        R = lie.so3_exp(rv)  # (V, 3, 3)
        pc = torch.einsum("nj,vij->vni", obj, R) + tv[:, None, :]
        proj = _project(intr, pc, model_type)
        return torch.where(okf, proj - image_pts, torch.zeros_like(proj)).reshape(-1)

    jac = torch.func.jacfwd(residuals)
    x = torch.cat([intr0, rvecs0.reshape(-1), tvecs0.reshape(-1)])
    lam = torch.tensor(1e-3, dtype=x.dtype, device=x.device)
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    zeros = torch.zeros(D, dtype=x.dtype, device=x.device)
    for _ in range(iterations):
        r = residuals(x)
        J = jac(x)
        col = torch.linalg.norm(J, dim=0) + 1e-6
        A = torch.cat([J, torch.sqrt(lam) * torch.diag(col)], dim=0)
        b = torch.cat([-r, zeros])
        Q, Rq = torch.linalg.qr(A)
        d = torch.linalg.solve_triangular(Rq + 1e-9 * eye, (Q.T @ b)[:, None], upper=True)[:, 0]
        x2 = x + d
        better = torch.sum(residuals(x2) ** 2) < torch.sum(r * r)
        x = torch.where(better, x2, x)
        lam = torch.where(better, lam / 3.0, lam * 10.0)
    r = residuals(x)
    n_obs = torch.clamp(torch.sum(valid), min=1)
    rms = torch.sqrt(torch.sum(r * r) / (2.0 * n_obs))
    intr, rv, tv = unpack(x)
    return CalibResult(intrinsics=intr, rvecs=rv, tvecs=tv, rms_px=rms)
