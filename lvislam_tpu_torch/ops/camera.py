"""Camera projection models — port of ``lvislam_tpu.ops.camera`` (the
camodocal equivalents).

The four models behind camodocal's ``Camera`` interface, as batched
branch-free torch functions over trailing point batches ((..., 2) pixels,
(..., 3) points):

- ``lift_projective``: pixel -> unit ray, inverting radtan distortion by the
  reference's 8-step fixed-point recursion (`CataCamera.cc:597-611`);
- ``space_to_plane``: 3D point -> pixel;
- ``normalized_plane``: pixel -> undistorted normalized plane (x/z, y/z).

Models: PINHOLE (radtan), MEI (omni mirror xi + radtan, the shipped rig's
model), KANNALA_BRANDT (equidistant fisheye, Newton-inverted) and
SCARAMUZZA (polynomial omni). The intrinsics are Python floats of a frozen
``CameraIntrinsics``; the tensors' device and dtype come from the input.
"""

from __future__ import annotations

import math

import torch

from ..core.config import CameraIntrinsics
from ..core.lie import norm3

PINHOLE = "PINHOLE"
MEI = "MEI"
KANNALA_BRANDT = "KANNALA_BRANDT"
SCARAMUZZA = "SCARAMUZZA"


# ---------------------------------------------------------------------------
# radtan distortion (shared by pinhole + MEI)
# ---------------------------------------------------------------------------

def _radtan(p_u: torch.Tensor, k1, k2, p1, p2) -> torch.Tensor:
    """Distortion offset d_u such that p_d = p_u + d_u."""
    mx2 = p_u[..., 0] * p_u[..., 0]
    my2 = p_u[..., 1] * p_u[..., 1]
    mxy = p_u[..., 0] * p_u[..., 1]
    rho2 = mx2 + my2
    rad = k1 * rho2 + k2 * rho2 * rho2
    dx = p_u[..., 0] * rad + 2.0 * p1 * mxy + p2 * (rho2 + 2.0 * mx2)
    dy = p_u[..., 1] * rad + 2.0 * p2 * mxy + p1 * (rho2 + 2.0 * my2)
    return torch.stack([dx, dy], dim=-1)


def _undistort_recursive(p_d: torch.Tensor, k1, k2, p1, p2, n: int = 8) -> torch.Tensor:
    """Fixed-point inverse of radtan (`CataCamera.cc:597-611`)."""
    p_u = p_d - _radtan(p_d, k1, k2, p1, p2)
    for _ in range(n - 1):
        p_u = p_d - _radtan(p_u, k1, k2, p1, p2)
    return p_u


def _distorted_plane(uv: torch.Tensor, c: CameraIntrinsics) -> torch.Tensor:
    mx_d = (uv[..., 0] - c.u0) / c.gamma1
    my_d = (uv[..., 1] - c.v0) / c.gamma2
    return torch.stack([mx_d, my_d], dim=-1)


def _to_pixel(p_d: torch.Tensor, c: CameraIntrinsics) -> torch.Tensor:
    return torch.stack(
        [c.gamma1 * p_d[..., 0] + c.u0, c.gamma2 * p_d[..., 1] + c.v0], dim=-1
    )


# ---------------------------------------------------------------------------
# model-specific lift / project
# ---------------------------------------------------------------------------

def _pinhole_lift(uv, c: CameraIntrinsics):
    p_u = _undistort_recursive(_distorted_plane(uv, c), c.k1, c.k2, c.p1, c.p2)
    ray = torch.cat([p_u, torch.ones_like(p_u[..., :1])], dim=-1)
    return ray / norm3(ray, keepdim=True)


def _pinhole_project(P, c: CameraIntrinsics):
    p_u = P[..., :2] / P[..., 2:3]
    return _to_pixel(p_u + _radtan(p_u, c.k1, c.k2, c.p1, c.p2), c)


def _mei_lift(uv, c: CameraIntrinsics):
    """`CataCamera::liftProjective` (`CataCamera.cc:556-638`)."""
    p_u = _undistort_recursive(_distorted_plane(uv, c), c.k1, c.k2, c.p1, c.p2)
    rho2 = p_u[..., 0] * p_u[..., 0] + p_u[..., 1] * p_u[..., 1]
    xi = c.xi
    # lambda such that the lifted point lies on the unit sphere
    lam = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * rho2)) / (1.0 + rho2)
    Ps = torch.cat([lam[..., None] * p_u, (lam - xi)[..., None]], dim=-1)
    return Ps / norm3(Ps, keepdim=True)


def _mei_project(P, c: CameraIntrinsics):
    """`CataCamera::spaceToPlane`: unit sphere + xi shift + radtan + K."""
    Ps = P / torch.clamp(norm3(P, keepdim=True), min=1e-12)
    z = Ps[..., 2] + c.xi
    p_u = Ps[..., :2] / torch.clamp(z, min=1e-12)[..., None]
    return _to_pixel(p_u + _radtan(p_u, c.k1, c.k2, c.p1, c.p2), c)


def _kb_theta_poly(theta, c: CameraIntrinsics):
    t2 = theta * theta
    return theta * (1.0 + t2 * (c.kb_k2 + t2 * (c.kb_k3 + t2 * (c.kb_k4 + t2 * c.kb_k5))))


def _kb_lift(uv, c: CameraIntrinsics, newton_iters: int = 10):
    """`EquidistantCamera::liftProjective`: invert r(theta) by Newton, a
    Python loop of fixed length (JAX's ``lax.scan``)."""
    mx = (uv[..., 0] - c.u0) / c.gamma1
    my = (uv[..., 1] - c.v0) / c.gamma2
    r = torch.sqrt(mx * mx + my * my)
    theta = torch.clamp(r, max=math.pi / 2)  # initial guess
    for _ in range(newton_iters):
        t2 = theta * theta
        f = _kb_theta_poly(theta, c) - r
        df = 1.0 + t2 * (3 * c.kb_k2 + t2 * (5 * c.kb_k3 + t2 * (7 * c.kb_k4 + 9 * t2 * c.kb_k5)))
        theta = theta - f / torch.clamp(df, min=1e-9)
    phi = torch.atan2(my, mx)
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def _kb_project(P, c: CameraIntrinsics):
    theta = torch.acos(torch.clamp(P[..., 2] / norm3(P), -1.0, 1.0))
    phi = torch.atan2(P[..., 1], P[..., 0])
    r = _kb_theta_poly(theta, c)
    return torch.stack(
        [c.gamma1 * r * torch.cos(phi) + c.u0, c.gamma2 * r * torch.sin(phi) + c.v0],
        dim=-1,
    )


def _scara_lift(uv, c: CameraIntrinsics):
    """`ScaramuzzaCamera::liftProjective`: affine inverse + z = poly(rho)."""
    du = uv[..., 0] - c.u0
    dv = uv[..., 1] - c.v0
    inv_det = 1.0 / (c.scara_C - c.scara_D * c.scara_E)
    xp = inv_det * (du - c.scara_D * dv)
    yp = inv_det * (-c.scara_E * du + c.scara_C * dv)
    rho = torch.sqrt(xp * xp + yp * yp)
    z = torch.zeros_like(rho)
    for i, a in enumerate(c.scara_poly):
        z = z + a * rho**i
    ray = torch.stack([xp, yp, z], dim=-1)
    return ray / torch.clamp(norm3(ray, keepdim=True), min=1e-12)


def _scara_project(P, c: CameraIntrinsics):
    norm_xy = torch.sqrt(P[..., 0] ** 2 + P[..., 1] ** 2)
    theta = torch.atan2(P[..., 2], norm_xy)  # scaramuzza convention
    rho = torch.zeros_like(theta)
    for i, a in enumerate(c.scara_inv_poly):
        rho = rho + a * theta**i
    xn = P[..., 0] / torch.clamp(norm_xy, min=1e-12) * rho
    yn = P[..., 1] / torch.clamp(norm_xy, min=1e-12) * rho
    u = xn * c.scara_C + yn * c.scara_D + c.u0
    v = xn * c.scara_E + yn + c.v0
    return torch.stack([u, v], dim=-1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_LIFT = {PINHOLE: _pinhole_lift, MEI: _mei_lift,
         KANNALA_BRANDT: _kb_lift, SCARAMUZZA: _scara_lift}
_PROJECT = {PINHOLE: _pinhole_project, MEI: _mei_project,
            KANNALA_BRANDT: _kb_project, SCARAMUZZA: _scara_project}


def lift_projective(uv: torch.Tensor, cam: CameraIntrinsics) -> torch.Tensor:
    """Pixel (..., 2) -> unit ray (..., 3) (`Camera::liftProjective`)."""
    return _LIFT[cam.model_type](uv, cam)


def space_to_plane(P: torch.Tensor, cam: CameraIntrinsics) -> torch.Tensor:
    """Camera-frame 3D (..., 3) -> pixel (..., 2) (`Camera::spaceToPlane`)."""
    return _PROJECT[cam.model_type](P, cam)


def normalized_plane(uv: torch.Tensor, cam: CameraIntrinsics) -> torch.Tensor:
    """Pixel -> undistorted normalized image plane (x/z, y/z), what the
    feature tracker publishes (`feature_tracker.cpp:298-347`)."""
    ray = lift_projective(uv, cam)
    return ray[..., :2] / torch.clamp(ray[..., 2:3], min=1e-9)
