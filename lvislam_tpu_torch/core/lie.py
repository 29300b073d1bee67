"""SO(3) / SE(3) / quaternion helpers — port of ``lvislam_tpu.core.lie``.

Conventions match the JAX module: Hamilton quaternions stored ``[w, x, y,
z]``; rotation matrices act on column vectors; Euler ``ypr`` in degrees with
R = Rz(y) Ry(p) Rx(r). Every function is shape-polymorphic over leading
batch dimensions and branch-free (``torch.where`` selects), so it runs on
any device without host syncs.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` over the last axis."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def norm3(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over a last axis of length 3, summed in index order
    (the order XLA reduces a length-3 axis in)."""
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                   + v[..., 2] * v[..., 2])
    return n[..., None] if keepdim else n


def _unit(n: int, i: int, dtype, device) -> torch.Tensor:
    """The i-th unit vector of length n, made on the device: a CUDA graph
    capture refuses the host copy that ``torch.tensor`` makes."""
    eye = torch.eye(n, dtype=dtype, device=device)
    return eye[i].clone()


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return _unit(4, 0, dtype, device)


def quat_multiply(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ p (first p, then q)."""
    q, p = torch.broadcast_tensors(q, p)
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    # the bits of q * [1, -1, -1, -1], signed zeros included, with no
    # host-built constant (a CUDA graph capture refuses its copy)
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    return quat_conjugate(q) / torch.sum(q * q, dim=-1, keepdim=True)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(n, min=_EPS)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q; equals R(q) @ v."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def delta_q(theta: torch.Tensor) -> torch.Tensor:
    """Small-angle quaternion [1, θ/2] (deliberately unnormalized)."""
    half = 0.5 * theta
    return torch.cat([torch.ones_like(half[..., :1]), half], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    r = torch.stack(
        [
            1.0 - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, 1.0 - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, 1.0 - (txx + tyy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion, branch-free Shepperd method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) / 2.0

    qw0 = half_sqrt(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4.0 * qw0), (m02 - m20) / (4.0 * qw0),
                      (m10 - m01) / (4.0 * qw0)], dim=-1)
    qx1 = half_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4.0 * qx1), qx1, (m01 + m10) / (4.0 * qx1),
                      (m02 + m20) / (4.0 * qx1)], dim=-1)
    qy2 = half_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4.0 * qy2), (m01 + m10) / (4.0 * qy2), qy2,
                      (m12 + m21) / (4.0 * qy2)], dim=-1)
    qz3 = half_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4.0 * qz3), (m02 + m20) / (4.0 * qz3),
                      (m12 + m21) / (4.0 * qz3), qz3], dim=-1)

    cand = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(cand, dim=-1)  # first max, as jnp.argmax
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.take_along_dim(qs, idx[..., None, None], dim=-2)[..., 0, :]
    return quat_normalize(q)


def _quat_mult_matrix(q: torch.Tensor, sign: float) -> torch.Tensor:
    w = q[..., 0]
    v = q[..., 1:4]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top = torch.cat([w[..., None, None], -v[..., None, :]], dim=-1)
    bottom = torch.cat(
        [v[..., :, None], w[..., None, None] * eye + sign * skew(v)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_left(q: torch.Tensor) -> torch.Tensor:
    """4x4 left-multiplication matrix: Qleft(q) @ p == q ⊗ p."""
    return _quat_mult_matrix(q, 1.0)


def quat_right(p: torch.Tensor) -> torch.Tensor:
    """4x4 right-multiplication matrix: Qright(p) @ q == q ⊗ p."""
    return _quat_mult_matrix(p, -1.0)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation (shortest arc), branch-free."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0.0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]×."""
    zero = torch.zeros_like(v[..., 0])
    r = torch.stack(
        [zero, -v[..., 2], v[..., 1],
         v[..., 2], zero, -v[..., 0],
         -v[..., 1], v[..., 0], zero],
        dim=-1,
    )
    return r.reshape(v.shape[:-1] + (3, 3))


def so3_exp_quat(phi: torch.Tensor) -> torch.Tensor:
    """Exponential map axis-angle → unit quaternion, Taylor-safe."""
    angle_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle_sq, min=_EPS * _EPS))
    small = angle_sq < 1e-12
    half = 0.5 * angle
    k = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Exponential map axis-angle → rotation matrix (Rodrigues)."""
    return quat_to_matrix(so3_exp_quat(phi))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map rotation matrix → axis-angle, Taylor-safe."""
    return quat_log(matrix_to_quat(R))


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → axis-angle (rotation vector)."""
    q = torch.where(q[..., 0:1] < 0.0, -q, q)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    vn = norm3(q[..., 1:4], keepdim=True)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS),
                        angle / torch.clamp(vn, min=_EPS))
    return scale * q[..., 1:4]


def _jacobian_terms(phi: torch.Tensor):
    theta_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    P = skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(P.shape)
    return theta_sq, theta, P, P @ P, theta_sq < 1e-10, eye


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3): Jr(φ) = I − (1−cosθ)/θ² [φ]× + (θ−sinθ)/θ³ [φ]×²."""
    theta_sq, theta, P, PP, small, eye = _jacobian_terms(phi)
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta_sq, min=_EPS))
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta_sq * theta, min=_EPS))
    return eye - a * P + b * PP


def so3_right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3)."""
    theta_sq, theta, P, PP, small, eye = _jacobian_terms(phi)
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 / torch.clamp(theta_sq, min=_EPS))
        - (1.0 + torch.cos(theta)) / torch.clamp(2.0 * theta * torch.sin(theta), min=_EPS),
    )
    return eye + 0.5 * P + cot_term * PP


def matrix_to_ypr(R: torch.Tensor) -> torch.Tensor:
    """R → [yaw, pitch, roll] in DEGREES."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.stack([y, p, r], dim=-1) * (180.0 / math.pi)


def ypr_to_matrix(ypr: torch.Tensor) -> torch.Tensor:
    """[yaw, pitch, roll] DEGREES → R = Rz(y) Ry(p) Rx(r)."""
    rad = ypr * (math.pi / 180.0)
    y, p, r = rad[..., 0], rad[..., 1], rad[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    R = torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return R.reshape(ypr.shape[:-1] + (3, 3))


def rpy_to_quat(roll, pitch, yaw) -> torch.Tensor:
    """Roll/pitch/yaw (RADIANS) → quaternion, ZYX convention."""
    ypr_deg = torch.stack([yaw, pitch, roll], dim=-1) * (180.0 / math.pi)
    return matrix_to_quat(ypr_to_matrix(ypr_deg))


def quat_to_rpy(q: torch.Tensor):
    """Quaternion → (roll, pitch, yaw) RADIANS."""
    ypr = matrix_to_ypr(quat_to_matrix(q)) * (math.pi / 180.0)
    return ypr[..., 2], ypr[..., 1], ypr[..., 0]


def g2R(g: torch.Tensor) -> torch.Tensor:
    """World-from-body rotation aligning measured gravity direction `g` with
    +z and zeroing yaw."""
    ng1 = g / torch.clamp(norm3(g, keepdim=True), min=_EPS)
    ng2 = _unit(3, 2, g.dtype, g.device)
    v = cross(ng1, ng2.expand(ng1.shape))
    c = torch.sum(ng1 * ng2, dim=-1, keepdim=True)
    axis_norm = norm3(v, keepdim=True)
    angle = torch.atan2(axis_norm, c)
    axis = v / torch.clamp(axis_norm, min=_EPS)
    R0 = so3_exp(axis * angle)
    yaw = matrix_to_ypr(R0)[..., 0:1]
    yaw_fix = torch.cat([-yaw, torch.zeros_like(yaw), torch.zeros_like(yaw)], dim=-1)
    return ypr_to_matrix(yaw_fix) @ R0


def se3_compose(t1, q1, t2, q2):
    """T1 ∘ T2: first apply T2, then T1."""
    return t1 + quat_rotate(q1, t2), quat_normalize(quat_multiply(q1, q2))


def se3_inverse(t, q):
    qi = quat_conjugate(q)
    return -quat_rotate(qi, t), qi


def se3_apply(t, q, pts):
    """Transform points (..., N, 3) by pose (t, q)."""
    return quat_rotate(q[..., None, :], pts) + t[..., None, :]


def se3_relative(t1, q1, t2, q2):
    """T1⁻¹ ∘ T2 — the pose of frame 2 expressed in frame 1."""
    ti, qi = se3_inverse(t1, q1)
    return se3_compose(ti, qi, t2, q2)


def x6_rotation(x6: torch.Tensor) -> torch.Tensor:
    """Rotation of the LIS pose layout [roll, pitch, yaw, tx, ty, tz]."""
    return ypr_to_matrix(
        torch.stack([x6[..., 2], x6[..., 1], x6[..., 0]], dim=-1)
        * (180.0 / math.pi)
    )


def pose6_to_matrix(x6: torch.Tensor) -> torch.Tensor:
    """[roll, pitch, yaw, tx, ty, tz] (radians) → 4×4 affine."""
    R = x6_rotation(x6)
    top = torch.cat([R, x6[..., 3:6, None]], dim=-1)
    bottom = _unit(4, 3, x6.dtype, x6.device).expand(x6.shape[:-1] + (4,))
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def matrix_to_pose6(T: torch.Tensor) -> torch.Tensor:
    """4×4 affine → [roll, pitch, yaw, tx, ty, tz] radians."""
    ypr = matrix_to_ypr(T[..., :3, :3]) * (math.pi / 180.0)
    return torch.cat(
        [torch.stack([ypr[..., 2], ypr[..., 1], ypr[..., 0]], dim=-1), T[..., :3, 3]],
        dim=-1,
    )
