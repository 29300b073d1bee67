"""The synthetic world, the figure-8 and the raycast, in torch on the card.

A copy of the port's host generator (``lvislam_tpu_torch.utils.synthetic``:
``default_world``, ``raycast``, ``figure8_trajectory``, ``Trajectory.imu``),
rewritten so that whole laps of sensor data are made on the device in a
few large calls. The world's few dozen random numbers come from NumPy's
generator seeded as the port's are, so a seed gives the port's world; all
geometry is float64.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

GRAVITY = 9.81
MIN_T, MAX_RANGE = 0.05, 100.0  # a ray's nearest accepted hit, its farthest


@dataclasses.dataclass
class World:
    """Rectangular planes (point, unit normal, in-plane axes, half-extents)
    and vertical cylinders (centre, radius, z range), as (P, ...) and
    (C, ...) float64 tensors on one device."""

    plane_p0: torch.Tensor
    plane_n: torch.Tensor
    plane_a: torch.Tensor
    plane_b: torch.Tensor
    plane_ext: torch.Tensor
    cyl_c: torch.Tensor
    cyl_r: torch.Tensor
    cyl_z: torch.Tensor


def world_arrays(seed: int, size: float = 14.0) -> dict:
    """The room of ``synthetic.default_world(seed, size)`` as NumPy arrays:
    floor, ceiling, 4 walls, 6 boxes of two faces each, 10 poles."""
    rng = np.random.default_rng(seed)
    planes = []

    def add_plane(p0, n, a, b, ea, eb):
        planes.append((np.array(p0, float), np.array(n, float) / np.linalg.norm(n),
                       np.array(a, float), np.array(b, float), np.array([ea, eb], float)))

    s = size
    add_plane([0, 0, -1.6], [0, 0, 1], [1, 0, 0], [0, 1, 0], s, s)
    add_plane([0, 0, 2.6], [0, 0, -1], [1, 0, 0], [0, 1, 0], s, s)
    add_plane([s, 0, 0.5], [-1, 0, 0], [0, 1, 0], [0, 0, 1], s, 2.2)
    add_plane([-s, 0, 0.5], [1, 0, 0], [0, 1, 0], [0, 0, 1], s, 2.2)
    add_plane([0, s, 0.5], [0, -1, 0], [1, 0, 0], [0, 0, 1], s, 2.2)
    add_plane([0, -s, 0.5], [0, 1, 0], [1, 0, 0], [0, 0, 1], s, 2.2)
    for _ in range(6):
        cx, cy = rng.uniform(-s * 0.7, s * 0.7, 2)
        if np.hypot(cx, cy) < 5.0:
            cx += np.sign(cx or 1.0) * 5.0
        w = rng.uniform(0.8, 2.0)
        add_plane([cx + w, cy, 0.0], [1, 0, 0], [0, 1, 0], [0, 0, 1], w, 1.5)
        add_plane([cx, cy + w, 0.0], [0, 1, 0], [1, 0, 0], [0, 0, 1], w, 1.5)
    cyl_c, cyl_r, cyl_z = [], [], []
    for _ in range(10):
        c = rng.uniform(-s * 0.8, s * 0.8, 2)
        if np.hypot(*c) < 4.0:
            c = c + np.sign(c) * 4.0
        cyl_c.append(c)
        cyl_r.append(rng.uniform(0.06, 0.15))
        cyl_z.append([-1.6, 2.6])
    return dict(plane_p0=np.stack([p[0] for p in planes]),
                plane_n=np.stack([p[1] for p in planes]),
                plane_a=np.stack([p[2] for p in planes]),
                plane_b=np.stack([p[3] for p in planes]),
                plane_ext=np.stack([p[4] for p in planes]),
                cyl_c=np.array(cyl_c), cyl_r=np.array(cyl_r), cyl_z=np.array(cyl_z))


def default_world(seed: int, device) -> World:
    arrays = world_arrays(seed)
    return World(**{k: torch.as_tensor(v, dtype=torch.float64, device=device)
                    for k, v in arrays.items()})


def raycast(world: World, origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Ranges (N,) of rays (N, 3) to the nearest surface, inf where none."""
    n = world.plane_n
    denom = dirs @ n.T  # (N, P)
    t = ((world.plane_p0 * n).sum(-1) - origins @ n.T) / denom
    ua = origins @ world.plane_a.T + t * (dirs @ world.plane_a.T) - (
        world.plane_p0 * world.plane_a).sum(-1)
    ub = origins @ world.plane_b.T + t * (dirs @ world.plane_b.T) - (
        world.plane_p0 * world.plane_b).sum(-1)
    hit = ((t > MIN_T) & (t < MAX_RANGE) & (denom.abs() > 1e-9)
           & (ua.abs() <= world.plane_ext[:, 0]) & (ub.abs() <= world.plane_ext[:, 1]))
    best = torch.where(hit, t, math.inf).amin(dim=1)

    oc = origins[:, None, :2] - world.cyl_c  # (N, C, 2)
    d2 = dirs[:, :2]
    a = (d2 * d2).sum(-1)[:, None]
    b = 2 * (oc * d2[:, None]).sum(-1)
    c = (oc * oc).sum(-1) - world.cyl_r ** 2
    disc = b * b - 4 * a * c
    tc = (-b - torch.sqrt(torch.clamp(disc, min=0))) / (2 * a)
    z = origins[:, 2:3] + tc * dirs[:, 2:3]
    hit = ((disc > 0) & (a > 1e-12) & (tc > MIN_T) & (tc < MAX_RANGE)
           & (z >= world.cyl_z[:, 0]) & (z <= world.cyl_z[:, 1]))
    return torch.minimum(best, torch.where(hit, tc, math.inf).amin(dim=1))


# ---------------------------------------------------------------------------
# The figure-8 and its ideal IMU
# ---------------------------------------------------------------------------

def euler_zyx(rpy: torch.Tensor) -> torch.Tensor:
    """(..., 3) roll, pitch, yaw -> R = Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = rpy.unbind(-1)
    cr, sr, cp, sp, cy, sy = r.cos(), r.sin(), p.cos(), p.sin(), y.cos(), y.sin()
    return torch.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], dim=-1).reshape(rpy.shape[:-1] + (3, 3))


@dataclasses.dataclass(frozen=True)
class Figure8:
    """``synthetic.figure8_trajectory(scale, period, z_amp)``: x = s sin wt,
    y = s sin 2wt / 1.5, z = z_amp sin 3wt; yaw along the velocity, roll
    0.05 sin 2wt, pitch 0.05 cos 3wt. Periodic in `period`."""

    scale: float
    period: float
    z_amp: float = 0.15

    def rpy(self, t: torch.Tensor) -> torch.Tensor:
        w, s = 2 * math.pi / self.period, self.scale
        vx = s * w * torch.cos(w * t)
        vy = s * 2 * w * torch.cos(2 * w * t) / 1.5
        return torch.stack([0.05 * torch.sin(2 * w * t), 0.05 * torch.cos(3 * w * t),
                            torch.atan2(vy, vx)], dim=-1)

    def pose(self, t: torch.Tensor):
        """(positions (..., 3), rotations (..., 3, 3)) at times t (float64)."""
        w, s = 2 * math.pi / self.period, self.scale
        p = torch.stack([s * torch.sin(w * t), s * torch.sin(2 * w * t) / 1.5,
                         self.z_amp * torch.sin(3 * w * t)], dim=-1)
        return p, euler_zyx(self.rpy(t))

    def imu(self, t: torch.Tensor, dt: float = 1e-4):
        """Ideal gyro (body angular velocity) and specific force at t, by the
        central differences of ``Trajectory.imu``."""
        p0, R0 = self.pose(t)
        pp, Rp = self.pose(t + dt)
        pm, Rm = self.pose(t - dt)
        w_body = rotvec(Rm.transpose(-1, -2) @ Rp) / (2 * dt)
        a_world = (pp - 2 * p0 + pm) / dt ** 2
        g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=t.dtype, device=t.device)
        f_body = ((a_world - g)[..., None, :] @ R0)[..., 0, :]  # R^T (a - g)
        return w_body, f_body


def rotvec(R: torch.Tensor) -> torch.Tensor:
    """Rotation vectors of rotations (..., 3, 3) with angles below pi/2."""
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1) / 2
    s = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    c = (R.diagonal(dim1=-2, dim2=-1).sum(-1, keepdim=True) - 1) / 2
    ang = torch.atan2(s, c)
    return v * torch.where(s > 1e-12, ang / torch.clamp(s, min=1e-300), 1.0)
