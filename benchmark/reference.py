"""The plain reference that decides ``correct``: where the rig truly was.

The stream is made from an analytic path (the figure-8 of the traffic file)
through an exact world, with no noise. So every pose the system answers has
one right value: the rig's pose at that stamp. This module works that pose
out again in NumPy float64, from the traffic's numbers alone (it imports
nothing of the program and nothing of the benchmark's torch generator), and
holds the program's answers against it.

A system's map frame is its own: the LIO step starts from the first scan's
attitude with a yaw of its choosing, the VIO from its gravity-aligned
bootstrap. So each answer is compared as a motion relative to an anchor
answer of the same stream (the run's first scan; the window's first
estimated frame), and every later answer's relative motion is held to the
true relative motion. A fault that leaves a pose unchanged or alters an
answer shows as an error of the size of the motion.
"""

from __future__ import annotations

import numpy as np


def figure8(t, scale: float, period: float, z_amp: float = 0.15):
    """Positions (N, 3) and rotations (N, 3, 3) of the figure-8 at times t:
    x = s sin wt, y = s sin 2wt / 1.5, z = z_amp sin 3wt; roll 0.05 sin 2wt,
    pitch 0.05 cos 3wt, yaw along the velocity; R = Rz(yaw) Ry(pitch) Rx(roll)."""
    t = np.asarray(t, np.float64)
    w = 2 * np.pi / period
    p = np.stack([scale * np.sin(w * t), scale * np.sin(2 * w * t) / 1.5,
                  z_amp * np.sin(3 * w * t)], axis=-1)
    roll, pitch = 0.05 * np.sin(2 * w * t), 0.05 * np.cos(3 * w * t)
    yaw = np.arctan2(scale * 2 * w * np.cos(2 * w * t) / 1.5, scale * w * np.cos(w * t))
    return p, rpy_matrix(np.stack([roll, pitch, yaw], axis=-1))


def figure8_speed(t, scale: float, period: float, z_amp: float = 0.15) -> np.ndarray:
    """The figure-8's speed (m/s) at times t, from its analytic derivative."""
    t = np.asarray(t, np.float64)
    w = 2 * np.pi / period
    v = np.stack([scale * w * np.cos(w * t), scale * 2 * w * np.cos(2 * w * t) / 1.5,
                  z_amp * 3 * w * np.cos(3 * w * t)], axis=-1)
    return np.linalg.norm(v, axis=-1)


def rpy_matrix(rpy) -> np.ndarray:
    """(N, 3) roll, pitch, yaw -> (N, 3, 3) Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = np.moveaxis(np.asarray(rpy, np.float64), -1, 0)
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                     sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                     -sp, cp * sr, cp * cr], axis=-1).reshape(r.shape + (3, 3))


def quat_matrix(q) -> np.ndarray:
    """(N, 4) unit quaternions [w, x, y, z] -> (N, 3, 3)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    axis=-1).reshape(w.shape + (3, 3))


def _yaw(R):
    return np.arctan2(R[..., 1, 0], R[..., 0, 0])


def errors(p_est, R_est, p_true, R_true, anchor: int = 0) -> dict:
    """Per-answer errors of each estimated pose's motion from the anchor
    answer against the true motion from the anchor's stamp:

    - ``yaw``: the heading error (rad, wrapped), of the ZYX yaw;
    - ``xy``: the horizontal position error (m), each side's displacement
      taken in its own anchor's heading frame;
    - ``pos``, ``rot``: the full 3D position (m) and rotation (rad) errors
      in the anchor's body frame.

    Both frames are gravity-aligned (the LIO step's roll and pitch start
    from the IMU's; the VIO aligns gravity), so a heading and a horizontal
    displacement mean the same on both sides. Non-finite estimates read inf."""
    p_est, R_est = np.asarray(p_est, np.float64), np.asarray(R_est, np.float64)
    ye, yt = _yaw(R_est), _yaw(R_true)
    yaw = np.abs(np.angle(np.exp(1j * ((ye - ye[anchor]) - (yt - yt[anchor])))))

    def heading_xy(p, y0):
        d = p[:, :2] - p[anchor, :2]
        c, s = np.cos(y0), np.sin(y0)
        return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], axis=-1)

    xy = np.linalg.norm(heading_xy(p_est, ye[anchor]) - heading_xy(p_true, yt[anchor]), axis=-1)
    dp_est = np.einsum("ji,nj->ni", R_est[anchor], p_est - p_est[anchor])
    dp_true = np.einsum("ji,nj->ni", R_true[anchor], p_true - p_true[anchor])
    pos = np.linalg.norm(dp_est - dp_true, axis=-1)
    D = np.einsum("ji,njk->nik", R_true[anchor], R_true)
    D = np.einsum("nji,njk->nik", D, np.einsum("ji,njk->nik", R_est[anchor], R_est))
    rot = np.arccos(np.clip((np.trace(D, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0))
    up_e, up_t = R_est[:, 2, :], R_true[:, 2, :]  # the world's up axis in each body frame
    cos = np.sum(up_e * up_t, -1) / (np.linalg.norm(up_e, axis=-1) * np.linalg.norm(up_t, axis=-1))
    tilt = np.arccos(np.clip(cos, -1.0, 1.0))
    out = {"yaw": yaw, "xy": xy, "pos": pos, "rot": rot, "tilt": tilt}
    bad = ~(np.isfinite(p_est).all(-1) & np.isfinite(R_est).all((-1, -2)))
    for v in out.values():
        v[bad] = np.inf
    return out


def relative(stamps, p_est, R_est, p_true, R_true, horizon_s: float) -> dict:
    """Errors of each answer's motion to the first answer `horizon_s` or
    more later (no anchor): ``rel_yaw``, the gap (rad) between the estimated
    and the true change of heading; ``rel_rot``, the angle (rad) between the
    estimated and the true relative rotation; and ``rel_pos``, the distance
    (m) between the estimated and the true displacement, each in its own
    side's earlier body frame. Pairs with a non-finite estimate read inf."""
    st = np.asarray(stamps, np.float64)
    p_est, R_est = np.asarray(p_est, np.float64), np.asarray(R_est, np.float64)
    i = np.arange(len(st))
    j = np.searchsorted(st, st + horizon_s - 1e-6)
    i, j = i[j < len(st)], j[j < len(st)]
    if not len(i):
        return {"rel_yaw": np.zeros(0), "rel_rot": np.zeros(0), "rel_pos": np.zeros(0)}

    def motion(p, R):
        dR = np.einsum("nji,njk->nik", R[i], R[j])
        dp = np.einsum("nji,nj->ni", R[i], p[j] - p[i])
        return dR, dp

    dRe, dpe = motion(p_est, R_est)
    dRt, dpt = motion(p_true, R_true)
    D = np.einsum("nji,njk->nik", dRt, dRe)
    rot = np.arccos(np.clip((np.trace(D, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0))
    pos = np.linalg.norm(dpe - dpt, axis=-1)
    ye, yt = _yaw(R_est), _yaw(R_true)
    yaw = np.abs(np.angle(np.exp(1j * ((ye[j] - ye[i]) - (yt[j] - yt[i])))))
    bad = ~(np.isfinite(p_est).all(-1) & np.isfinite(R_est).all((-1, -2)))
    out = {"rel_yaw": yaw, "rel_rot": rot, "rel_pos": pos}
    for v in out.values():
        v[bad[i] | bad[j]] = np.inf
    return out


def lio_errors(stamps, x6, motion: dict, anchor: int = 0) -> dict:
    """`errors` of LIO poses x6 (N, 6) [roll, pitch, yaw, x, y, z] at
    `stamps`, from the answer at index `anchor`."""
    x6 = np.asarray(x6, np.float64)
    p_true, R_true = figure8(stamps, motion["scale"], motion["period"])
    return errors(x6[:, 3:6], rpy_matrix(x6[:, 0:3]), p_true, R_true, anchor)


def lio_relative(stamps, x6, motion: dict, horizon_s: float) -> dict:
    """`relative` errors of LIO poses x6 over `horizon_s`."""
    x6 = np.asarray(x6, np.float64)
    p_true, R_true = figure8(stamps, motion["scale"], motion["period"])
    return relative(stamps, x6[:, 3:6], rpy_matrix(x6[:, 0:3]), p_true, R_true, horizon_s)


def vio_errors(stamps, pos, quat_wxyz, vel, motion: dict, horizon_s: float,
               anchor: int = 0) -> dict:
    """`errors` and `relative` errors of VIO body poses (position, [w, x, y,
    z] attitude), with ``speed``: the gap (m/s) between the estimated and
    the true speed, which no frame's choice of heading changes."""
    p_true, R_true = figure8(stamps, motion["scale"], motion["period"])
    R_est = quat_matrix(quat_wxyz)
    out = errors(pos, R_est, p_true, R_true, anchor)
    out.update(relative(stamps, pos, R_est, p_true, R_true, horizon_s))
    speed = np.abs(np.linalg.norm(np.asarray(vel, np.float64), axis=-1)
                   - figure8_speed(stamps, motion["scale"], motion["period"]))
    out["speed"] = np.where(np.isfinite(speed), speed, np.inf)
    return out


def median(values) -> float:
    """The median of a set of errors (inf counts as large), 0 for none."""
    v = np.asarray(values, np.float64)
    return float(np.median(v)) if v.size else 0.0


def worst(values) -> float:
    """The largest error of a set, inf for a non-finite one, 0 for none."""
    v = np.asarray(values, np.float64)
    return float(np.max(v)) if v.size else 0.0
