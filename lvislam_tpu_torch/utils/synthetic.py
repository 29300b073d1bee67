"""Synthetic world — a numpy copy of ``lvislam_tpu.utils.synthetic``: the
room world, batch raycasting, smooth analytic trajectories with an ideal
IMU, one spinning multi-beam lidar sweep with real motion skew, and camera
images of the procedurally textured world through any camera model, and
landmarks on the world's surfaces.

The copy exists so the port can make the bench's scans and frames where JAX
is not installed; the tests hold it to the JAX package's module. Everything
is host-side NumPy float64, except the per-pixel camera rays, which the
port's ``ops.camera.lift_projective`` computes in float32 on the CPU, as
the JAX module's does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
from scipy.spatial.transform import Rotation as Rsc

GRAVITY = 9.81


# ---------------------------------------------------------------------------
# World geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class World:
    # planes: point p0, normal n (unit), half-extents (a_len, b_len) along
    # in-plane axes a, b
    plane_p0: np.ndarray  # (P, 3)
    plane_n: np.ndarray  # (P, 3)
    plane_a: np.ndarray  # (P, 3)
    plane_b: np.ndarray  # (P, 3)
    plane_ext: np.ndarray  # (P, 2)
    # vertical cylinders: center (cx, cy), radius, z range
    cyl_c: np.ndarray  # (C, 2)
    cyl_r: np.ndarray  # (C,)
    cyl_z: np.ndarray  # (C, 2)


def default_world(seed: int = 0, size: float = 14.0) -> World:
    """A room: floor + ceiling + 4 walls + interior boxes + poles."""
    rng = np.random.default_rng(seed)
    planes = []

    def add_plane(p0, n, a, b, ea, eb):
        planes.append((np.array(p0, float), np.array(n, float) / np.linalg.norm(n),
                       np.array(a, float), np.array(b, float), np.array([ea, eb], float)))

    s = size
    add_plane([0, 0, -1.6], [0, 0, 1], [1, 0, 0], [0, 1, 0], s, s)  # floor
    add_plane([0, 0, 2.6], [0, 0, -1], [1, 0, 0], [0, 1, 0], s, s)  # ceiling
    add_plane([s, 0, 0.5], [-1, 0, 0], [0, 1, 0], [0, 0, 1], s, 2.2)
    add_plane([-s, 0, 0.5], [1, 0, 0], [0, 1, 0], [0, 0, 1], s, 2.2)
    add_plane([0, s, 0.5], [0, -1, 0], [1, 0, 0], [0, 0, 1], s, 2.2)
    add_plane([0, -s, 0.5], [0, 1, 0], [1, 0, 0], [0, 0, 1], s, 2.2)
    # interior boxes (two faces each, avoid center where trajectory lives)
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

    return World(
        plane_p0=np.stack([p[0] for p in planes]),
        plane_n=np.stack([p[1] for p in planes]),
        plane_a=np.stack([p[2] for p in planes]),
        plane_b=np.stack([p[3] for p in planes]),
        plane_ext=np.stack([p[4] for p in planes]),
        cyl_c=np.array(cyl_c),
        cyl_r=np.array(cyl_r),
        cyl_z=np.array(cyl_z),
    )


def raycast(world: World, origins: np.ndarray, dirs: np.ndarray, max_range: float = 100.0):
    """Batch ray-world intersection. origins/dirs (N, 3). Returns ranges (N,)
    (inf = miss)."""
    N = origins.shape[0]
    best = np.full(N, np.inf)

    # planes
    for i in range(world.plane_p0.shape[0]):
        n = world.plane_n[i]
        denom = dirs @ n
        tnum = (world.plane_p0[i] - origins) @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = tnum / denom
        hit = (t > 0.05) & (t < max_range) & (np.abs(denom) > 1e-9)
        pts = origins + t[:, None] * dirs
        rel = pts - world.plane_p0[i]
        ua = rel @ world.plane_a[i]
        ub = rel @ world.plane_b[i]
        hit &= (np.abs(ua) <= world.plane_ext[i, 0]) & (np.abs(ub) <= world.plane_ext[i, 1])
        best = np.where(hit & (t < best), t, best)

    # vertical cylinders: solve |o_xy + t d_xy - c|^2 = r^2
    for i in range(world.cyl_c.shape[0]):
        oc = origins[:, :2] - world.cyl_c[i]
        d2 = dirs[:, :2]
        a = np.sum(d2 * d2, axis=1)
        b = 2 * np.sum(oc * d2, axis=1)
        c = np.sum(oc * oc, axis=1) - world.cyl_r[i] ** 2
        disc = b * b - 4 * a * c
        with np.errstate(invalid="ignore", divide="ignore"):
            t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        z = origins[:, 2] + t * dirs[:, 2]
        hit = (disc > 0) & (a > 1e-12) & (t > 0.05) & (t < max_range)
        hit &= (z >= world.cyl_z[i, 0]) & (z <= world.cyl_z[i, 1])
        best = np.where(hit & (t < best), t, best)

    return best


# ---------------------------------------------------------------------------
# Trajectory
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trajectory:
    """Smooth analytic SE(3) trajectory p(t), R(t) with derivatives."""

    pos_fn: Callable[[np.ndarray], np.ndarray]  # (T,) -> (T, 3)
    rpy_fn: Callable[[np.ndarray], np.ndarray]  # (T,) -> (T, 3) roll,pitch,yaw rad

    def pose(self, t):
        t = np.atleast_1d(np.asarray(t, float))
        p = self.pos_fn(t)
        rpy = self.rpy_fn(t)
        R = Rsc.from_euler("ZYX", rpy[:, ::-1]).as_matrix()  # Rz(y)Ry(p)Rx(r)
        return p, R

    def imu(self, t, dt=1e-4):
        """Ideal IMU: body angular velocity + specific force at times t."""
        t = np.asarray(t, float)
        p0, R0 = self.pose(t)
        # angular velocity via central difference of rotations
        _, Rp = self.pose(t + dt)
        _, Rm = self.pose(t - dt)
        dR = np.einsum("nij,nik->njk", Rm, Rp)  # Rm^T Rp  ≈ exp(2 dt ω_body)
        w_body = Rsc.from_matrix(dR).as_rotvec() / (2 * dt)
        # linear acceleration via central difference
        pp, _ = self.pose(t + dt)
        pm, _ = self.pose(t - dt)
        a_world = (pp - 2 * p0 + pm) / dt**2
        g_world = np.array([0.0, 0.0, -GRAVITY])
        f_body = np.einsum("nij,ni->nj", R0, a_world - g_world)  # R^T (a - g)
        return w_body, f_body


def figure8_trajectory(scale: float = 4.0, period: float = 40.0, z_amp: float = 0.15) -> Trajectory:
    w = 2 * np.pi / period

    def pos(t):
        return np.stack(
            [scale * np.sin(w * t), scale * np.sin(2 * w * t) / 1.5, z_amp * np.sin(3 * w * t)],
            axis=-1,
        )

    def rpy(t):
        # yaw follows the velocity direction; gentle roll/pitch oscillation
        vx = scale * w * np.cos(w * t)
        vy = scale * 2 * w * np.cos(2 * w * t) / 1.5
        yaw = np.unwrap(np.arctan2(vy, vx))
        return np.stack(
            [0.05 * np.sin(2 * w * t), 0.05 * np.cos(3 * w * t), yaw], axis=-1
        )

    return Trajectory(pos_fn=pos, rpy_fn=rpy)


def circle_trajectory(radius: float = 3.0, period: float = 8.0,
                      z_amp: float = 0.1) -> Trajectory:
    """Closed circular orbit with tangent heading: the pose at t + period is
    IDENTICAL to the pose at t — the revisit a loop-closure test needs."""
    w = 2 * np.pi / period

    def pos(t):
        return np.stack(
            [radius * np.cos(w * t), radius * np.sin(w * t),
             z_amp * np.sin(2 * w * t)],
            axis=-1,
        )

    def rpy(t):
        yaw = np.unwrap(np.asarray(w * t + np.pi / 2, float))
        z = np.zeros_like(yaw)
        return np.stack([z, z, yaw], axis=-1)

    return Trajectory(pos_fn=pos, rpy_fn=rpy)


def simulate_imu_stream(
    traj: Trajectory,
    t0: float,
    t1: float,
    rate: float = 200.0,
    accel_noise: float = 0.0,
    gyro_noise: float = 0.0,
    accel_bias=(0.0, 0.0, 0.0),
    gyro_bias=(0.0, 0.0, 0.0),
    seed: int = 0,
):
    """Returns (stamps, gyro (N,3), acc (N,3)) including bias + white noise."""
    rng = np.random.default_rng(seed)
    stamps = np.arange(t0, t1, 1.0 / rate)
    w, f = traj.imu(stamps)
    w = w + np.asarray(gyro_bias) + gyro_noise * rng.standard_normal(w.shape)
    f = f + np.asarray(accel_bias) + accel_noise * rng.standard_normal(f.shape)
    return stamps, w, f


def simulate_lidar_scan(
    world: World,
    traj: Trajectory,
    t_start: float,
    n_scan: int = 4,
    horizon: int = 1800,
    sweep_time: float = 0.1,
    max_range: float = 100.0,
    range_noise: float = 0.0,
    seed: int = 0,
):
    """One sweep of a spinning n_scan-beam lidar. Each azimuth step fires all
    beams from the sensor pose at its own time — skew is real. Returns dict
    with xyz (in the scan-start sensor frame of each point's TRUE pose — i.e.
    raw, skewed measurements in the *sensor frame at measurement time*,
    expressed as the lidar reports them), ring, time, plus ground truth pose
    at scan start."""
    rng = np.random.default_rng(seed + int(t_start * 1000) % 100000)
    elev = np.deg2rad(np.linspace(-12, 12, n_scan))
    az = np.linspace(0, 2 * np.pi, horizon, endpoint=False)
    times = t_start + sweep_time * (np.arange(horizon) / horizon)

    p_t, R_t = traj.pose(times)  # (H, 3), (H, 3, 3)

    rings = []
    for r, el in enumerate(elev):
        d_body = np.stack(
            [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.full_like(az, np.sin(el))],
            axis=-1,
        )  # (H, 3)
        d_world = np.einsum("nij,nj->ni", R_t, d_body)
        rngs = raycast(world, p_t, d_world, max_range)
        if range_noise > 0:
            rngs = rngs + range_noise * rng.standard_normal(rngs.shape)
        hit = np.isfinite(rngs)
        # measured point in sensor frame at measurement time
        xyz_meas = d_body * rngs[:, None]
        rings.append(
            dict(xyz=xyz_meas[hit], time=times[hit] - t_start,
                 ring=np.full(hit.sum(), r, np.int32))
        )

    xyz = np.concatenate([r["xyz"] for r in rings])
    time = np.concatenate([r["time"] for r in rings])
    ring = np.concatenate([r["ring"] for r in rings])
    # interleave by time (Livox-style time-ordered stream)
    order = np.argsort(time, kind="stable")
    p0, R0 = traj.pose(np.array([t_start]))
    return dict(
        stamp=t_start,
        xyz=xyz[order].astype(np.float32),
        time=time[order].astype(np.float32),
        ring=ring[order],
        intensity=np.ones(len(order), np.float32),
        true_pos=p0[0],
        true_R=R0[0],
    )


# ---------------------------------------------------------------------------
# Camera images
# ---------------------------------------------------------------------------

def procedural_texture(pts: np.ndarray) -> np.ndarray:
    """Deterministic pseudo-random intensity from 3D position — a 'painted'
    world for photometric (KLT) simulation. Smooth-ish multi-frequency hash."""
    # wavelengths 0.5-4 m: smooth at typical pixel footprints so photometric
    # tracking (LK) sees valid gradients instead of aliasing noise
    v = (
        np.sin(pts @ np.array([1.7, 2.9, 1.3])) * 0.45
        + np.sin(pts @ np.array([4.1, 3.3, 5.7]) + 1.3) * 0.35
        + np.sin(pts @ np.array([8.9, 7.1, 11.3]) + 2.1) * 0.2
    )
    return (0.5 + 0.45 * v).astype(np.float32)


_RAY_GRID_CACHE: dict = {}

# the rendered camera's axes in the body frame: camera x right, y down,
# z forward; body x forward, y left, z up
R_CAM_BODY = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float).T


def camera_ray_grid(cam) -> np.ndarray:
    """Unit ray per pixel for a ``CameraIntrinsics`` (any of the four
    camodocal models, through the port's ``ops.camera.lift_projective`` on
    the CPU) — the static part of rendering, computed once per intrinsics
    and cached."""
    key = (cam.model_type, cam.image_width, cam.image_height, cam.gamma1,
           cam.gamma2, cam.u0, cam.v0, cam.k1, cam.k2, cam.p1, cam.p2,
           getattr(cam, "xi", 0.0))
    hit = _RAY_GRID_CACHE.get(key)
    if hit is not None:
        return hit
    import torch

    from ..ops import camera as camops

    u, v = np.meshgrid(np.arange(cam.image_width), np.arange(cam.image_height))
    uv = np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float32)
    rays = camops.lift_projective(torch.from_numpy(uv), cam).numpy().astype(np.float64)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    _RAY_GRID_CACHE[key] = rays
    return rays


def render_camera_image(
    world: World,
    traj: Trajectory,
    t: float,
    width: int = 320,
    height: int = 240,
    f: float = 200.0,
    R_cam_body: np.ndarray | None = None,
    t_cam_body: np.ndarray | None = None,
    cam=None,
):
    """Raycast an image of the procedurally textured world: a centered
    pinhole at (width, height, f) by default, or — when `cam` (a
    ``CameraIntrinsics``) is given — through the full camera model including
    its distortion/mirror geometry (e.g. the shipped MEI 1024x576 rig)."""
    p, R = traj.pose(np.array([t]))
    p, R = p[0], R[0]
    if R_cam_body is None:
        R_cam_body = R_CAM_BODY
    if t_cam_body is None:
        t_cam_body = np.zeros(3)
    if cam is not None:
        width, height = cam.image_width, cam.image_height
        d_cam = camera_ray_grid(cam)
    else:
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        d_cam = np.stack(
            [(u - width / 2) / f, (v - height / 2) / f, np.ones_like(u, float)],
            axis=-1,
        ).reshape(-1, 3)
        d_cam = d_cam / np.linalg.norm(d_cam, axis=-1, keepdims=True)
    R_wc = R @ R_cam_body
    origin = p + R @ t_cam_body
    d_world = d_cam @ R_wc.T
    rngs = raycast(world, np.broadcast_to(origin, d_world.shape), d_world)
    pts = origin + d_world * np.where(np.isfinite(rngs), rngs, 0.0)[:, None]
    img = np.where(np.isfinite(rngs), procedural_texture(pts), 0.0)
    return img.reshape(height, width).astype(np.float32)


def landmark_points(world: World, n: int = 500, seed: int = 0) -> np.ndarray:
    """Random well-distributed 3D landmarks on world surfaces (for SfM/BA
    synthetic feature tracks)."""
    rng = np.random.default_rng(seed)
    pts = []
    P = world.plane_p0.shape[0]
    for i in range(P):
        k = max(2, n // P)
        ua = rng.uniform(-1, 1, k) * world.plane_ext[i, 0]
        ub = rng.uniform(-1, 1, k) * world.plane_ext[i, 1]
        pts.append(
            world.plane_p0[i]
            + ua[:, None] * world.plane_a[i]
            + ub[:, None] * world.plane_b[i]
        )
    return np.concatenate(pts)[:n]


def vio_stream_jobs(duration: float, cam_rate: float = 10.0, imu_rate: float = 200.0,
                    width: int = 320, height: int = 240, f: float = 200.0, cam=None,
                    world_seed: int = 0, scale: float = 1.5, period: float = 8.0):
    """A mav0-style camera + IMU stream on the figure-8 of (world_seed,
    scale, period), split into the IMU part (made here) and the renders, to
    run anywhere: ideal IMU samples at (i + 1) / imu_rate and
    int(duration * cam_rate) - 1 frames at 0.1 + i / cam_rate (a centered
    pinhole at (width, height, f), or the camera model `cam` at its own
    size). Returns (head, jobs): map ``run_job`` over the jobs, then
    ``vio_stream_join(head, results)``."""
    traj = figure8_trajectory(scale=scale, period=period)
    ts = (np.arange(int(duration * imu_rate)) + 1) / imu_rate
    gyro, acc = traj.imu(ts)
    img_ts = [0.1 + i / cam_rate for i in range(int(duration * cam_rate) - 1)]
    events = [(float(t), "imu", i) for i, t in enumerate(ts)]
    events += [(t, "img", i) for i, t in enumerate(img_ts)]
    events.sort(key=lambda e: e[0])
    head = dict(events=events, gyro=gyro, acc=acc)
    scene = (world_seed, scale, period)
    return head, [("render", scene, t, width, height, f, cam) for t in img_ts]


def vio_stream_join(head: dict, results: list):
    """(events, gyro (N, 3), acc (N, 3), frames): each render quantized to 8
    bits and back as a PNG round trip does (truncating, then / 255 in
    float32); `events` is the time-ordered list of (t, "imu" | "img",
    index), IMU first on equal stamps."""
    frames = [(im * 255).astype(np.uint8).astype(np.float32) / np.float32(255.0)
              for im in results]
    return head["events"], head["gyro"], head["acc"], frames


def vio_stream(duration: float, **kw):
    """``vio_stream_jobs`` run here."""
    head, jobs = vio_stream_jobs(duration, **kw)
    return vio_stream_join(head, [run_job(j) for j in jobs])


def consistent_window_arrays(W: int = 4, F: int = 24, seed: int = 0,
                             rate: float = 10.0, imu_rate: float = 160.0):
    """An exact synthetic VIO window as float32 numpy arrays: W+1 body states
    on the figure-8 (scale 3, period 30) at `rate` Hz, the ideal IMU samples
    between them (W, n, 3 at `imu_rate`), and F landmarks ahead of frame 0
    observed in every frame (camera == body: identity extrinsics), anchored
    at frame 0 with their true inverse depths. Returns a dict: Ps, Qs, Vs,
    imu_dt, accs, gyrs, obs, obs_valid, inv_depth."""
    rng = np.random.default_rng(seed)
    traj = figure8_trajectory(scale=3.0, period=30.0)
    ts = np.arange(W + 1) / rate
    Ps, Rs = traj.pose(ts)
    Qs = np.roll(Rsc.from_matrix(Rs).as_quat(), 1, axis=-1)
    Vs = (traj.pose(ts + 1e-4)[0] - traj.pose(ts - 1e-4)[0]) / 2e-4
    n = int(imu_rate / rate)
    accs, gyrs = [], []
    for k in range(W):
        w_, f_ = traj.imu((np.arange(k * n, (k + 1) * n) + 1) / imu_rate)
        accs.append(f_)
        gyrs.append(w_)

    # landmarks ahead of the camera; the three unused draws keep the
    # generator where the reference window has it
    for _ in range(3):
        rng.uniform(0, 1, F)
    f32 = lambda a: np.asarray(a, np.float32)
    Ps32, Qs32 = f32(Ps), f32(Qs)
    R0 = Rsc.from_quat(np.roll(Qs32[0], -1)).as_matrix()
    Xw = []
    for _ in range(F):
        d = rng.uniform(3, 9)
        n_ = np.array([1.0, rng.uniform(-0.4, 0.4), rng.uniform(-0.3, 0.3)])
        Xw.append(Ps32[0] + R0 @ (n_ / np.linalg.norm(n_) * d))
    Xw = np.stack(Xw)
    obs = np.zeros((F, W + 1, 2), np.float32)
    obs_valid = np.zeros((F, W + 1), bool)
    inv_depth = np.zeros(F, np.float32)
    for k in range(W + 1):
        Rk = Rsc.from_quat(np.roll(Qs32[k], -1)).as_matrix()
        Xc = (Xw - Ps32[k]) @ Rk
        z = Xc[:, 2]
        obs[:, k] = Xc[:, :2] / np.maximum(z[:, None], 1e-6)
        obs_valid[:, k] = z > 0.5
        if k == 0:
            inv_depth = (1.0 / np.maximum(z, 1e-3)).astype(np.float32)
    return dict(Ps=Ps32, Qs=Qs32, Vs=f32(Vs), imu_dt=np.float32(1.0 / imu_rate),
                accs=f32(np.stack(accs)), gyrs=f32(np.stack(gyrs)),
                obs=obs, obs_valid=obs_valid, inv_depth=inv_depth)


def consistent_window(W: int = 4, F: int = 24, seed: int = 0, device=None):
    """`consistent_window_arrays` as the estimator's objects on `device` (the
    card unless named): (caps, cfg, ws, pints, table, G), the preintegrations
    made by the port's own ``preintegrate`` at the estimator's default
    noise."""
    import torch

    from ..core.device import resolve
    from ..models.vio import estimator as est
    from ..models.vio import feature_manager as fm
    from ..ops import ba
    from ..ops import preintegration as pre

    device = resolve(device)
    a = consistent_window_arrays(W, F, seed)
    t = lambda x: torch.as_tensor(x, device=device)
    caps = fm.VioCaps(window=W, max_features=F, imu_buf=16, frame_features=F)
    cfg = ba.BAConfig(window=W, max_features=F, iterations=6,
                      estimate_td=False, estimate_extrinsic=False)
    params = est.VioParams(g_norm=GRAVITY)
    ws = ba._zero_ws(cfg, torch.float32, device)._replace(
        Ps=t(a["Ps"]), Qs=t(a["Qs"]), Vs=t(a["Vs"]))
    noise = pre.ImuNoise.create(params.acc_n, params.gyr_n, params.acc_w, params.gyr_w,
                                device=device)
    accs, gyrs = t(a["accs"]), t(a["gyrs"])
    z3 = torch.zeros(3, device=device)
    dts = torch.full(accs.shape[:2], float(a["imu_dt"]), device=device)
    pints = pre.preintegrate(pre.preint_init(accs[:, 0], gyrs[:, 0], z3, z3), dts, accs,
                             gyrs, noise)
    table = fm.table_init(caps, device=device)._replace(
        ids=torch.arange(F, dtype=torch.int32, device=device),
        obs=t(a["obs"]), obs_valid=t(a["obs_valid"]), inv_depth=t(a["inv_depth"]))
    G = torch.tensor([0.0, 0.0, params.g_norm], device=device)
    return caps, cfg, ws, pints, table, G


# ---------------------------------------------------------------------------
# The fused system's streams (config 5)
# ---------------------------------------------------------------------------

def _u8(img: np.ndarray) -> np.ndarray:
    """Quantize a float image as the frame packer does (`frame_step.pack_frame`)."""
    return np.clip(np.round(np.asarray(img) * 255.0), 0, 255).astype(np.uint8)


def lvi_sequence_jobs(duration: float = 12.0, horizon: int = 900, width: int = 320,
                     height: int = 240, f: float = 200.0, cam=None, world_seed: int = 0,
                     scale: float = 3.0, period: float = 30.0):
    """The fused system's sensor streams on the figure-8 (the bench's config-5
    sequences), split into the IMU part (made here) and the raycasts, to run
    anywhere: 200 Hz IMU with its attitude (rpy) at (i + 1) / 200 s, a
    4-beam lidar sweep of `horizon` columns every 0.1 s from 0.05 s and an
    8-bit frame every 0.1 s from 0.1 s (a centered pinhole at (width,
    height, f), or the camera model `cam` at its own size), int(duration *
    10) - 1 of each. Returns (head, jobs): map ``run_job`` over the jobs,
    then ``lvi_sequence_join(head, results)``."""
    traj = figure8_trajectory(scale=scale, period=period)
    imu_ts = (np.arange(int(duration * 200)) + 1) / 200
    w_all, f_all = traj.imu(imu_ts)
    rpys = np.stack([
        Rsc.from_matrix(traj.pose(np.array([t]))[1][0]).as_euler("ZYX")[::-1]
        for t in imu_ts]).astype(np.float32)
    n = int(duration * 10) - 1
    scan_ts = [0.05 + i / 10 for i in range(n)]
    img_ts = [0.1 + i / 10 for i in range(n)]
    head = dict(imu_ts=imu_ts, w=w_all, f=f_all, rpys=rpys, scan_ts=scan_ts, img_ts=img_ts)
    scene = (world_seed, scale, period)
    return head, ([("scan", scene, t, horizon, 0.1) for t in scan_ts]
                  + [("image", scene, t, width, height, f, cam) for t in img_ts])


def lvi_sequence_join(head: dict, results: list) -> dict:
    """The stream dict: imu_ts, w, f, rpys, scans [(t, scan)], imgs [(t, u8)]."""
    n = len(head["scan_ts"])
    return dict(imu_ts=head["imu_ts"], w=head["w"], f=head["f"], rpys=head["rpys"],
                scans=list(zip(head["scan_ts"], results[:n])),
                imgs=list(zip(head["img_ts"], results[n:])))


def lvi_sequence(duration: float = 12.0, horizon: int = 900, cam=None, **kw) -> dict:
    """``lvi_sequence_jobs`` run here; the defaults are the 12 s parity
    sequence (`bench.py:_lvi_seq_data`)."""
    head, jobs = lvi_sequence_jobs(duration, horizon, cam=cam, **kw)
    return lvi_sequence_join(head, [run_job(j) for j in jobs])


_SCENES: dict = {}


def _scene(key):
    """(world, trajectory) of (world_seed, scale, period), built once a
    process (jobs carry the key: a trajectory's functions do not pickle)."""
    if key not in _SCENES:
        seed, scale, period = key
        _SCENES[key] = (default_world(seed=seed), figure8_trajectory(scale=scale, period=period))
    return _SCENES[key]


def run_job(job):
    """One raycast of a stream, anywhere (a worker process included):
    ("scan", scene, t, horizon, sweep_time) -> a 4-beam lidar sweep;
    ("image", scene, t, width, height, f, cam) -> an 8-bit frame (rounded);
    ("render", scene, t, width, height, f, cam) -> the float32 frame.
    `scene` is (world_seed, scale, period) of the figure-8."""
    kind, key, t, *rest = job
    world, traj = _scene(key)
    if kind == "scan":
        horizon, sweep = rest
        return simulate_lidar_scan(world, traj, t, n_scan=4, horizon=horizon, sweep_time=sweep)
    width, height, f, cam = rest
    img = render_camera_image(world, traj, t, width=width, height=height, f=f, cam=cam)
    return _u8(img) if kind == "image" else img


def feed_lvi(system, data: dict, lo: float, hi: float) -> None:
    """Publish the events of `data` (``lvi_sequence``) with lo <= t < hi to a
    fused system: IMU, then scans, then frames (the bus orders by stamp)."""
    for i, t in enumerate(data["imu_ts"]):
        if lo <= t < hi:
            system.feed_imu(t, data["w"][i], data["f"][i], rpy=data["rpys"][i])
    for t, sc in data["scans"]:
        if lo <= t < hi:
            system.feed_lidar(t, sc)
    for t, im in data["imgs"]:
        if lo <= t < hi:
            system.feed_image(t, im)


def lvi_sequence_sha256(data: dict) -> str:
    """sha256 of every array of an ``lvi_sequence`` (16 hex digits)."""
    import hashlib

    h = hashlib.sha256()
    for key in ("imu_ts", "w", "f", "rpys"):
        h.update(np.ascontiguousarray(data[key]).tobytes())
    for t, sc in data["scans"]:
        h.update(np.float64(t).tobytes())
        for key in ("xyz", "time", "ring", "intensity"):
            h.update(np.ascontiguousarray(sc[key]).tobytes())
    for t, im in data["imgs"]:
        h.update(np.float64(t).tobytes())
        h.update(np.ascontiguousarray(im).tobytes())
    return h.hexdigest()[:16]


# the revisit scene of `tests/test_loop_detector.py`: world seed 3, the
# figure-8 at period 8 s (the start is revisited at t + 8), 21 frames
LOOP_SCENE_TIMES = tuple(float(t) for t in np.arange(0.0, 8.4, 0.4))


def loop_scene():
    """(world, trajectory, stamps, float32 320x240 frames, unquantized) of
    the loop detector's revisit scene."""
    world = default_world(seed=3)
    traj = figure8_trajectory(scale=3.0, period=8.0)
    imgs = [render_camera_image(world, traj, t, width=320, height=240, f=200.0)
            for t in LOOP_SCENE_TIMES]
    return world, traj, LOOP_SCENE_TIMES, imgs


def ray_points(world: World, traj: Trajectory, t: float, kp: np.ndarray,
               f: float = 200.0, center=(160.0, 120.0)):
    """World points of pixels `kp` (K, 2) of the centered pinhole at time t,
    by raycast (10 m along the ray where it hits nothing). Returns
    (pts_w (K, 3) float32, hit (K,) bool)."""
    p, R = traj.pose(np.array([t]))
    d_cam = np.concatenate([(np.asarray(kp) - np.asarray(center)) / f,
                            np.ones((len(kp), 1))], axis=1)
    d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
    d_world = d_cam @ (R[0] @ R_CAM_BODY).T
    rng_hit = raycast(world, np.broadcast_to(p[0], d_world.shape), d_world)
    hit = np.isfinite(rng_hit)
    pts = p[0] + d_world * np.where(hit, rng_hit, 10.0)[:, None]
    return pts.astype(np.float32), hit


# ---------------------------------------------------------------------------
# Calibration boards (the camera calibration tool's inputs)
# ---------------------------------------------------------------------------

def render_board(Hm, rows, cols, H=240, W=320, blur=1.0, seed=0):
    """A checkerboard with (rows x cols) INNER corners seen through the
    homography `Hm` (board cell coordinates -> pixels), 4x4 supersampled,
    Gaussian-blurred and with noise: a copy of
    ``tests/test_chessboard.py:render_board``. Returns (float32 image, true
    corner pixels (rows*cols, 2) [x, y])."""
    from scipy.ndimage import gaussian_filter

    S = 4
    offs = (np.arange(S) + 0.5) / S - 0.5
    img = np.zeros((H, W))
    Hi = np.linalg.inv(Hm)
    for oy in offs:
        for ox in offs:
            yy, xx = np.meshgrid(np.arange(H) + oy, np.arange(W) + ox, indexing="ij")
            u = Hi[0, 0] * xx + Hi[0, 1] * yy + Hi[0, 2]
            v = Hi[1, 0] * xx + Hi[1, 1] * yy + Hi[1, 2]
            w = Hi[2, 0] * xx + Hi[2, 1] * yy + Hi[2, 2]
            u, v = u / w, v / w
            inside = (u > 0) & (u < cols + 1) & (v > 0) & (v < rows + 1)
            checker = ((np.floor(u) + np.floor(v)) % 2).astype(np.float64)
            img += np.where(inside, checker, 0.7)
    img /= S * S
    img = gaussian_filter(img, blur)
    img += np.random.default_rng(seed).normal(0, 0.01, img.shape)

    ii, jj = np.meshgrid(np.arange(1, rows + 1), np.arange(1, cols + 1), indexing="ij")
    pts = np.stack([jj.ravel(), ii.ravel(), np.ones(rows * cols)])
    pix = Hm @ pts
    return img.astype(np.float32), (pix[:2] / pix[2]).T


def board_view_homography(rvec, tvec, f, cx, cy, square):
    """Board cell coordinates (inner corner (j+1, i+1)) -> pixels of a pinhole
    (f, cx, cy) seeing the board plane z = 0 at pose (rvec, tvec); as
    ``tests/test_chessboard_calibration_e2e.py:view_homography``."""
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    R = Rsc.from_rotvec(rvec).as_matrix()
    Rt = np.column_stack([R[:, 0], R[:, 1], tvec])
    S = np.array([[square, 0, -square], [0, square, -square], [0, 0, 1.0]])
    Hm = K @ Rt @ S
    return Hm / Hm[2, 2]


def calibration_board_poses(n_views: int = 8, seed: int = 4):
    """The strongly tilted board poses of
    ``tests/test_chessboard_calibration_e2e.py`` (rvec, tvec) a view."""
    rng = np.random.default_rng(seed)
    views = []
    for _ in range(n_views):
        rv = np.array([rng.uniform(0.2, 0.35) * rng.choice([-1, 1]),
                       rng.uniform(0.2, 0.35) * rng.choice([-1, 1]),
                       rng.uniform(-0.3, 0.3)])
        tv = np.array([rng.uniform(-0.135, -0.105), rng.uniform(-0.105, -0.075),
                       rng.uniform(0.42, 0.65)])
        views.append((rv, tv))
    return views


def calibration_views(project, intr_true, n_views: int = 8, seed: int = 0):
    """Synthetic board observations of ``tests/test_calibration.py:
    synth_views``: a 7 x 5 grid of 5 cm cells seen from `n_views` random
    poses, projected by `project(pts_cam (N, 3) float32) -> (N, 2)` (the
    camera under test) with 0.1 px noise. Returns (board (N, 2) float32,
    image points (V, N, 2), rvecs (V, 3), tvecs (V, 3))."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(7) * 0.05, np.arange(5) * 0.05)
    board = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    obj = np.concatenate([board, np.zeros((len(board), 1), np.float32)], -1)
    rvecs, tvecs, img_pts = [], [], []
    for _ in range(n_views):
        rv = rng.uniform(-0.3, 0.3, 3)
        rv[2] = rng.uniform(-0.5, 0.5)
        tv = np.array([rng.uniform(-0.1, 0.0), rng.uniform(-0.1, 0.0),
                       rng.uniform(0.4, 0.8)])
        R = Rsc.from_rotvec(rv).as_matrix()
        pc = obj @ R.T + tv
        uv = np.asarray(project(np.asarray(pc, np.float32)))
        uv = uv + rng.normal(0, 0.1, uv.shape)
        rvecs.append(rv)
        tvecs.append(tv)
        img_pts.append(uv)
    return board, np.stack(img_pts), np.stack(rvecs), np.stack(tvecs)
