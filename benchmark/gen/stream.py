"""One lap of sensor data, made on the card and handed over as host arrays.

The port's stream makers (``synthetic.simulate_lidar_scan``,
``render_camera_image`` with the MEI ray grid, ``lvi_sequence_jobs``,
``bench_inputs.scan_jobs``) as batched torch calls: every scan of a lap is
raycast in a few launches, every frame in one or two. The figure-8 is
periodic, so a lap replayed with its stamps advanced by the period is the
rig driving the same route again (``Lap.scan`` / ``Lap.events``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import world as W

# the rendered camera's axes in the body frame: camera x right, y down,
# z forward; body x forward, y left, z up (``synthetic.R_CAM_BODY``)
R_CAM_BODY = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float).T
ELEV_DEG = 12.0  # the 4 beams span -12..12 degrees
SCAN_CHUNK, FRAME_CHUNK = 32, 1  # scans / frames a raycast call


@dataclasses.dataclass
class Lap:
    """One lap: `period` seconds of scans (and for the fused system IMU
    samples and frames). Scan k's stamp is ``scan_t[k]``; lap L adds
    L x period to every stamp."""

    period: float
    scan_t: np.ndarray  # (S,) float64 stamps within the lap
    scans: list  # dicts: xyz (n, 3) f32, time (n,) f32, ring (n,) i32, intensity (n,) f32
    scan_imu: list | None = None  # LIO: (rel. times (23,), gyro (23, 3), rpy (3,)) f32
    imu_t: np.ndarray | None = None  # fused: (M,) float64 IMU stamps
    imu_w: np.ndarray | None = None  # (M, 3) float64 gyro
    imu_f: np.ndarray | None = None  # (M, 3) float64 specific force
    imu_rpy: np.ndarray | None = None  # (M, 3) float32 attitude
    frame_t: np.ndarray | None = None  # (F,) float64 frame stamps
    frames: list | None = None  # (H, W) uint8 images

    def scan(self, i: int):
        """(stamp, scan dict) of the i-th scan of the replayed stream."""
        lap, k = divmod(i, len(self.scan_t))
        stamp = float(self.scan_t[k] + lap * self.period)
        return stamp, dict(self.scans[k], stamp=stamp)

    def events(self, lookahead: float):
        """The fused stream in stamp order, lap after lap, without end:
        (stamp, kind, index in the lap, imu indices to feed first), where
        kind is "lidar" or "image" and the IMU samples fed before an event
        reach `lookahead` seconds past it (the scan handler reads its sweep's
        IMU, up to 0.15 s after its stamp)."""
        kinds = sorted([(t, 0, "lidar", k) for k, t in enumerate(self.scan_t)]
                       + [(t, 1, "image", k) for k, t in enumerate(self.frame_t)])
        M, fed, lap = len(self.imu_t), 0, 0
        while True:
            base = lap * self.period
            for t, _, kind, k in kinds:
                stamp = t + base
                hi = fed
                while self.imu_t[hi % M] + (hi // M) * self.period <= stamp + lookahead:
                    hi += 1
                yield stamp, kind, k, range(fed, hi)
                fed = hi
            lap += 1

    def imu_sample(self, j: int):
        """(stamp, gyro, acc, rpy) of the j-th IMU sample of the stream."""
        lap, k = divmod(j, len(self.imu_t))
        return (float(self.imu_t[k] + lap * self.period), self.imu_w[k], self.imu_f[k],
                self.imu_rpy[k])


def _beams(n_scan: int, horizon: int, device) -> torch.Tensor:
    """Unit beam directions in the body frame, (horizon, n_scan, 3)."""
    elev = torch.deg2rad(torch.linspace(-ELEV_DEG, ELEV_DEG, n_scan, dtype=torch.float64,
                                        device=device))
    az = torch.linspace(0, 2 * math.pi, horizon + 1, dtype=torch.float64, device=device)[:-1]
    ce, se = torch.cos(elev)[None, :], torch.sin(elev)[None, :]
    return torch.stack([ce * torch.cos(az)[:, None], ce * torch.sin(az)[:, None],
                        se.expand(horizon, n_scan)], dim=-1)


def scans(world: W.World, traj: W.Figure8, t_start: np.ndarray, n_scan: int, horizon: int,
          sweep: float, device) -> list:
    """``simulate_lidar_scan`` of each start stamp: each azimuth step fires
    all beams from the pose at its own time, so the skew is real; the points
    are in the sensor frame at their measurement time, ordered by time and
    then by beam. Returns the scan dicts (host arrays)."""
    d_body = _beams(n_scan, horizon, device)
    frac = torch.arange(horizon, dtype=torch.float64, device=device) / horizon
    out = []
    for lo in range(0, len(t_start), SCAN_CHUNK):
        t0 = torch.as_tensor(t_start[lo:lo + SCAN_CHUNK], dtype=torch.float64, device=device)
        times = t0[:, None] + sweep * frac  # (S, H)
        p, R = traj.pose(times)
        d_world = torch.einsum("shij,hrj->shri", R, d_body)
        S = len(t0)
        rng = W.raycast(world, p[:, :, None].expand(S, horizon, n_scan, 3).reshape(-1, 3),
                        d_world.reshape(-1, 3)).reshape(S, horizon, n_scan)
        hit = torch.isfinite(rng)
        xyz = (d_body * torch.where(hit, rng, 0.0)[..., None]).to(torch.float32)
        rel = (times - t0[:, None]).to(torch.float32)
        hit, xyz, rel = hit.cpu().numpy(), xyz.cpu().numpy(), rel.cpu().numpy()
        ring = np.broadcast_to(np.arange(n_scan, dtype=np.int32), (horizon, n_scan))
        for s in range(S):
            m = hit[s]
            n = int(m.sum())
            out.append(dict(xyz=np.ascontiguousarray(xyz[s][m]),
                            time=np.broadcast_to(rel[s][:, None], m.shape)[m].copy(),
                            ring=ring[m].copy(), intensity=np.ones(n, np.float32)))
    return out


# ---------------------------------------------------------------------------
# Camera frames
# ---------------------------------------------------------------------------

def _radtan(p, k1, k2, p1, p2):
    mx2, my2, mxy = p[..., 0] * p[..., 0], p[..., 1] * p[..., 1], p[..., 0] * p[..., 1]
    rho2 = mx2 + my2
    rad = k1 * rho2 + k2 * rho2 * rho2
    return torch.stack([p[..., 0] * rad + 2.0 * p1 * mxy + p2 * (rho2 + 2.0 * mx2),
                        p[..., 1] * rad + 2.0 * p2 * mxy + p1 * (rho2 + 2.0 * my2)], dim=-1)


def mei_rays(cam: dict, device) -> torch.Tensor:
    """Unit ray (H*W, 3) float64 of every pixel of a MEI camera (`cam`: the
    configuration's camera block): camodocal's ``CataCamera::liftProjective``
    (8-step radtan inverse, the mirror's xi) in float32, as the port's
    ``synthetic.camera_ray_grid`` computes it, then normalized in float64."""
    if cam["model_type"] != "MEI":
        raise ValueError(f"the stream renders MEI cameras, not {cam['model_type']}")
    v, u = torch.meshgrid(torch.arange(cam["image_height"], device=device),
                          torch.arange(cam["image_width"], device=device), indexing="ij")
    uv = torch.stack([u, v], dim=-1).reshape(-1, 2).to(torch.float32)
    pd = torch.stack([(uv[:, 0] - cam["u0"]) / cam["gamma1"],
                      (uv[:, 1] - cam["v0"]) / cam["gamma2"]], dim=-1)
    k = (cam["k1"], cam["k2"], cam["p1"], cam["p2"])
    pu = pd - _radtan(pd, *k)
    for _ in range(7):
        pu = pd - _radtan(pu, *k)
    rho2 = pu[:, 0] * pu[:, 0] + pu[:, 1] * pu[:, 1]
    xi = cam["xi"]
    lam = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * rho2)) / (1.0 + rho2)
    ps = torch.cat([lam[:, None] * pu, (lam - xi)[:, None]], dim=-1)
    ps = ps / torch.sqrt((ps * ps).sum(-1, keepdim=True))
    rays = ps.to(torch.float64)
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


def texture(pts: torch.Tensor) -> torch.Tensor:
    """``synthetic.procedural_texture``: a smooth multi-frequency paint of
    3D positions, float32 in about [0.05, 0.95]."""
    def dot(v):
        return pts @ torch.tensor(v, dtype=pts.dtype, device=pts.device)
    v = (torch.sin(dot([1.7, 2.9, 1.3])) * 0.45 + torch.sin(dot([4.1, 3.3, 5.7]) + 1.3) * 0.35
         + torch.sin(dot([8.9, 7.1, 11.3]) + 2.1) * 0.2)
    return (0.5 + 0.45 * v).to(torch.float32)


def frames(world: W.World, traj: W.Figure8, stamps: np.ndarray, cam: dict, device) -> list:
    """8-bit frames (``synthetic._u8(render_camera_image(..., cam=cam))``)
    of the body-mounted camera (``R_CAM_BODY``, at the body origin)."""
    rays = mei_rays(cam, device)
    H, Wd = cam["image_height"], cam["image_width"]
    rcb = torch.as_tensor(R_CAM_BODY, dtype=torch.float64, device=device)
    out = []
    for lo in range(0, len(stamps), FRAME_CHUNK):
        t = torch.as_tensor(stamps[lo:lo + FRAME_CHUNK], dtype=torch.float64, device=device)
        p, R = traj.pose(t)
        d_world = torch.einsum("nd,fjd->fnj", rays, R @ rcb)  # d_cam @ R_wc^T
        F = len(t)
        o = p[:, None].expand(F, rays.shape[0], 3).reshape(-1, 3)
        rng = W.raycast(world, o, d_world.reshape(-1, 3))
        hit = torch.isfinite(rng)
        pts = o + d_world.reshape(-1, 3) * torch.where(hit, rng, 0.0)[:, None]
        img = torch.where(hit, texture(pts), 0.0).reshape(F, H, Wd)
        u8 = torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8).cpu().numpy()
        out.extend(u8[i] for i in range(F))
    return out


# ---------------------------------------------------------------------------
# Laps
# ---------------------------------------------------------------------------

def lio_lap(seed: int, motion: dict, lidar: dict, device, limit: int | None = None) -> Lap:
    """One lap of the LIO stream (``bench_inputs.scan_jobs`` at the lap's
    length): a scan every 1 / rate s from 0, with the IMU window the bench
    gives each scan (23 gyro samples at 200 Hz from 5 ms before its stamp,
    times relative to it) and the attitude at its stamp. `limit` makes only
    the lap's first scans (a test's short run)."""
    world = W.default_world(seed, device)
    traj = W.Figure8(motion["scale"], motion["period"])
    n = int(round(motion["period"] * lidar["rate_hz"]))
    n = n if limit is None else min(n, limit)
    t = np.arange(n) / lidar["rate_hz"]
    sc = scans(world, traj, t, lidar["n_scan"], lidar["horizon"], 1.0 / lidar["rate_hz"],
               device)
    rel = -0.005 + np.arange(23) * 0.005
    tt = torch.as_tensor(t, dtype=torch.float64, device=device)
    w, _ = traj.imu(tt[:, None] + torch.as_tensor(rel, dtype=torch.float64, device=device))
    rpy = traj.rpy(tt)
    w, rpy = w.to(torch.float32).cpu().numpy(), rpy.to(torch.float32).cpu().numpy()
    imu = [(rel.astype(np.float32), w[k], rpy[k]) for k in range(n)]
    return Lap(period=motion["period"], scan_t=t, scans=sc, scan_imu=imu)


def lvi_lap(seed: int, motion: dict, lidar: dict, camera: dict, imu_hz: float, device,
            limit: int | None = None) -> Lap:
    """One lap of the fused stream (``synthetic.lvi_sequence_jobs`` over a
    whole period): IMU with its attitude at (i + 1) / imu_hz, a sweep every
    0.1 s from 0.05 s, an 8-bit frame every 0.1 s from 0.1 s. `limit`
    makes only the first scans and frames."""
    world = W.default_world(seed, device)
    traj = W.Figure8(motion["scale"], motion["period"])
    P = motion["period"]
    rate = lidar["rate_hz"]
    n = int(round(P * rate))
    n = n if limit is None else min(n, limit)
    scan_t = 0.5 / rate + np.arange(n) / rate
    frame_t = 1.0 / rate + np.arange(n) / rate
    imu_t = (np.arange(int(round(P * imu_hz))) + 1) / imu_hz
    ti = torch.as_tensor(imu_t, dtype=torch.float64, device=device)
    w, f = traj.imu(ti)
    return Lap(period=P, scan_t=scan_t,
               scans=scans(world, traj, scan_t, lidar["n_scan"], lidar["horizon"], 1.0 / rate,
                           device),
               imu_t=imu_t, imu_w=w.cpu().numpy(), imu_f=f.cpu().numpy(),
               imu_rpy=traj.rpy(ti).to(torch.float32).cpu().numpy(),
               frame_t=frame_t, frames=frames(world, traj, frame_t, camera, device))
