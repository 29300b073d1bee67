"""Visual-inertial-only runner — port of ``lvislam_tpu.models.vio.pipeline``:
camera + IMU in, tracked features + VIO states out (the estimator node +
feature tracker pair without the lidar subsystems)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.config import CameraIntrinsics
from ...core.device import resolve as resolve_device
from ...core.hostsync import host_bool
from ...ops import ba
from . import estimator as est
from . import feature_manager as fm
from . import feature_tracker as ft


@dataclasses.dataclass
class VioRunnerConfig:
    camera: CameraIntrinsics = dataclasses.field(default_factory=CameraIntrinsics)
    tracker: ft.TrackerParams = dataclasses.field(default_factory=ft.TrackerParams)
    caps: fm.VioCaps = dataclasses.field(default_factory=fm.VioCaps)
    params: est.VioParams = dataclasses.field(default_factory=est.VioParams)
    ba: ba.BAConfig = dataclasses.field(default_factory=ba.BAConfig)
    image_height: int = 480
    image_width: int = 752
    freq: float = 10.0  # publish/process throttle
    tic: tuple = (0.0, 0.0, 0.0)
    qic: tuple = (1.0, 0.0, 0.0, 0.0)
    max_stream_gap: float = 1.0  # restart protocol


class VioRunner:
    """Feeds IMU samples and camera frames to the tracker and the estimator
    on `device` (the card unless named). `frame_count` is the host copy of
    the estimator's window fill. A processed frame goes through `track`,
    `propagate` and `estimate` in turn."""

    def __init__(self, cfg: VioRunnerConfig, device=None, sampler: ft.Sampler | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.sampler = sampler
        self._reset()
        self.trajectory: list[tuple] = []

    def _reset(self):
        cfg, dev = self.cfg, self.device
        self.tracker = ft.tracker_init(cfg.image_height, cfg.image_width, cfg.tracker, device=dev)
        vio = est.vio_init(cfg.caps, cfg.params, device=dev)
        self.vio = vio._replace(ws=vio.ws._replace(
            tic=torch.tensor(cfg.tic, dtype=torch.float32, device=dev),
            qic=torch.tensor(cfg.qic, dtype=torch.float32, device=dev),
        ))
        self.frame_count = 0
        self._no_seed = dict(
            available=False, Ps=self.vio.ws.Ps, Qs=self.vio.ws.Qs, Vs=self.vio.ws.Vs,
            ba=self.vio.ws.Bas[0], bg=self.vio.ws.Bgs[0],
        )
        self._no_depth = torch.full((cfg.caps.frame_features,), -1.0, device=dev)
        self.imu_t: list[float] = []
        self.imu_acc: list[np.ndarray] = []
        self.imu_gyr: list[np.ndarray] = []
        self.last_proc = -1.0
        self.last_img = -1.0

    def feed_imu(self, t, gyro, acc):
        self.imu_t.append(float(t))
        self.imu_gyr.append(np.asarray(gyro, np.float32))
        self.imu_acc.append(np.asarray(acc, np.float32))
        if len(self.imu_t) > 20000:
            del self.imu_t[:5000], self.imu_gyr[:5000], self.imu_acc[:5000]

    def _imu_window(self, t):
        """The zero-padded (dts, accs, gyrs) of the samples in
        (last_proc, t], at most `imu_buf` of them; None when there are none."""
        M = self.cfg.caps.imu_buf
        ts = np.asarray(self.imu_t)
        if not (self.last_proc > 0 and len(ts)):
            return None
        sel = np.nonzero((ts > self.last_proc) & (ts <= t))[0][:M]
        n = len(sel)
        if not n:
            return None
        dts = np.zeros(M, np.float32)
        accs = np.zeros((M, 3), np.float32)
        gyrs = np.zeros((M, 3), np.float32)
        dts[:n] = np.diff(ts[sel], prepend=self.last_proc)
        accs[:n] = np.stack([self.imu_acc[i] for i in sel])
        gyrs[:n] = np.stack([self.imu_gyr[i] for i in sel])
        accs[n:] = accs[n - 1]
        gyrs[n:] = gyrs[n - 1]
        return tuple(torch.from_numpy(a).to(self.device) for a in (dts, accs, gyrs))

    def track(self, t, image) -> ft.TrackerOutput:
        """The tracker's step on one frame."""
        cfg = self.cfg
        img = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        self.tracker, tout = ft.tracker_step(self.tracker, img, t, cfg.tracker, cfg.camera,
                                             sampler=self.sampler)
        return tout

    def propagate(self, t):
        """`process_imu` over the samples since the last processed frame."""
        window = self._imu_window(t)
        if window is not None:
            self.vio = est.process_imu(self.vio, *window, self.cfg.caps, self.cfg.params,
                                       frame_count=self.frame_count)
        self.last_proc = t

    def estimate(self, t, tout: ft.TrackerOutput):
        """`process_image` on the tracker's output; logs an initialized pose."""
        cfg = self.cfg
        N = cfg.caps.frame_features
        ids = tout.ids[:N]
        if ids.shape[0] < N:
            ids = torch.cat([ids, torch.full((N - ids.shape[0],), -1, dtype=ids.dtype,
                                             device=ids.device)])
        self.vio, out = est.process_image(
            self.vio, ids, tout.norm[:N], tout.vel[:N], self._no_depth, tout.valid[:N],
            self._no_seed, cfg.caps, cfg.params, cfg.ba, frame_count=self.frame_count,
            sampler=self.sampler,
        )
        self.frame_count = out["frame_count"]
        if host_bool(out["initialized"]):
            self.trajectory.append((t, out["pos"].cpu().numpy(), out["quat"].cpu().numpy()))
        return out

    def feed_image(self, t, image):
        cfg = self.cfg
        # stream-gap restart
        if self.last_img > 0 and (t - self.last_img) > cfg.max_stream_gap:
            fc = self.vio.failure_count
            self._reset()
            self.vio = self.vio._replace(failure_count=fc + 1)
        self.last_img = t
        tout = self.track(t, image)
        # FREQ throttle: every frame is tracked, frames go on at FREQ
        if self.last_proc > 0 and (t - self.last_proc) < 1.0 / cfg.freq - 1e-6:
            return None
        self.propagate(t)
        return self.estimate(t, tout)
