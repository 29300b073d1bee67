"""The configurations and streams of the port's benchmark
(``lvislam_tpu_torch.scripts.bench``), in one place: ``chip_smoke.py``
imports them from here.

- ``full_width_config``: the LIO configuration of ``bench.py:_make_cfg`` at
  full width with K1 and K2 on.
- ``scan_jobs``: the bench's 91 scans (``bench.py:_gen_scans``) as raycast
  jobs; ``Prefetch`` runs jobs in a process pool (``stream_pool``) while
  the card works, ``lvi_stream`` the fused system's streams.
- ``lvi_parity_config``, ``lvi_full_config``, ``lvi_loop_config``: config 5
  at the parity scale, the shipped scale and on the 38 s revisit arm.
- ``imu_inputs``, ``euroc_jobs``: the inputs of the bench's ``imu`` and
  ``euroc`` sections (``bench.py:336-372``, ``:890-930``).

Nothing here touches a device: every function builds host data or
configurations, so the spawned raycasting workers can import it.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

N_SCANS, RATE = 91, 10.0  # the LIO replay: scans, Hz (`bench.py:1014-1020`)
STREAM_WORKERS = 4  # raycasting processes
UPLOAD_BATCH, REPLAY_BATCH = 8, 16  # `bench.py:231`, `bench.py:539` / `:733`
LOOP_KEYFRAMES, LOOP_SLOTS = 192, 16  # the loop arm's LIO capacities (`bench.py:832-833`)
EUROC_SCENE = (0, 1.5, 8.0)  # world seed, figure-8 scale and period (`bench.py:910-911`)
EUROC_T0_NS = 1_403_636_580_000_000_000  # the MH_01-era epoch of the JAX test's fixture


def full_width_config():
    """The bench's LIO configuration (`bench.py:_make_cfg`) with both
    kernels on."""
    from lvislam_tpu_torch.models.lio import mapping
    from lvislam_tpu_torch.models.lio.pipeline import LioConfig

    caps = mapping.LioCaps(
        max_keyframes=256, kf_corner=512, kf_surf=2048, sel_keyframes=32,
        map_corner=16384, map_surf=65536, scan_corner=512, scan_surf=2048,
        max_loops=16, max_gps=16, loop_submap=8192, icp_iters=20,
        pallas_knn=True, pallas_gn=True,
    )
    return LioConfig(
        n_scan=4, horizon=6000, point_capacity=24576, caps=caps,
        params=mapping.LioParams(nnRefreshEvery=2, mapRebuildEvery=8,
                                 gatherOncePerScan=True),
        loop_every_n_scans=10,
    )


class Prefetch:
    """Raycasts (`synthetic.run_job` of each job) submitted to `pool` at
    once, or run here without a pool; `get()` waits for them and returns
    `finish(results)`. A caller raycasts the streams of later work while
    the card runs earlier work."""

    def __init__(self, pool, jobs, finish):
        from lvislam_tpu_torch.utils import synthetic as syn

        self.jobs, self.finish, self.value, self.waited_s = jobs, finish, None, 0.0
        self.futures = None if pool is None else [pool.submit(syn.run_job, j) for j in jobs]

    def get(self):
        from lvislam_tpu_torch.utils import synthetic as syn

        if self.value is None:
            t0 = time.perf_counter()
            results = ([syn.run_job(j) for j in self.jobs] if self.futures is None
                       else [f.result() for f in self.futures])
            self.value = self.finish(results)
            self.waited_s = time.perf_counter() - t0
        return self.value


def scan_jobs(n_scans: int = N_SCANS):
    """The bench's first `n_scans` scans (`bench.py:_gen_scans`,
    `_lio_scans_data`) as (jobs, finish): finish gives [(scan, IMU rel.
    times, gyro, rpy)]."""
    from scipy.spatial.transform import Rotation as Rsc

    from lvislam_tpu_torch.utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=3.0, period=40.0)
    ts = [i / RATE for i in range(n_scans)]

    def finish(scans):
        out = []
        for t, scan in zip(ts, scans):
            it = np.arange(t - 0.005, t + 1.0 / RATE + 0.01, 1.0 / 200.0)
            w, _ = traj.imu(it)
            _, R = traj.pose(np.array([t]))
            rpy = Rsc.from_matrix(R[0]).as_euler("ZYX")[::-1]
            out.append((scan, (it - t).astype(np.float32), w.astype(np.float32),
                        np.array(rpy, np.float32)))
        return out

    return [("scan", (0, 3.0, 40.0), t, 6000, 1.0 / RATE) for t in ts], finish


def stream_pool(workers: int = STREAM_WORKERS):
    """Worker processes for the raycasts, started before the card's work
    so the host renders while the card runs (spawned: the workers never
    touch CUDA; one BLAS thread each). The caller shuts it down."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    n = max(1, min(workers, (os.cpu_count() or 2) - 2))
    return ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn"))


def lvi_stream(pool, **kw) -> Prefetch:
    """A fused-system stream (`synthetic.lvi_sequence_jobs(**kw)`)."""
    from lvislam_tpu_torch.utils import synthetic as syn

    head, jobs = syn.lvi_sequence_jobs(**kw)
    return Prefetch(pool, jobs, lambda results: syn.lvi_sequence_join(head, results))


def lvi_parity_config(kernels: bool = True):
    """Config 5 at the parity scale: `tests/test_lvi_system.py:make_system`
    (the port's copy, `run_synthetic_lvi.system_config`) with
    `bench.py:apply_perf_knobs` (throttle 0.15 s, "schur", nnRefreshEvery=2,
    mapRebuildEvery=1, K2 off). `kernels`: K1 on with `gatherOncePerScan`,
    as the bench runs it on an accelerator; without, the CPU anchor's
    settings (`utils/anchors.LVI_PARITY`)."""
    from lvislam_tpu_torch.scripts.run_synthetic_lvi import system_config

    cfg = system_config()
    lio = dataclasses.replace(
        cfg.lio,
        caps=dataclasses.replace(cfg.lio.caps, pallas_knn=kernels, pallas_gn=False),
        params=dataclasses.replace(cfg.lio.params, nnRefreshEvery=2, mapRebuildEvery=1,
                                   gatherOncePerScan=kernels))
    return dataclasses.replace(cfg, lio=lio, ba=dataclasses.replace(cfg.ba, solver="schur"),
                               mapping_process_interval=0.15)


def lvi_full_config(map_rebuild_every: int | None = None):
    """Config 5 at the shipped scale (`bench.py:668-767`): the full-width LIO
    configuration with K1 and K2 on, the MEI 1024x576 rig with
    `TrackerParams()` (CLAHE on: K3, K4), VIO window 10 x 150 features, BA
    4 iterations "schur", the loop detector on with the trained vocabulary,
    lidar_skip 3, throttle 0.15 s."""
    from scipy.spatial.transform import Rotation as Rsc

    from lvislam_tpu_torch.core.config import CameraIntrinsics
    from lvislam_tpu_torch.models import pipeline as lvi
    from lvislam_tpu_torch.models.loop import loop_detector as ld
    from lvislam_tpu_torch.models.vio import estimator as est
    from lvislam_tpu_torch.models.vio import feature_manager as fm
    from lvislam_tpu_torch.models.vio import feature_tracker as ft
    from lvislam_tpu_torch.ops import ba
    from lvislam_tpu_torch.utils import synthetic as syn

    lio = full_width_config()
    lio.upload_batch = 1
    if map_rebuild_every is not None:
        lio.params = dataclasses.replace(lio.params, mapRebuildEvery=map_rebuild_every)
    cam = CameraIntrinsics()
    qic = np.roll(Rsc.from_matrix(syn.R_CAM_BODY).as_quat(), 1)
    return lvi.LviConfig(
        lio=lio,
        vio_caps=fm.VioCaps(window=10, max_features=150, imu_buf=32, frame_features=150),
        vio_params=est.VioParams(g_norm=syn.GRAVITY),
        ba=ba.BAConfig(window=10, max_features=150, iterations=4, solver="schur",
                       estimate_td=False, estimate_extrinsic=False),
        tracker=ft.TrackerParams(), camera=cam,
        loop_caps=ld.LoopCaps(max_keyframes=128, window_points=150, extra_points=256,
                              recent_exclude=10, min_loop_matches=25),
        image_height=cam.image_height, image_width=cam.image_width,
        use_lidar_depth=True, lidar_skip=3, use_loop_detector=True,
        mapping_process_interval=0.15, qic=tuple(qic.tolist()),
    )


def lvi_loop_config(loop_on: bool = True, replay_batch: int = REPLAY_BATCH):
    """The 38 s revisit arm (`bench.py:806-887`): the parity configuration at
    `replay_batch` (`_lvi_build_system`'s 16) with a keyframe ring of 192
    and 16 loop slots; `loop_on` False is the arm without the LIS loop
    detector."""
    cfg = lvi_parity_config()
    lio = dataclasses.replace(
        cfg.lio, caps=dataclasses.replace(cfg.lio.caps, max_keyframes=LOOP_KEYFRAMES,
                                          max_loops=LOOP_SLOTS),
        loop_closure_enabled=loop_on)
    return dataclasses.replace(cfg, lio=lio, replay_batch=replay_batch)


def imu_inputs(seconds: float = 60.0, hz: int = 200):
    """`bench.py:_imu_section`'s dead-reckoning inputs as numpy arrays: the
    figure-8 (3 m, 40 s) ideal IMU stream at `hz` for `seconds`, the start
    state by a forward difference, gravity 9.805. Returns (pos0, quat0
    [w, x, y, z], vel0, dts, accs, gyrs, gravity), float32."""
    from scipy.spatial.transform import Rotation as Rsc

    from lvislam_tpu_torch.utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=3.0, period=40.0)
    ts = (np.arange(int(seconds * hz)) + 1) / hz
    gyrs, accs = traj.imu(ts)
    p0, R0 = traj.pose(ts[:1])
    v0 = (traj.pose(ts[:1] + 1e-4)[0] - p0) / 1e-4
    q = Rsc.from_matrix(R0[0]).as_quat()  # x, y, z, w
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(p0[0]), f32([q[3], q[0], q[1], q[2]]), f32(v0[0]),
            np.full(len(ts), np.float32(1.0 / hz)), f32(accs), f32(gyrs),
            f32([0.0, 0.0, -9.805]))


def euroc_jobs(seconds: float = 5.0, cam_rate: float = 10.0, imu_rate: float = 200.0):
    """The EuRoC fixture of `tests/test_euroc_e2e.py:_write_euroc_fixture`
    (`bench.py:914`): the figure-8 1.5 m / 8 s, 320x240 f = 200 renders
    every 0.1 s from 0.1 s, 200 Hz IMU, as (jobs, finish): finish gives
    (imu stamps, gyro, acc, frame stamps, 8-bit frames truncated as the
    test's writer does)."""
    from lvislam_tpu_torch.utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=EUROC_SCENE[1], period=EUROC_SCENE[2])
    ts = (np.arange(int(seconds * imu_rate)) + 1) / imu_rate
    w, f = traj.imu(ts)
    img_ts = [0.1 + i / cam_rate for i in range(int(seconds * cam_rate) - 1)]

    def finish(renders):
        return ts, w, f, img_ts, [(np.asarray(r) * 255).astype(np.uint8) for r in renders]

    return [("render", EUROC_SCENE, t, 320, 240, 200.0, None) for t in img_ts], finish
