"""Run the full LVI system on the synthetic world and report ATE and rates —
the port of ``scripts/run_synthetic_lvi.py``.

Usage:
  python -m lvislam_tpu_torch.scripts.run_synthetic_lvi [duration_s] \\
      [--save-map DIR] [--checkpoint PATH] [--html PATH] [--device cpu]

The same arguments and steps as the JAX script, plus ``--device``: the card
(``cuda``) unless given, and without one it raises; ``--device cpu`` runs on
the CPU. The system is `system_config()`, the port's own copy of the
configuration of ``tests/test_lvi_system.py:make_system`` (the JAX script
imports it from the test tree). 200 Hz IMU with its attitude, a 4 x 900
lidar sweep and a 320x240 frame every 0.1 s of the figure-8 (3 m / 30 s) in
world seed 0, rendered on the host as the script goes.

``--save-map`` writes `utils/checkpoint.save_map_service`'s files (PCDs,
TUM keyframes, the top-down PPM and the HTML viewer), ``--checkpoint`` the
LIO state (`save_state`), ``--html`` a viewer of the map with the estimated
and the true trajectory (`utils/debugviz.export_html_viewer`).
``main(argv)`` runs it in-process and returns the system and its numbers.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
from scipy.spatial.transform import Rotation as Rsc

from ..core.config import CameraIntrinsics
from ..models import pipeline as lvi
from ..models.lio import mapping
from ..models.lio.pipeline import LioConfig
from ..models.loop import loop_detector as ld
from ..models.vio import estimator as est
from ..models.vio import feature_manager as fm
from ..models.vio import feature_tracker as ft
from ..ops import ba
from ..utils import synthetic as syn
from ..utils.metrics import ate_rmse


def system_config() -> lvi.LviConfig:
    """The fused system of ``tests/test_lvi_system.py:make_system``, field
    for field: 4 x 900 scans in 4096 points, 64 keyframes, the 320x240
    pinhole at f = 200 with the renderer's camera mount, VIO window 10 x 128
    slots and 64 features, BA 4 iterations, the loop detector off, K1 and
    K2 off."""
    lio_cfg = LioConfig(
        n_scan=4, horizon=900, point_capacity=4096,
        caps=mapping.LioCaps(
            max_keyframes=64, kf_corner=256, kf_surf=1024, sel_keyframes=16,
            map_corner=4096, map_surf=16384, scan_corner=512, scan_surf=2048,
            max_loops=8, max_gps=8, loop_submap=4096, icp_iters=10,
        ),
        params=mapping.LioParams(
            keyframeAddingDistThreshold=0.3, keyframeAddingAngleThreshold=0.1,
            livox_keyframe_interval=0.5, degeneracyEigenThreshold=25.0,
        ),
        loop_every_n_scans=20,
    )
    cam = CameraIntrinsics(
        model_type="PINHOLE", gamma1=200.0, gamma2=200.0, u0=160.0, v0=120.0,
        k1=0.0, k2=0.0, p1=0.0, p2=0.0, image_width=320, image_height=240,
    )
    qic = np.roll(Rsc.from_matrix(syn.R_CAM_BODY).as_quat(), 1)
    return lvi.LviConfig(
        lio=lio_cfg,
        vio_caps=fm.VioCaps(window=10, max_features=128, imu_buf=32, frame_features=64),
        vio_params=est.VioParams(g_norm=syn.GRAVITY),
        ba=ba.BAConfig(window=10, max_features=128, iterations=4,
                       estimate_td=False, estimate_extrinsic=False),
        tracker=ft.TrackerParams(max_cnt=64, min_dist=16, klt_levels=2,
                                 klt_half=7, klt_iters=20, equalize=False),
        camera=cam,
        loop_caps=ld.LoopCaps(max_keyframes=128, window_points=64,
                              extra_points=128, recent_exclude=10,
                              min_loop_matches=15),
        image_height=240, image_width=320,
        use_lidar_depth=True, lidar_skip=1,
        use_loop_detector=False,
        qic=tuple(qic.tolist()),
    )


def feed_world(system, duration: float, world=None, traj=None):
    """Publish `duration` seconds of the synthetic streams to `system` in the
    JAX script's order (all IMU, then the scans, then the frames)."""
    world = syn.default_world(seed=0) if world is None else world
    traj = syn.figure8_trajectory(scale=3.0, period=30.0) if traj is None else traj
    imu_ts = (np.arange(int(duration * 200)) + 1) / 200
    w_all, f_all = traj.imu(imu_ts)
    for i, t in enumerate(imu_ts):
        _, R = traj.pose(np.array([t]))
        rpy = Rsc.from_matrix(R[0]).as_euler("ZYX")[::-1]
        system.feed_imu(t, w_all[i], f_all[i], rpy=np.array(rpy, np.float32))
    for i in range(int(duration * 10) - 1):
        ts = 0.05 + i / 10
        system.feed_lidar(ts, syn.simulate_lidar_scan(
            world, traj, ts, n_scan=4, horizon=900, sweep_time=0.1))
    for i in range(int(duration * 10) - 1):
        ts = 0.1 + i / 10
        system.feed_image(ts, syn.render_camera_image(
            world, traj, ts, width=320, height=240, f=200.0))
    return traj


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lvislam_tpu_torch.scripts.run_synthetic_lvi")
    ap.add_argument("duration", nargs="?", type=float, default=6.0)
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--html", default=None,
                    help="standalone interactive 3D viewer (map + est "
                         "trajectory + GT overlay)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu to run on the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run it; returns {"system", "ate_m", "wall_s", "est" (T, 3), "gt" (T, 3),
    "map" (`save_map_service`'s summary or None), "checkpoint", "html"
    (paths written or None)}."""
    args = parse_args(argv)
    sys_ = lvi.LviSystem(system_config(), device=args.device)
    d = args.duration
    traj = feed_world(sys_, d)

    t0 = time.time()
    sys_.run()
    wall = time.time() - t0

    est_pos = np.stack([np.asarray(x6)[3:6] for _, x6 in sys_.trajectory])
    gt = np.stack([traj.pose(np.array([t]))[0][0] for t, _ in sys_.trajectory])
    ate = ate_rmse(est_pos, gt)
    print(f"duration={d}s wall={wall:.1f}s rtf={d / wall:.2f}x "
          f"ATE={ate:.3f}m scans={len(sys_.trajectory)} "
          f"imu_rate_odom={len(sys_.imu_rate_odom)} "
          f"vio_init={bool(sys_.vio.initialized)} "
          f"failures={int(sys_.vio.failure_count)}")

    out = dict(system=sys_, ate_m=ate, wall_s=wall, est=est_pos, gt=gt, map=None,
               checkpoint=None, html=None)
    if args.save_map:
        from ..utils.checkpoint import save_map_service

        out["map"] = save_map_service(sys_.lio.state, args.save_map)
        print(out["map"])
    if args.checkpoint:
        from ..utils.checkpoint import save_state

        save_state(args.checkpoint, sys_.lio.state)
        out["checkpoint"] = args.checkpoint
        print("checkpoint ->", args.checkpoint)
    if args.html:
        from ..utils.checkpoint import global_map_points
        from ..utils.debugviz import export_html_viewer

        corner, surf = global_map_points(sys_.lio.state)
        gmap = np.concatenate([corner, surf]) if len(corner) else surf
        out["html"] = export_html_viewer(args.html, est_pos, map_xyz=gmap, gt=gt)
        print("viewer ->", out["html"])
    return out


if __name__ == "__main__":
    main()
