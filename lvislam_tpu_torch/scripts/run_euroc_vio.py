"""Run mono VIO on a EuRoC ASL sequence (BASELINE configs 2/4) — the port of
``scripts/run_euroc_vio.py``.

Usage:
  python -m lvislam_tpu_torch.scripts.run_euroc_vio /path/to/MH_01_easy/mav0 \\
      [--max-seconds S] [--camera-yaml params_camera.yaml] \\
      [--out euroc_vio_trajectory.txt] [--device cpu]

The same arguments and steps as the JAX script, plus ``--device``: the card
(``cuda``) unless given, and without one it raises; ``--device cpu`` runs on
the CPU. Without --camera-yaml the public EuRoC cam0 calibration (pinhole
radtan, 752x480, 20 Hz) and cam0-imu extrinsics are used; with it the
camera model, noise and extrinsics come from a reference-format
params_camera.yaml (`vins_estimator/src/parameters.cpp:52-150`), read by
the port's own YAML reader. The cam0 PNGs are decoded by the port's own
PNG decoder (`utils/png.py`: no PIL). CLAHE (kernels K3, K4) runs where
the configuration sets ``equalize`` (the public default does).

``main(argv)`` runs it in-process and returns the `VioRunner`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
from scipy.spatial.transform import Rotation as Rsc

from ..core.config import CameraIntrinsics, load_yaml
from ..models.vio import estimator as est
from ..models.vio import feature_manager as fm
from ..models.vio import feature_tracker as ft
from ..models.vio.pipeline import VioRunner, VioRunnerConfig
from ..ops import ba
from ..utils.bag import euroc_reader
from ..utils.checkpoint import save_trajectory_tum


def build_config(camera_yaml: str | None) -> VioRunnerConfig:
    """The runner's configuration, field for field as the JAX script builds
    it (`scripts/run_euroc_vio.py:22-76`)."""
    if camera_yaml is None:
        cam = CameraIntrinsics(
            model_type="PINHOLE", image_width=752, image_height=480,
            gamma1=458.654, gamma2=457.296, u0=367.215, v0=248.375,
            k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05,
        )
        # cam0 -> imu (EuRoC sensor.yaml T_BS)
        R_bc = np.array([
            [0.0148655429818, -0.999880929698, 0.00414029679422],
            [0.999557249008, 0.0149672133247, 0.025715529948],
            [-0.0257744366974, 0.00375618835797, 0.999660727178],
        ])
        t_bc = (-0.0216401454975, -0.064676986768, 0.00981073058949)
        tracker = ft.TrackerParams(max_cnt=150, min_dist=30, equalize=True)
        caps = fm.VioCaps(window=10, max_features=256, imu_buf=64, frame_features=150)
        params = est.VioParams(g_norm=9.81)
        bacfg = ba.BAConfig(window=10, max_features=256, iterations=6)
        h, w = 480, 752
        freq = 20.0
    else:
        vin = load_yaml(None, camera_yaml).vins
        cam = vin.camera
        R_bc = np.asarray(vin.extrinsicRotation, np.float64).reshape(3, 3)
        t_bc = tuple(float(x) for x in vin.extrinsicTranslation)
        tracker = ft.TrackerParams(max_cnt=vin.max_cnt, min_dist=vin.min_dist,
                                   equalize=bool(vin.equalize))
        caps = fm.VioCaps(window=vin.WINDOW_SIZE, max_features=max(vin.max_cnt, 128),
                          imu_buf=64, frame_features=vin.max_cnt)
        params = est.VioParams(g_norm=vin.g_norm, acc_n=vin.acc_n, gyr_n=vin.gyr_n,
                               acc_w=vin.acc_w, gyr_w=vin.gyr_w)
        bacfg = ba.BAConfig(window=vin.WINDOW_SIZE, max_features=max(vin.max_cnt, 128),
                            iterations=int(vin.max_num_iterations),
                            estimate_td=bool(vin.estimate_td))
        h, w = cam.image_height, cam.image_width
        freq = float(vin.freq)

    qx = Rsc.from_matrix(R_bc).as_quat()  # xyzw
    qic = (float(qx[3]), float(qx[0]), float(qx[1]), float(qx[2]))
    return VioRunnerConfig(
        camera=cam, tracker=tracker, caps=caps, params=params, ba=bacfg,
        image_height=h, image_width=w, freq=freq, tic=t_bc, qic=qic,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lvislam_tpu_torch.scripts.run_euroc_vio")
    ap.add_argument("root", help="EuRoC mav0 directory")
    ap.add_argument("--max-seconds", type=float, default=30.0)
    ap.add_argument("--camera-yaml", default=None,
                    help="reference-format params_camera.yaml overriding "
                         "the public EuRoC calibration")
    ap.add_argument("--out", default="euroc_vio_trajectory.txt")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu to run on the CPU)")
    # positional max_seconds kept for backward compatibility
    ap.add_argument("legacy_max", nargs="?", type=float, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> VioRunner:
    args = parse_args(argv)
    max_s = args.legacy_max if args.legacy_max is not None else args.max_seconds
    runner = VioRunner(build_config(args.camera_yaml), device=args.device)

    t0 = None
    t = 0.0
    n_img = 0
    wall0 = time.time()
    # EuRoC stamps are ~1.4e9 s absolute; the runner's stamps are float32,
    # so rebase to sequence-relative time in float64 first (as the JAX
    # script does); the TUM export below is in rebased seconds
    for t, topic, kind, msg in euroc_reader(args.root):
        if t0 is None:
            t0 = t
        if t - t0 > max_s:
            break
        if kind == "imu":
            runner.feed_imu(t - t0, msg["gyro"], msg["acc"])
        elif kind == "image":
            out = runner.feed_image(t - t0, msg["image"])
            n_img += 1
            if out is not None and n_img % 50 == 0:
                init = bool(out["initialized"])
                print(f"t={t - t0:7.2f}s imgs={n_img} init={init} "
                      f"pos={np.round(np.asarray(out['pos'].cpu()), 2)}")
    wall = time.time() - wall0
    span = (t - t0) if t0 is not None else 0.0
    print(f"processed {n_img} images in {wall:.1f}s "
          f"({span / max(wall, 1e-9):.2f}x realtime); trajectory points: "
          f"{len(runner.trajectory)}")
    if runner.trajectory:
        save_trajectory_tum(
            args.out,
            [x[0] for x in runner.trajectory],
            [x[1] for x in runner.trajectory],
            [x[2] for x in runner.trajectory],
        )
        print(f"trajectory -> {args.out} (TUM format)")
    return runner


if __name__ == "__main__":
    main()
