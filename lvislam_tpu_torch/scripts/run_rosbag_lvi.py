"""Replay a rosbag2 (sqlite3) recording through the fused LVI system — the
port of ``scripts/run_rosbag_lvi.py``, the equivalent of the reference's
`ros2 launch lvi_sam run.launch` + `ros2 bag play` (SURVEY.md §3 entry point).

Usage:
  python -m lvislam_tpu_torch.scripts.run_rosbag_lvi BAG.db3 \\
      [--lidar-yaml params_lidar.yaml] [--camera-yaml params_camera.yaml] \\
      [--imu-topic /livox/imu] [--lidar-topic /livox/lidar] \\
      [--image-topic /camera/image] [--max-seconds 60] [--save-map DIR] \\
      [--out trajectory.tum] [--device cpu]

The same arguments and steps as the JAX script, plus ``--device``: the card
(``cuda``) unless given, and without one it raises; ``--device cpu`` runs on
the CPU. The YAML files are read by the port's own reader (no PyYAML) and
JPEG frames decoded by its own decoder (no PIL). Topic defaults follow the
reference's handheld Livox MID360 configuration
(`config_pkg/config/params_lidar.yaml`). IMU orientation RPY is derived by
gravity alignment from the accelerometer, as in the JAX script. The LIO
step keeps the default capacities, so the voxel-hash and Gauss-Newton
kernels (K1, K2) stay off, as the JAX script runs them; CLAHE (K3, K4) runs
where the camera YAML sets ``equalize``.

``main(argv)`` runs it in-process and returns the system and the replay's
counts.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation as Rsc

from ..core import lie
from ..core.config import SystemConfig, load_yaml
from ..models.lio import imu_fusion as fus
from ..models.lio.mapping import LioParams
from ..models.lio.pipeline import LioConfig
from ..models.pipeline import LviConfig, LviSystem
from ..models.vio import estimator as vest
from ..models.vio import feature_manager as vfm
from ..models.vio import feature_tracker as vft
from ..ops import ba as vba
from ..utils.bag import Rosbag2Reader, navsat_to_enu, pointcloud2_to_scan
from ..utils.checkpoint import save_map_service, save_trajectory_tum


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lvislam_tpu_torch.scripts.run_rosbag_lvi")
    ap.add_argument("bag")
    ap.add_argument("--lidar-yaml")
    ap.add_argument("--camera-yaml")
    ap.add_argument("--imu-topic", default="/livox/imu")
    ap.add_argument("--lidar-topic", default="/livox/lidar")
    ap.add_argument("--image-topic", default="/camera/image")
    ap.add_argument("--gps-topic", default=None,
                    help="nav_msgs/Odometry in map frame (the reference's "
                         "odometry/gps) or sensor_msgs/NavSatFix (converted "
                         "to ENU around the first fix)")
    ap.add_argument("--gps-elevation", action="store_true",
                    help="trust GPS altitude (useGpsElevation)")
    ap.add_argument("--max-seconds", type=float, default=1e18)
    ap.add_argument("--save-map")
    ap.add_argument("--out", default="lvi_trajectory.tum")
    ap.add_argument("--no-camera", action="store_true",
                    help="LIO-only replay (BASELINE config 3)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu to run on the CPU)")
    return ap.parse_args(argv)


def lvi_config(syscfg: SystemConfig, no_camera: bool = False) -> LviConfig:
    """The fused system's configuration from the YAML tree, field for field
    as the JAX script builds it (`scripts/run_rosbag_lvi.py:48-157`)."""
    lid = syscfg.lidar
    vin = syscfg.vins
    # camera-IMU extrinsic (imu^R_cam row-major, imu^T_cam -> tic/qic wxyz,
    # `parameters.cpp:96-120`)
    Ric = np.asarray(vin.extrinsicRotation, np.float64).reshape(3, 3)
    qx = Rsc.from_matrix(Ric).as_quat()  # xyzw
    qic = (float(qx[3]), float(qx[0]), float(qx[1]), float(qx[2]))
    return LviConfig(
        lio=LioConfig(n_scan=lid.N_SCAN, horizon=lid.Horizon_SCAN,
                      point_capacity=1 << int(np.ceil(np.log2(
                          max(lid.N_SCAN * lid.Horizon_SCAN, 1024)))),
                      # IMU->lidar extrinsic (imuConverter, utility.h:315-349)
                      ext_rot=tuple(lid.extrinsicRot),
                      ext_rpy=tuple(lid.extrinsicRPY),
                      min_range=lid.lidarMinRange,
                      max_range=lid.lidarMaxRange,
                      edge_threshold=lid.edgeThreshold,
                      surf_threshold=lid.surfThreshold,
                      odometry_surf_leaf=lid.odometrySurfLeafSize,
                      loop_closure_enabled=lid.loopClosureEnableFlag,
                      params=LioParams(
                          mappingCornerLeafSize=lid.mappingCornerLeafSize,
                          mappingSurfLeafSize=lid.mappingSurfLeafSize,
                          surroundingKeyframeSearchRadius=(
                              lid.surroundingKeyframeSearchRadius),
                          keyframeAddingDistThreshold=(
                              lid.surroundingkeyframeAddingDistThreshold),
                          keyframeAddingAngleThreshold=(
                              lid.surroundingkeyframeAddingAngleThreshold),
                          imuRPYWeight=lid.imuRPYWeight,
                          z_tollerance=lid.z_tollerance,
                          rotation_tollerance=lid.rotation_tollerance,
                          useImuHeadingInitialization=(
                              lid.useImuHeadingInitialization),
                          historyKeyframeSearchRadius=(
                              lid.historyKeyframeSearchRadius),
                          historyKeyframeSearchTimeDiff=(
                              lid.historyKeyframeSearchTimeDiff),
                          historyKeyframeSearchNum=lid.historyKeyframeSearchNum,
                          historyKeyframeFitnessScore=(
                              lid.historyKeyframeFitnessScore),
                          edgeFeatureMinValidNum=lid.edgeFeatureMinValidNum,
                          surfFeatureMinValidNum=lid.surfFeatureMinValidNum,
                          gpsCovThreshold=lid.gpsCovThreshold,
                          poseCovThreshold=lid.poseCovThreshold,
                      )),
        fusion=fus.FusionParams(imuAccNoise=lid.imuAccNoise,
                                imuGyrNoise=lid.imuGyrNoise,
                                imuAccBiasN=lid.imuAccBiasN,
                                imuGyrBiasN=lid.imuGyrBiasN,
                                imuGravity=lid.imuGravity,
                                extTrans=tuple(lid.extrinsicTrans)),
        # VIS parameters (`parameters.cpp:52-150`)
        vio_caps=vfm.VioCaps(window=vin.WINDOW_SIZE,
                             max_features=max(vin.max_cnt, 128),
                             imu_buf=64, frame_features=vin.max_cnt),
        vio_params=vest.VioParams(
            acc_n=vin.acc_n, gyr_n=vin.gyr_n, acc_w=vin.acc_w,
            gyr_w=vin.gyr_w, g_norm=vin.g_norm,
            min_parallax=vin.keyframe_parallax / vin.FOCAL_LENGTH,
            init_depth=vin.INIT_DEPTH,
            estimate_extrinsic_rotation=vin.estimate_extrinsic == 2),
        ba=vba.BAConfig(window=vin.WINDOW_SIZE,
                        max_features=max(vin.max_cnt, 128),
                        focal=vin.FOCAL_LENGTH,
                        iterations=vin.max_num_iterations,
                        estimate_td=vin.estimate_td,
                        estimate_extrinsic=vin.estimate_extrinsic == 1,
                        solver="schur"),
        tracker=vft.TrackerParams(max_cnt=vin.max_cnt, min_dist=vin.min_dist,
                                  F_threshold=vin.F_threshold,
                                  equalize=vin.equalize,
                                  focal_virtual=vin.FOCAL_LENGTH),
        tic=tuple(float(v) for v in vin.extrinsicTranslation),
        qic=qic,
        camera=vin.camera,
        image_height=vin.camera.image_height,
        image_width=vin.camera.image_width,
        use_lidar_depth=vin.use_lidar,
        lidar_skip=vin.lidar_skip,
        rolling_shutter_tr=(vin.rolling_shutter_tr
                            if vin.rolling_shutter else 0.0),
        use_loop_detector=not no_camera and vin.loop_closure,
        mapping_process_interval=lid.mappingProcessInterval,
        # vocab_path defaults to "auto": the committed trained vocabulary
        # (configs/brief_vocab.npz) (pose_graph_node.cpp:297-314)
    )


def _accel_rpy(acc) -> np.ndarray:
    """Gravity-aligned roll / pitch (yaw 0) from one accelerometer sample:
    the orientation the reference requires and MID360 bags lack."""
    a = np.asarray(acc)
    g = a / max(np.linalg.norm(a), 1e-6)
    return np.array([np.arctan2(g[1], g[2]), -np.arcsin(np.clip(g[0], -1, 1)), 0.0],
                    np.float32)


def save_trajectory(path: str, trajectory) -> None:
    """The system's (stamp, x6) poses as a TUM file."""
    ts, ps, qs = [], [], []
    for t, x6 in trajectory:
        x6 = np.asarray(x6)
        ts.append(t)
        ps.append(x6[3:6])
        T = lie.pose6_to_matrix(torch.as_tensor(x6)).numpy()
        qs.append(np.roll(Rsc.from_matrix(T[:3, :3]).as_quat(), 1))
    save_trajectory_tum(path, ts, ps, qs)


def main(argv=None) -> dict:
    """Run the replay; returns {"system", "t0" (the first message's stamp,
    s: every feed is at t - t0), "span_s" (the last fed message's t - t0),
    "messages" (fed, by kind), "skipped" (the reader's count), "wall_s" (of
    `run`), "map" (`save_map_service`'s summary, or None)}."""
    args = parse_args(argv)
    cfg = lvi_config(load_yaml(args.lidar_yaml, args.camera_yaml), args.no_camera)
    sys_ = LviSystem(cfg, device=args.device)

    topics = {args.imu_topic, args.lidar_topic}
    if not args.no_camera:
        topics.add(args.image_topic)
    if args.gps_topic:
        topics.add(args.gps_topic)
    ref_fix = None  # first NavSatFix, ENU origin
    t0 = t_last = None
    counts: dict[str, int] = {}
    reader = Rosbag2Reader(args.bag, topics=list(topics))
    for t, topic, kind, msg in reader:
        if t0 is None:
            t0 = t
        if t - t0 > args.max_seconds:
            break
        counts[kind] = counts.get(kind, 0) + 1
        t_last = t
        if kind == "imu":
            rpy = msg.get("rpy")
            if rpy is None:
                rpy = _accel_rpy(msg["acc"])
            sys_.feed_imu(t - t0, msg["gyro"], msg["acc"], rpy=rpy)
        elif kind == "livox":
            sys_.feed_lidar(t - t0, msg)
        elif kind == "pointcloud":
            sys_.feed_lidar(t - t0, pointcloud2_to_scan(msg))
        elif kind == "image":
            sys_.feed_image(t - t0, msg["image"])
        elif kind == "odometry" and topic == args.gps_topic:
            sys_.feed_gps(t - t0, msg["pos"], msg["pos_cov"],
                          use_elevation=args.gps_elevation)
        elif kind == "navsatfix":
            if msg["status"] < 0:  # STATUS_NO_FIX
                continue
            if ref_fix is None:
                ref_fix = (msg["lat"], msg["lon"], msg["alt"])
            enu = navsat_to_enu(msg["lat"], msg["lon"], msg["alt"], *ref_fix)
            sys_.feed_gps(t - t0, enu, msg["pos_cov"],
                          use_elevation=args.gps_elevation)

    print(f"replaying {sum(counts.values())} messages on {sys_.device} ...")
    w0 = time.time()
    sys_.run()
    wall = time.time() - w0
    dur = (sys_.trajectory[-1][0] - sys_.trajectory[0][0]) if sys_.trajectory else 0
    print(f"bag span {dur:.1f}s processed in {wall:.1f}s "
          f"({dur / max(wall, 1e-9):.2f}x realtime), "
          f"{len(sys_.trajectory)} poses")
    if args.gps_topic:
        print(f"gps factors applied: {int(sys_.lio.state.n_gps)}")
    if reader.skipped:
        print(f"skipped {reader.skipped} undecodable messages")

    if sys_.trajectory:
        save_trajectory(args.out, sys_.trajectory)
        print(f"trajectory -> {args.out} (TUM format)")
    saved = None
    if args.save_map:
        saved = save_map_service(sys_.lio.state, args.save_map)
        print(saved)
    return dict(system=sys_, t0=t0, span_s=(t_last - t0) if counts else 0.0, messages=counts,
                skipped=reader.skipped, wall_s=wall, map=saved)


if __name__ == "__main__":
    main()
