"""Typed configuration tree — port of ``lvislam_tpu.core.config``, field
for field and default for default.

Mirrors the reference's dual config system with the parameter names preserved
for comparability:
- `config_pkg/config/params_lidar.yaml` read by `ParamServer`
  (`lidar_odometry/src/utility.h:68-313`);
- `config_pkg/config/params_camera.yaml` read by `readParameters`
  (`vins_estimator/src/parameters.cpp:52-150`,
  `feature_tracker/src/parameters.cpp:55-113`,
  `pose_graph/src/pose_graph_node.cpp:276-316`).

One frozen, hashable dataclass tree, loadable from the reference-format YAML
files by ``load_yaml``, which reads them with ``core/yamlite.py`` (the card's
machine has no PyYAML). ``Capacities`` are the JAX package's fixed padding
sizes, kept so a configuration carries over whole. The tracker's own
``TrackerParams`` lives with the tracker, as in JAX.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

from . import yamlite


@dataclass(frozen=True)
class LidarConfig:
    """LIS parameters (`params_lidar.yaml`, `utility.h:156-313`)."""

    sensor: str = "livox"
    N_SCAN: int = 4
    Horizon_SCAN: int = 6000
    downsampleRate: int = 1
    lidarMinRange: float = 1.0
    lidarMaxRange: float = 100.0

    # IMU
    imuAccNoise: float = 3.9939570888238808e-03
    imuGyrNoise: float = 1.5636343949698187e-03
    imuAccBiasN: float = 6.4356659353532566e-05
    imuGyrBiasN: float = 3.5640318696367613e-05
    imuGravity: float = 9.80511
    imuRPYWeight: float = 0.01
    useImuHeadingInitialization: bool = False
    extrinsicTrans: Tuple[float, ...] = (0.0, 0.0, 0.0)
    extrinsicRot: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    extrinsicRPY: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)

    # LOAM feature thresholds (`featureExtraction.cpp`)
    edgeThreshold: float = 1.0
    surfThreshold: float = 0.1
    edgeFeatureMinValidNum: int = 10
    surfFeatureMinValidNum: int = 100

    # voxel filter leaf sizes
    odometrySurfLeafSize: float = 0.4
    mappingCornerLeafSize: float = 0.2
    mappingSurfLeafSize: float = 0.4

    z_tollerance: float = 1000.0
    rotation_tollerance: float = 1000.0

    numberOfCores: int = 8
    mappingProcessInterval: float = 0.15

    # surrounding map
    surroundingkeyframeAddingDistThreshold: float = 1.0
    surroundingkeyframeAddingAngleThreshold: float = 0.2
    surroundingKeyframeDensity: float = 2.0
    surroundingKeyframeSearchRadius: float = 50.0

    # loop closure
    loopClosureEnableFlag: bool = True
    loopClosureFrequency: float = 1.0
    surroundingKeyframeSize: int = 50
    historyKeyframeSearchRadius: float = 15.0
    historyKeyframeSearchTimeDiff: float = 30.0
    historyKeyframeSearchNum: int = 25
    historyKeyframeFitnessScore: float = 0.3

    # GPS
    useGpsElevation: bool = False
    gpsCovThreshold: float = 2.0
    poseCovThreshold: float = 25.0

    # visualization (kept for parity of the save/visualize services)
    globalMapVisualizationSearchRadius: float = 1000.0
    globalMapVisualizationPoseDensity: float = 1.0
    globalMapVisualizationLeafSize: float = 0.05

    savePCD: bool = False
    savePCDDirectory: str = "/tmp/lvislam_maps/"


@dataclass(frozen=True)
class CameraIntrinsics:
    """Camodocal camera model parameters (`params_camera.yaml` camera block)."""

    model_type: str = "MEI"  # PINHOLE | MEI | KANNALA_BRANDT | SCARAMUZZA
    image_width: int = 1024
    image_height: int = 576
    # MEI
    xi: float = 1.40630886
    # distortion (radtan, shared by pinhole/MEI)
    k1: float = -0.03678799
    k2: float = 0.2610374
    p1: float = 0.00144626
    p2: float = 0.00035872
    # projection: gamma for MEI, f for pinhole/equidistant
    gamma1: float = 1454.59041
    gamma2: float = 1451.94369
    u0: float = 468.13404
    v0: float = 318.32657
    # equidistant (Kannala-Brandt) coefficients
    kb_k2: float = 0.0
    kb_k3: float = 0.0
    kb_k4: float = 0.0
    kb_k5: float = 0.0
    # scaramuzza polynomials
    scara_poly: Tuple[float, ...] = (0.0,) * 5
    scara_inv_poly: Tuple[float, ...] = (0.0,) * 20
    scara_C: float = 1.0
    scara_D: float = 0.0
    scara_E: float = 0.0


@dataclass(frozen=True)
class VinsConfig:
    """VIS parameters (`params_camera.yaml`, `parameters.cpp:52-150`)."""

    imu_gravity: float = 9.806
    use_lidar: bool = True
    lidar_skip: int = 3
    align_camera_lidar_estimation: bool = False

    camera: CameraIntrinsics = field(default_factory=CameraIntrinsics)

    # IMU noise
    acc_n: float = 3.9939570888238808e-01
    gyr_n: float = 1.5636343949698187e-01
    acc_w: float = 6.4356659353532566e-03
    gyr_w: float = 3.5640318696367613e-03
    g_norm: float = 9.806

    # camera-IMU extrinsic (imu^R_cam row-major, imu^T_cam)
    estimate_extrinsic: int = 0
    extrinsicRotation: Tuple[float, ...] = (
        -0.06402407, -0.09752301, 0.99317178,
        -0.99752562, 0.03521845, -0.06084651,
        -0.02904404, -0.99460994, -0.09953653,
    )
    extrinsicTranslation: Tuple[float, ...] = (0.1278, -0.0248, -0.0258)

    # feature tracker (`feature_tracker/src/parameters.cpp`)
    max_cnt: int = 150
    min_dist: int = 20
    freq: int = 20
    F_threshold: float = 1.0
    equalize: bool = True
    fisheye: bool = False

    # optimization
    max_solver_time: float = 0.035
    max_num_iterations: int = 10
    keyframe_parallax: float = 10.0  # pixels; MIN_PARALLAX = this / FOCAL_LENGTH

    # td / rolling shutter
    estimate_td: bool = True
    td: float = 0.0
    rolling_shutter: bool = False
    rolling_shutter_tr: float = 0.0

    # loop closure (`pose_graph`)
    loop_closure: bool = True
    skip_time: float = 0.0
    skip_dist: float = 0.0
    match_image_scale: float = 0.5

    # constants mirroring `vins_estimator/src/parameters.h`
    WINDOW_SIZE: int = 10  # parameters.h:14
    FOCAL_LENGTH: float = 460.0  # parameters.h:13 (virtual focal for thresholds)
    INIT_DEPTH: float = 5.0
    MIN_PARALLAX_PIXELS: float = 10.0
    BIAS_ACC_THRESHOLD: float = 2.5
    BIAS_GYR_THRESHOLD: float = 1.0


@dataclass(frozen=True)
class Capacities:
    """The JAX package's fixed-shape padding capacities (every variable-size
    object of the reference gets a capacity and a validity mask there),
    kept field for field so a configuration carries over whole."""

    max_points: int = 24576  # raw deskewed cloud points per scan (N_SCAN*Horizon_SCAN)
    max_edge_features: int = 1024  # per-scan LOAM edge features (cap 40×6 sectors×N_SCAN)
    max_surf_features: int = 8192  # per-scan LOAM planar features after downsample
    max_map_corner: int = 65536  # assembled local map corner points
    max_map_surf: int = 131072  # assembled local map surface points
    max_keyframes: int = 2048  # keyframe ring buffer
    max_imu_per_scan: int = 256  # IMU samples buffered per lidar scan interval
    max_imu_per_frame: int = 64  # IMU samples between camera frames
    max_features: int = 150  # tracked visual features (== max_cnt)
    max_depth_cloud: int = 65536  # accumulated depth-registration cloud
    voxel_table_size: int = 1 << 19  # voxel hash table slots
    voxel_capacity: int = 8  # points stored per voxel slot
    max_loop_candidates: int = 8
    max_icp_points: int = 8192
    sfm_frames: int = 11  # WINDOW_SIZE + 1
    max_sfm_features: int = 512
    max_brief_keypoints: int = 512
    vocab_size: int = 1024  # BoW vocabulary leaves (binary descriptor k-means)


@dataclass(frozen=True)
class SystemConfig:
    lidar: LidarConfig = field(default_factory=LidarConfig)
    vins: VinsConfig = field(default_factory=VinsConfig)
    caps: Capacities = field(default_factory=Capacities)
    dtype: str = "float32"

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def _filter_fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items() if k in names}


def load_yaml(lidar_yaml: str | None = None, camera_yaml: str | None = None) -> SystemConfig:
    """Build a SystemConfig from reference-format YAML files, read by the
    port's own YAML-subset reader (``core/yamlite.py``: no PyYAML)."""
    lidar = LidarConfig()
    vins = VinsConfig()
    if lidar_yaml is not None:
        raw = yamlite.load(lidar_yaml)
        if "/**" in raw:  # ROS2 param file layout
            raw = raw["/**"]["ros__parameters"]
        lidar = LidarConfig(**_filter_fields(LidarConfig, raw))
    if camera_yaml is not None:
        raw = yamlite.load(camera_yaml)  # takes the OpenCV header and matrix tags
        cam_kw = _filter_fields(CameraIntrinsics, raw)
        for blk in ("mirror_parameters", "distortion_parameters", "projection_parameters"):
            if isinstance(raw.get(blk), dict):
                cam_kw.update(_filter_fields(CameraIntrinsics, raw[blk]))
        # PINHOLE configs name the projection fx/fy/cx/cy
        # (camodocal PinholeCamera::Parameters::readFromYamlFile)
        proj = raw.get("projection_parameters")
        if isinstance(proj, dict):
            for src, dst in (("fx", "gamma1"), ("fy", "gamma2"),
                             ("cx", "u0"), ("cy", "v0")):
                if src in proj:
                    cam_kw[dst] = proj[src]
        vins_kw = _filter_fields(VinsConfig, raw)
        for key in ("extrinsicRotation", "extrinsicTranslation"):
            if isinstance(raw.get(key), dict):
                vins_kw[key] = tuple(raw[key]["data"])
        for bkey in ("use_lidar", "equalize", "fisheye", "estimate_td",
                     "rolling_shutter", "loop_closure", "align_camera_lidar_estimation"):
            if bkey in raw:
                vins_kw[bkey] = bool(raw[bkey])
        vins_kw["camera"] = CameraIntrinsics(**cam_kw)
        vins = VinsConfig(**vins_kw)
    return SystemConfig(lidar=lidar, vins=vins)


def default_config() -> SystemConfig:
    return SystemConfig()


def min_parallax(cfg: VinsConfig) -> float:
    """Keyframe parallax threshold in normalized units
    (`parameters.cpp`: MIN_PARALLAX = keyframe_parallax / FOCAL_LENGTH)."""
    return cfg.keyframe_parallax / cfg.FOCAL_LENGTH
