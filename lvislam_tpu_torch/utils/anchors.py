"""Reference values of the JAX package for ``chip_smoke.py``.

The machine with the card has no JAX, so the JAX runs' numbers are made on
the CPU and stored here, each with the slow test that recomputes it and
asserts that it equals the stored value (``-s`` prints them):

- ``TRACKER_SEQUENCE`` (phases 6, 7): the JAX tracker
  (``lvislam_tpu.models.vio.feature_tracker``, ``TrackerParams()``, the
  shipped MEI 1024x576 camera) on ``chip_smoke.tracker_frames()``, and JAX
  ``register_depth`` of its last 5 frames against ``chip_smoke.depth_cloud``
  of the LIO replay's scans 8..19; ``tests/test_torch_tracker.py -m slow -k
  anchors -s``;
- ``VIO_FIXTURE``, ``VIO_FULL_WIDTH`` (phases 10, 11):
  ``tests/test_torch_vio_estimator.py -m slow -k anchors -s``;
- ``FUSION_REPLAY`` (phase 9b): ``tests/test_torch_imu_fusion.py -m slow -k
  anchor -s``;
- ``LOOP_SCENE`` (phase 13): ``tests/test_torch_loop_detector.py`` (not
  slow: it runs the JAX scene anyway);
- ``LVI_PARITY`` (phase 14): ``tests/test_torch_lvi_system.py -m slow -k
  anchor -s``;
- ``ROSBAG_FIXTURE`` (phase 16): ``tests/test_torch_rosbag_entry.py -m slow
  -k anchor -s``;
- ``EUROC_VIO`` (phase 20): ``tests/test_torch_euroc_entry.py -m slow -k
  anchor -s``;
- ``SYNTHETIC_LVI`` (phase 21): ``tests/test_torch_synthetic_entry.py -m
  slow -k anchor -s``;
- ``LVI_REPLAY`` (phase 24): ``tests/test_torch_replay.py -m slow -k anchor
  -s``.

``config_sha256`` hashes a configuration so a stored value names the
configuration that made it.
"""

TRACKER_SEQUENCE = {
    # tracked features per frame (frame 0 has nothing to track)
    "n_tracked": [0, 68, 79, 88, 94, 96, 102, 112, 119, 124, 128, 138, 146, 147,
                  149, 149, 150, 150, 150, 149],
    # median epipolar residual of consecutive-frame tracks under the
    # ground-truth relative pose, virtual-focal pixels (x460)
    "epipolar_median_px": 0.0767947461218069,
    # share of the last 5 frames' valid features given a depth, and the
    # median |depth - raycast depth| (m) of those
    "depth_share": 0.6684491978609626,
    "depth_median_err_m": 0.5424823587529968,
}

# The JAX `VioRunner` on the CPU over `chip_smoke.vio_inputs(full)` with
# `chip_smoke.vio_config(full)`, once for each seed 0-7. Seed 0 is the JAX
# package as it stands; seed s > 0 folds s into the key of every RANSAC draw
# (the tracker's and the initializer's). A run's entry: its
# `chip_smoke.vio_status`, the frame whose output is the first initialized
# one, the trajectory points logged, the failures counted, and the ATE (m)
# against the ground truth after rigid alignment where the run ended
# initialized. On this 5 s stream the visual bootstrap is a matter of the
# draws: 2 of the 8 fixture-size runs and 4 of the 8 full-width ones meet the
# gates; 3 fixture-size runs initialize at frame 22 on a wrong scale that no
# failure check catches. The slow test
# ``tests/test_torch_vio_estimator.py::test_jax_vio_runner_anchors``
# recomputes each entry (``-m slow -k anchors -s`` prints them).
VIO_FIXTURE = {
    0: {"status": "ok", "initialized_at_frame": 39, "trajectory_points": 10,
        "failure_count": 0, "ate_m": 0.1781912865174702},
    1: {"status": "misinitialized", "initialized_at_frame": 22, "trajectory_points": 27,
        "failure_count": 0, "ate_m": 1.9888366676038924},
    2: {"status": "rebooted", "initialized_at_frame": 46, "trajectory_points": 3,
        "failure_count": 1, "ate_m": 0.049057435173914664},
    3: {"status": "misinitialized", "initialized_at_frame": 22, "trajectory_points": 27,
        "failure_count": 0, "ate_m": 1.7196585533377673},
    4: {"status": "ok", "initialized_at_frame": 43, "trajectory_points": 6,
        "failure_count": 0, "ate_m": 0.10100967398884676},
    5: {"status": "rebooted", "initialized_at_frame": None, "trajectory_points": 0,
        "failure_count": 1, "ate_m": None},
    6: {"status": "rebooted", "initialized_at_frame": None, "trajectory_points": 0,
        "failure_count": 1, "ate_m": None},
    7: {"status": "misinitialized", "initialized_at_frame": 22, "trajectory_points": 27,
        "failure_count": 0, "ate_m": 1.6643183969868494},
}
VIO_FULL_WIDTH = {
    0: {"status": "ok", "initialized_at_frame": 44, "trajectory_points": 5,
        "failure_count": 0, "ate_m": 0.09712130386353476},
    1: {"status": "never_initialized", "initialized_at_frame": None, "trajectory_points": 0,
        "failure_count": 0, "ate_m": None},
    2: {"status": "ok", "initialized_at_frame": 44, "trajectory_points": 5,
        "failure_count": 0, "ate_m": 0.06014250277551185},
    3: {"status": "ok", "initialized_at_frame": 39, "trajectory_points": 10,
        "failure_count": 0, "ate_m": 0.2625512626235111},
    4: {"status": "never_initialized", "initialized_at_frame": None, "trajectory_points": 0,
        "failure_count": 0, "ate_m": None},
    5: {"status": "rebooted", "initialized_at_frame": None, "trajectory_points": 0,
        "failure_count": 1, "ate_m": None},
    6: {"status": "ok", "initialized_at_frame": 44, "trajectory_points": 5,
        "failure_count": 0, "ate_m": 0.04807906365203245},
    7: {"status": "rebooted", "initialized_at_frame": None, "trajectory_points": 0,
        "failure_count": 1, "ate_m": None},
}


# The JAX `LviSystem`'s interactive path (replay_batch=1) on the CPU over the
# 12 s parity sequence (`synthetic.lvi_sequence()`, the bench's
# `_lvi_seq_data`): `tests/test_lvi_system.py:make_system` with
# `bench.py:apply_perf_knobs` (pallas=False: throttle 0.15 s, "schur",
# nnRefreshEvery=2, mapRebuildEvery=1, K2 off), fed 2 s then 10 s. The
# aligned ATE of `trajectory` (m), the processed frame on which the VIO came
# out initialized and by which path, the trajectory's length, the frames,
# failures and keyframes at the end, and sha256 of the configuration
# (`config_sha256`) and of the stream (`synthetic.lvi_sequence_sha256`).
# The batched replay's clean-CPU reading of the same sequence is
# `bench_anchors.json:lvi_ate_cpu_ref_m` (0.0961 m). Recomputed by
# ``tests/test_torch_lvi_system.py::test_jax_interactive_anchor`` (slow, ~3 min).
LVI_PARITY = {
    "ate_m": 0.09199827015103579, "init_frame": 11, "init_path": "lidar_seed",
    "trajectory_points": 60, "vio_frames": 119, "failure_count": 0, "keyframes": 39,
    "config_sha256": "26927613758b82b6", "stream_sha256": "f8387e973b708dc3",
}


# The JAX `LviSystem` with the bench's batched fused replay
# (`replay_batch = 16`, `bench.py:539`) and phase 14's JAX configuration on
# the CPU over the 12 s parity sequence, 2 s then 10 s (the replay takes over
# once the VIO has initialized); `ate_one_ulp_m`: the same run with one input
# a float32 step off (`tests/test_torch_synthetic_entry.ONE_ULP`), the JAX
# run's own spread. `config_sha256` hashes the configuration with its
# `replay_batch`.
LVI_REPLAY = {'ate_m': 0.09139479536837432,
              'ate_one_ulp_m': {'gyro_up': 0.090751473630107,
                                'acc_up': 0.09092723261539186,
                                'xyz_up': 0.092440758548076,
                                'xyz_down': 0.09174556161519232},
              'init_frame': 11,
              'init_path': 'lidar_seed',
              'trajectory_points': 60,
              'vio_frames': 119,
              'failure_count': 0,
              'keyframes': 39,
              'config_sha256': '85300ff60825bab7',
              'stream_sha256': 'f8387e973b708dc3'}

# The JAX loop detector on the CPU over the revisit scene of
# `tests/test_loop_detector.py` (`synthetic.loop_scene`: world seed 3,
# figure-8 period 8 s, 21 frames 0.4 s apart at 320x240; its capacities:
# 64 keyframes, 48 window + 128 extra points, recent_exclude 3,
# min_loop_matches 15; the seeded random vocabulary), JAX's own PnP draws.
# `pairs`: the accepted (frame, old slot); `verified`: every verified
# candidate as (frame, old slot, PnP inliers). Frame 19's 15 inliers sit on
# the gate (> 15 accepts). `tests/test_torch_loop_detector.py` holds the
# JAX run to these pairs.
LOOP_SCENE = {
    "pairs": [[20, 0]],
    "verified": [[5, 0, 3], [6, 0, 3], [7, 0, 1], [8, 1, 2], [9, 1, 2], [10, 0, 3],
                 [11, 1, 2], [12, 2, 1], [13, 0, 3], [14, 3, 1], [15, 3, 1], [16, 2, 7],
                 [17, 1, 3], [18, 0, 5], [19, 0, 15], [20, 0, 42]],
    "caps": {"max_keyframes": 64, "window_points": 48, "extra_points": 128,
             "recent_exclude": 3, "min_loop_matches": 15},
}


# The JAX package's two-state smoother on the CPU over `chip_smoke.py` phase
# 9b's 90 corrections (`chip_smoke.fusion_inputs`): the card's LIO replay
# poses (phase 3's trajectory, whose sha256 is `poses_sha256`; stored as
# `tests/data/lio_replay_trajectory.npy`), the injected biases (gyro 0.02,
# -0.01, 0.015; accelerometer 0.05, 0.08, -0.06) and noise (seed 0). The end
# state's |bias error| / |true bias| for each bias and the fused position's
# distance to the last correction (m): JAX does not recover the
# accelerometer bias in these 9 s either. Recomputed by
# ``tests/test_torch_imu_fusion.py::test_jax_fusion_over_replay_anchor`` (slow).
FUSION_REPLAY = {
    "poses_sha256": "12114c5d46c4c33b", "corrections": 90, "failed": False,
    "bg_err_over_true": 0.2637812804486366, "ba_err_over_true": 1.507295281695232,
    "pos_err_m": 0.062216166078266695,
    "ba_est": [0.13647888600826263, 0.22216938436031342, -0.08661779016256332],
    "bg_est": [0.016371576115489006, -0.015394704416394234, 0.017859652638435364],
}


# The JAX package's `scripts/run_rosbag_lvi.py` on the CPU over the committed
# fixture bag (`tests/data/fixture_mid360.db3`, with
# `tests/data/fixture_{lidar,camera}.yaml`): the messages its reader yields
# by kind and skips, the first message's stamp (s), sha256 of the 59 frames
# as PIL decodes them (float32 / 255, in bag order), the `LviConfig` the
# script builds (`config_fields`, and its `config_sha256`), and of the whole
# replay the aligned ATE (m) of the TUM trajectory against the fixture's
# ground truth (world seed 0, figure-8 3 m / 30 s at t + t0), the same with
# one input a float32 step off (`ate_one_ulp_m`: the IMU's gyro or
# accelerometer up, every scan point up or down; the JAX run's own spread,
# which phase 16's gate spans as phase 14's spans two readings), the poses, the
# keyframes, the frames, whether the VIO ended initialized and its failures;
# `prefix`: the [t, x6] poses of its run over the first `prefix_seconds`
# (`--max-seconds 1`). Recomputed by
# ``tests/test_torch_rosbag_entry.py::test_jax_script_fixture_anchor`` (slow).
ROSBAG_FIXTURE = {'messages': {'imu': 1200, 'livox': 59, 'image': 59},
                  'skipped': 0,
                  't0': 0.005,
                  'frames_sha256': '9c1aa686bb9569b9',
                  'config_sha256': '16e74e0383e26603',
                  'config': {'lio': {'n_scan': 4,
                                     'horizon': 900,
                                     'point_capacity': 4096,
                                     'imu_capacity': 64,
                                     'ext_rot': ['1.0', '0.0', '0.0', '0.0', '1.0', '0.0', '0.0', '0.0', '1.0'],
                                     'ext_rpy': ['1.0', '0.0', '0.0', '0.0', '1.0', '0.0', '0.0', '0.0', '1.0'],
                                     'caps': {'max_keyframes': 512,
                                              'kf_corner': 512,
                                              'kf_surf': 2048,
                                              'sel_keyframes': 48,
                                              'map_corner': 16384,
                                              'map_surf': 65536,
                                              'scan_corner': 1024,
                                              'scan_surf': 4096,
                                              'max_loops': 32,
                                              'max_gps': 64,
                                              'loop_submap': 16384,
                                              'icp_iters': 25,
                                              'corner_hash_size': 16384,
                                              'surf_hash_size': 65536,
                                              'hash_bucket': 32,
                                              'surf_hash_bucket': 16,
                                              'pallas_knn': False,
                                              'pallas_gn': False,
                                              'corner_leaf_table': 32768,
                                              'surf_leaf_table': 131072},
                                     'params': {'mappingCornerLeafSize': '0.2',
                                                'mappingSurfLeafSize': '0.4',
                                                'surroundingKeyframeSearchRadius': '50.0',
                                                'keyframeAddingDistThreshold': '0.3',
                                                'keyframeAddingAngleThreshold': '0.1',
                                                'imuRPYWeight': '0.01',
                                                'z_tollerance': '1000.0',
                                                'rotation_tollerance': '1000.0',
                                                'useImuHeadingInitialization': False,
                                                'livox_keyframe_interval': '1.0',
                                                'historyKeyframeSearchRadius': '15.0',
                                                'historyKeyframeSearchTimeDiff': '30.0',
                                                'historyKeyframeSearchNum': 25,
                                                'historyKeyframeFitnessScore': '0.3',
                                                'edgeFeatureMinValidNum': 10,
                                                'surfFeatureMinValidNum': 100,
                                                'gpsCovThreshold': '2.0',
                                                'poseCovThreshold': '25.0',
                                                'degeneracyEigenThreshold': '100.0',
                                                'nnRefreshEvery': 1,
                                                'gatherOncePerScan': False,
                                                'mapRebuildEvery': 1,
                                                'constantVelocityGuess': True,
                                                'vinsGuessMaxDeltaJump': '0.5',
                                                'vinsGuessMaxRotRate': '3.0'},
                                     'min_range': '1.0',
                                     'max_range': '100.0',
                                     'edge_threshold': '1.0',
                                     'surf_threshold': '0.1',
                                     'odometry_surf_leaf': '0.4',
                                     'loop_closure_enabled': True,
                                     'loop_every_n_scans': 10,
                                     'exact_loam_selection': False,
                                     'upload_batch': 1,
                                     'pipelined_uploads': True,
                                     'async_dispatch': True},
                             'fusion': {'imuAccNoise': '0.003993957088823881',
                                        'imuGyrNoise': '0.0015636343949698187',
                                        'imuAccBiasN': '6.435665935353257e-05',
                                        'imuGyrBiasN': '3.564031869636761e-05',
                                        'imuGravity': '9.81',
                                        'priorPoseSigma': '0.01',
                                        'priorVelSigma': '10000.0',
                                        'priorBiasSigma': '0.001',
                                        'corrRotSigma': '0.05',
                                        'corrTransSigma': '0.1',
                                        'corrDegenerateSigma': '1.0',
                                        'maxVelocity': '30.0',
                                        'maxBias': '1.0',
                                        'extTrans': ['0.0', '0.0', '0.0']},
                             'vio_caps': {'window': 10,
                                          'max_features': 128,
                                          'imu_buf': 64,
                                          'frame_features': 64,
                                          'ex_pairs': 24},
                             'vio_params': {'acc_n': '0.39939570888238807',
                                            'gyr_n': '0.15636343949698187',
                                            'acc_w': '0.006435665935353257',
                                            'gyr_w': '0.003564031869636761',
                                            'g_norm': '9.81',
                                            'min_parallax': '0.021739130434782608',
                                            'init_depth': '5.0',
                                            'ba_threshold': '2.5',
                                            'bg_threshold': '1.0',
                                            'max_v_norm': '30.0',
                                            'jump_t': '5.0',
                                            'jump_z': '1.0',
                                            'use_visual_init': True,
                                            'estimate_extrinsic_rotation': False,
                                            'ex_min_pairs': 10},
                             'ba': {'window': 10,
                                    'max_features': 128,
                                    'focal': '460.0',
                                    'iterations': 4,
                                    'damping': '1e-05',
                                    'estimate_td': False,
                                    'estimate_extrinsic': False,
                                    'cauchy_c': '1.0',
                                    'solver': 'schur',
                                    'ftol': '1e-06'},
                             'tracker': {'max_cnt': 64,
                                         'min_dist': 16,
                                         'F_threshold': '1.0',
                                         'equalize': False,
                                         'focal_virtual': '460.0',
                                         'border': 10,
                                         'klt_levels': 3,
                                         'klt_half': 10,
                                         'klt_iters': 30,
                                         'klt_patch': 32,
                                         'min_track_for_F': 8},
                             'camera': {'model_type': 'PINHOLE',
                                        'image_width': 320,
                                        'image_height': 240,
                                        'xi': '1.40630886',
                                        'k1': '0.0',
                                        'k2': '0.0',
                                        'p1': '0.0',
                                        'p2': '0.0',
                                        'gamma1': '200.0',
                                        'gamma2': '200.0',
                                        'u0': '160.0',
                                        'v0': '120.0',
                                        'kb_k2': '0.0',
                                        'kb_k3': '0.0',
                                        'kb_k4': '0.0',
                                        'kb_k5': '0.0',
                                        'scara_poly': ['0.0', '0.0', '0.0', '0.0', '0.0'],
                                        'scara_inv_poly': ['0.0', '0.0', '0.0', '0.0', '0.0', '0.0', '0.0',
                                                           '0.0', '0.0', '0.0', '0.0', '0.0', '0.0', '0.0',
                                                           '0.0', '0.0', '0.0', '0.0', '0.0', '0.0'],
                                        'scara_C': '1.0',
                                        'scara_D': '0.0',
                                        'scara_E': '0.0'},
                             'loop_caps': {'max_keyframes': 1024,
                                           'window_points': 150,
                                           'extra_points': 256,
                                           'vocab_words': 1024,
                                           'recent_exclude': 200,
                                           'min_loop_matches': 25},
                             'image_height': 240,
                             'image_width': 320,
                             'use_lidar_depth': True,
                             'lidar_skip': 1,
                             'depth_cloud_slots': 12,
                             'depth_cloud_points': 4096,
                             'use_loop_detector': True,
                             'vocab_path': 'auto',
                             'mapping_process_interval': '0.15',
                             'tic': ['0.0', '0.0', '0.0'],
                             'qic': ['-0.5', '0.5', '-0.5', '0.5'],
                             'rolling_shutter_tr': '0.0',
                             'emit_imu_rate_odom': True,
                             'metrics_path': None,
                             'debug_dir': None,
                             'debug_every': 10,
                             'replay_batch': 1,
                             'pipeline_devices': None},
                  'ate_m': 0.05553884097066741,
                  'ate_one_ulp_m': {'gyro_up': 0.0571281054759201, 'acc_up': 0.058365990068188475,
                                    'xyz_up': 0.056506857263472716,
                                    'xyz_down': 0.05991559389248252},
                  'trajectory_points': 30,
                  'keyframes': 20,
                  'vio_frames': 59,
                  'vio_initialized': True,
                  'failure_count': 0,
                  'prefix_seconds': 1.0,
                  'prefix': [[0.045000000000000005, 0.0005676099099218845, 0.05053116753697395, 0.0, 0.0, 0.0,
                              0.0],
                             [0.245, 0.0025394365657120943, 0.051235098391771317, -0.0017781216884031892,
                              0.202919602394104, 0.006839121226221323, 0.012453915551304817],
                             [0.445, 0.0026421695947647095, 0.050023455172777176, -0.0074341315776109695,
                              0.41066592931747437, -0.00030525019974447787, -0.0004436718299984932],
                             [0.645, 0.0039663128554821014, 0.049137383699417114, -0.015000490471720695,
                              0.6100593209266663, -0.0013696008827537298, 0.0007690397906117141],
                             [0.8450000000000001, 0.00427257502451539, 0.0490410290658474, -0.025557726621627808,
                              0.8127585053443909, -0.0021865300368517637, -0.010929427109658718]]}


# `scripts/run_synthetic_lvi.py` (JAX, CPU) at its default 6 s: the
# configuration's `config_sha256` (`tests/test_lvi_system.py:make_system`,
# which the port's `run_synthetic_lvi.system_config` copies), the ATE (m)
# as the script computes it (rigid alignment of the poses against the
# figure-8 3 m / 30 s), the same with one input a float32 step off
# (`ate_one_ulp_m`: the IMU's gyro or accelerometer up, every scan point up
# or down; the JAX run's own spread, which phase 21's gate spans), the
# poses, the keyframes and the VIO's outcome. Recomputed by
# ``tests/test_torch_synthetic_entry.py::test_jax_synthetic_anchor`` (slow).
SYNTHETIC_LVI = {'duration_s': 6.0,
                 'config_sha256': '1fee3f8f0f68ca6e',
                 'ate_m': 0.050668380740000546,
                 'ate_one_ulp_m': {'gyro_up': 0.04216876458827089,
                                   'acc_up': 0.047517022151874,
                                   'xyz_up': 0.0441301950486538,
                                   'xyz_down': 0.039425314631823215},
                 'trajectory_points': 59,
                 'keyframes': 21,
                 'vio_initialized': True,
                 'failure_count': 0}

# `scripts/run_euroc_vio.py` (JAX, CPU, PIL) over `chip_smoke.py` phase
# 20's folder (`chip_smoke.write_euroc_inputs` of phase 11's 5 s stream at
# 752x480 with its camera YAML): the decoded frames' sha256 (16 hex
# digits), the outcome in `chip_smoke.vio_status`'s terms and the ATE (m,
# None when not live), the poses, failures and the window fill at the end.
# Recomputed by ``tests/test_torch_euroc_entry.py::test_jax_euroc_anchor``
# (slow).
EUROC_VIO = {'frames_sha256': 'a6111fd32bd5bd5c',
             'status': 'rebooted',
             'ate_m': None,
             'trajectory_points': 0,
             'failure_count': 1,
             'frame_count': 10}


def config_fields(cfg) -> dict:
    """A configuration's fields as plain JSON values: dataclasses nested as
    dicts by field name, tuples as lists, floats as their repr."""
    import dataclasses

    def plain(x):
        if dataclasses.is_dataclass(x):
            return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
        if isinstance(x, (tuple, list)):
            return [plain(v) for v in x]
        if isinstance(x, float):
            return repr(x)
        return x

    return plain(cfg)


def config_sha256(cfg) -> str:
    """16 hex digits of sha256 over ``config_fields(cfg)``, so a reference
    value names the configuration that made it. The JAX package's
    dataclasses and the port's have the same fields, so the same
    configuration hashes alike in both."""
    import hashlib
    import json

    text = json.dumps(config_fields(cfg), sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]

