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
  anchor -s``.

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


def config_sha256(cfg) -> str:
    """16 hex digits of sha256 over a configuration's fields (dataclasses
    nested, by field name; tuples as lists), so a reference value names the
    configuration that made it. The JAX package's dataclasses and the port's
    have the same fields, so the same configuration hashes alike in both."""
    import dataclasses
    import hashlib
    import json

    def plain(x):
        if dataclasses.is_dataclass(x):
            return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
        if isinstance(x, (tuple, list)):
            return [plain(v) for v in x]
        if isinstance(x, float):
            return repr(x)
        return x

    text = json.dumps(plain(cfg), sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]
