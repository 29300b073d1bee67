"""Reference values of the JAX package for ``chip_smoke.py``'s tracker and
depth phases.

The machine with the card has no JAX, so the JAX run's numbers are made on
the CPU and stored here. ``TRACKER_SEQUENCE`` is the JAX tracker
(``lvislam_tpu.models.vio.feature_tracker``, ``TrackerParams()`` defaults,
the shipped MEI 1024x576 camera) on ``chip_smoke.tracker_frames()``, and
JAX ``register_depth`` of its last 5 frames against
``chip_smoke.depth_cloud`` of the LIO replay's scans 8..19. The slow test
``tests/test_torch_tracker.py::test_jax_sequence_anchors`` recomputes them
and asserts that they equal these values; it prints them, so

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tracker.py -m slow -k anchors -s

is the command that made them.
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
