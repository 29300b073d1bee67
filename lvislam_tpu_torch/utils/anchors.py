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
