#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``lvislam_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases, one line each:

0. device: the card's name and power limit (nvidia-smi); deterministic mode.
1. build: compile kernels K1-K4 from ``lvislam_tpu_torch/csrc`` with nvcc
   for sm_90a, one process per source.
2. parity: K1's and K2's pair launches (both feature classes in one
   launch) against their plain PyTorch versions at the LIO step's shapes
   (a voxel hash over 16384 corner + 65536 surf map points; 512 corner and
   2048 surf queries): K1 bit-equal; K2 within 2e-4 of scale per class and
   bit-equal to the per-class path (block rows, torch.sum, add). CUDA-event
   timings of both.
3. replay: the bench's 91-scan synthetic LIO sequence through
   ``LioPipeline`` at full width with both kernels on; ATE against the
   clean-CPU anchor in ``bench_anchors.json``, steady per-scan ms, host
   syncs per scan, keyframes, the trajectory's sha256, and kernel launch
   counts: one K2 launch per GN iteration, one K1 launch per refresh.
4. determinism: a second replay must reproduce the trajectory bit for bit.
3b. lio_upload_batch: the port benchmark's LIO section
   (``lvislam_tpu_torch/scripts/bench.py``: phase 3's configuration at
   ``upload_batch = 8``, ``bench.py:231``; 11 warm scans, then the faster of
   two segments of 40): the trajectory's sha256 equal to phase 3's,
   ceil(91 / 8) uploads (the pipeline's count of its copies), the ATE within
   +5% of the anchor; ``bench.py``'s headline keys beside phase 3's ms a
   scan.
5. CLAHE kernels K3 (tile_hist) and K4 (apply_cdf) from
   ``lvislam_tpu_torch/csrc/clahe.cu`` against their plain versions, bit for
   bit, on a rendered MEI 576x1024 frame and a uniform-random image (the
   vector kernels), on the frame cropped to 480x752 and a uniform-random
   480x752 image (the EuRoC camera's size: the aligned kernels) and on the
   frame cropped to 571x1021 (the general kernels), with CUDA-event timings
   of both.
6. tracker: 20 MEI 1024x576 frames of the LIO replay's world and trajectory
   (t = 0.1 + i/10 s) through ``FeatureTracker`` at ``TrackerParams()``
   defaults with K3 and K4 on. Gates: each kernel launched once a frame;
   per-frame tracked counts and the median epipolar residual under the
   ground-truth relative pose against the JAX CPU run's values stored in
   ``lvislam_tpu_torch/utils/anchors.py``; a second run bit-identical.
   Reports steady per-frame ms and host syncs per frame.
7. depth: ``register_depth`` of the last 5 frames' features against a
   12 x 4096-point world cloud from the LIO replay's scans; the share of
   features given a depth and the median error against a raycast, gated
   against the JAX run's values.
8. alone: each kernel's raw entry point, 100 launches captured in a CUDA
   graph at the main path's shapes (inputs rotated out of L2 for K1, K3
   and K4), per-launch µs against its bound (bytes at 3.35 TB/s or f32
   operations at 67 TFLOP/s), and the latency floor of K1 (one query), K2
   (one point a class), K3 and K4 (an 8x8 image in one tile); K3 also on a
   constant frame. The library yardsticks beside K1, K3 and K4 (never called
   by the port): ``torch.topk`` on K1's masked distances, ``torch.bincount``
   on K3's precomputed keys tile * 256 + bin, one 5-D ``F.grid_sample`` of
   the CDF volume at K4's precomputed coordinates (K3's and K4's also at
   480x752 in phase 11). Then the batched forms of K1 and K2 (one launch
   for S = 4 sequences, as JAX's vmap gives the TPU kernels) on four
   sequences at these shapes (the hashes stacked, four poses and query
   offsets): K1 equal to its plain version and to 4 unbatched launches, K2
   bit-equal to 4 unbatched launches and, a sequence, within 2e-4 of its
   plain version's scale with n_res exact (as the pair launch is held);
   each timed alone beside 4 single launches, against S times the
   unbatched bound (``[batched_alone]``).

9. IMU side: (a) ``navstate_predict`` over 60 s x 200 Hz of the figure-8's
   ideal IMU stream against ``navstate_predict_seq`` (the JAX parity test's
   tolerances at its 64-sample length; stated bounds over all 12000
   samples) and against the float64 ``navstate_predict_np``; (b) the
   two-state smoother over the LIO replay of phase 3: ``fusion_initialize``
   on the first pose, one ``fusion_correct`` a scan with biased, noisy IMU
   samples and the replay's own pose as the correction. Gates: never failed,
   the gyro bias within 0.6 of the injected one's norm, the fused position
   within 0.1 m of the last correction. ms, device kernels and host syncs a
   correction; (c) ``predict_imu_rate`` over 5 s against the truth.
10. VIO at the fixture's size (320x240, 64 features, window 10, 128 slots, 4
   iterations, CLAHE off): 5 s of rendered frames (8-bit) and 200 Hz IMU on
   the figure-8 (scale 1.5, period 8 s) through ``VioRunner``, once for
   every entry of ``VIO_SEEDS``, which sets the RANSAC draws: 0 the port's
   own default, as a plain ``VioRunner(cfg)`` draws; s > 0 a host generator
   seeded s, so the card draws what a CPU run draws. On this short stream
   the visual bootstrap gets a handful of attempts, and which of them passes
   hangs on the draws, in the JAX package as here: so the gate is a count. A
   run is "ok" when it ends initialized with no failure, a full window and
   an ATE under 0.5 m after rigid alignment; the phase needs as many "ok"
   runs as the JAX CPU runs of the same stream had over the same seeds
   (``lvislam_tpu_torch/utils/anchors.py``), less one, and one at least.
   Every run's outcome is printed beside JAX's; a run that ends initialized
   and unflagged with a larger ATE is named "misinitialized". The first "ok"
   run is repeated and must come out bit-identical.
11. VIO at full width: the EuRoC cam0 size (752x480 pinhole, no distortion),
   150 features, CLAHE on, 256 slots, 6 iterations; K3 and K4 held against
   their plain versions at this shape and timed alone against its bound
   first (the aligned kernels). The same gate; of the first "ok" run: ms a
   frame split into tracker / process_imu / process_image, BA iterations and
   host syncs a frame, K3/K4 launches (one a frame) and the kernels they
   took.
12. BA alone: ``ba.solve`` with "qr", "cholesky" and "schur" on the exact
   synthetic window at the reference shape (window 10, 150 features); the
   three must agree; ms a solve by CUDA events.

13. loop_db: the visual loop detector alone (``add_and_detect``, the port's
   default draws) over the revisit scene of ``tests/test_loop_detector.py``
   (world seed 3, figure-8 period 8 s, 21 frames 320x240, raycast depths):
   the accepted (frame, old) pairs equal to the JAX CPU run's
   (``utils/anchors.LOOP_SCENE``), or differing in one pair only where the
   card's PnP inliers for that (frame, old slot) lie within 2 of
   ``min_loop_matches``; at least one pair. ms an ``add_and_detect`` (CUDA
   events); the BoW scores of frames where the card verified another slot.
14. lvi_parity: config 5 at the parity scale (``bench.py:465-545``: the 12 s
   figure-8, 4 x 900 scans, 320x240 pinhole frames; ``make_system`` with
   ``apply_perf_knobs``, K1 on) through ``LviSystem``'s entry points, 2 s
   warm, 10 s timed. Gates: the configuration (kernels aside) and the
   stream hash to the JAX anchor's; the VIO initialized with no failure and
   ``vins_odom`` set; the aligned ATE within LVI_BAND of the worst of the
   JAX package's clean-CPU readings (``utils/anchors.LVI_PARITY``, the
   interactive path, and ``bench_anchors.json``, the batched replay); the
   first 4 s repeated bit for bit. Reports RTF, ms a steady ``lidar`` and
   ``image`` handler (``MetricsLogger``), host syncs a scan and a frame,
   K1 launches a processed scan, and the init frame and path.
15. lvi_full: config 5 at the shipped scale (``bench.py:668-767``: 7 s,
   4 x 6000 scans, the MEI 1024x576 rig with CLAHE, 150 features, the loop
   detector with the trained vocabulary; K1-K4 on), 2 s warm, 5 s timed.
   Gates: VIO initialized, no failure, loop-database inserts equal to the
   VIO keyframes after initialization, each kernel launched, ATE <= 0.10 m
   (if not, a second run with mapRebuildEvery=1 is printed beside it and
   gated). The streams of phases 14 and 15 are raycast by worker processes
   while phases 1-12 run.
Phases 15, 16, 17, 20, 21, 24 and 25 run in seven spawned processes of
their own, on the card, while the main process runs phases 18, 19, 14, 22
and 26 (every phase is host-bound and the card mostly idle; so the host
times of phases 14-26 are taken with eight processes on the card):

16. bag_fixture: the bag-replay entry point (``python -m
   lvislam_tpu_torch.scripts.run_rosbag_lvi``, called in-process on the
   card) over the committed fixture bag (``tests/data/fixture_mid360.db3``:
   6 s, JPEG frames 320x240, 4 x 900 livox scans) with
   ``tests/data/fixture_{lidar,camera}.yaml``. Gates: 1,200 IMU, 59 livox
   and 59 image messages, none skipped; the decoded frames' sha256 equal to
   PIL's; the script's ``LviConfig`` equal to the JAX script's (field dict
   and hash); the TUM trajectory (>= 10 rows, finite, stamps increasing, a
   plausible span) and a ``.pcd`` in the saved map; the aligned ATE within
   LVI_BAND of the worst of the JAX CPU runs' (the script's own run and
   four with one input a float32 step off: the JAX run's own spread; all in
   ``utils/anchors.ROSBAG_FIXTURE``);
   no kernel launched (the script keeps K1 and K2 off, the fixture's
   camera has CLAHE off). Reports RTF, handler ms, host syncs, poses.
17. bag_shipped: phase 15's stream written by ``utils/bag_writer`` into
   ``.chip_tmp/`` as a rosbag2 file (IMU, livox scans, raw mono8 frames at
   1024x576), beside ``configs/params_{lidar,camera}.yaml`` with the fields
   of ``shipped_camera_overrides`` replaced (the render's camera-to-body
   rotation and zero translation, phase 15's VIO noise and gravity, 4 BA
   iterations, no td estimate), replayed by the same script. Gates: K3 and
   K4 launched once a frame, VIO initialized with no failure, ATE <=
   0.10 m. Reports RTF and the write and replay wall times; after phase 15,
   ``[bag_shipped_vs_full]`` gives the max and RMS distance of its poses
   from phase 15's at the same stamps.

18. host_tools: the native host library (``utils/native``, built from
   ``native/src/lvislam_native.cpp``) must have built, and its
   ``decode_pointcloud2``, ``imu_window`` and ``voxel_prefilter`` equal the
   NumPy path exactly on ``tests/test_native.py``'s blob and on one of the
   bench's 4 x 6000 scans; phase 11's first 752x480 frame through the
   port's PNG writer and decoder byte for byte (ms a frame); the exact
   greedy LOAM pick (``loam.select_edges``) on the card equal to the port's
   CPU run on the same curvature input, timed by ``utils/profiling.
   device_timer``.
19. calibration: ``tests/test_chessboard_calibration_e2e.py``'s eight
   rendered views detected (``find_chessboard``) and calibrated
   (``calibrate``, PINHOLE, 25 iterations) on the card under that test's
   gates (every view found, corners within 0.7 px, rms < 0.3 px, focal
   within 1 %, principal point within 10 px); the MEI case of
   ``tests/test_calibration.py`` under its own (rms < 0.2 px, principal
   point within 2 %); ms a solve.
20. euroc: phase 11's 5 s stream written as a EuRoC ``mav0`` folder (PNG
   frames by the port's writer, IMU stamps in ns at the MH_01 epoch) with
   a reference-format camera YAML of phase 11's rig, through the port's
   ``run_euroc_vio`` at 752x480 with CLAHE. Gates: the decoded frames'
   sha256 equal to phase 11's; K3 = K4 = frames; the TUM rows finite,
   increasing and equal to the runner's trajectory; no "misinitialized"
   outcome. The status and ATE are printed beside phase 11's entry 0 (the
   same default draws; "ok" is not gated, as there).
21. synthetic: the port's ``run_synthetic_lvi`` at its default 6 s with
   ``--save-map``, ``--checkpoint`` and ``--html``. Gates: VIO initialized
   with no failure; ATE within LVI_BAND of the worst JAX CPU reading of the
   same run (``utils/anchors.SYNTHETIC_LVI``: its own and four with one
   input a float32 step off); the PCD, PPM and HTML files written; the
   checkpoint reloaded by ``load_state`` equal to the state.

Phase 14's 4 s repeat runs with ``debug_dir`` set (``DEBUG_EVERY``): it
must still be bit-identical to the first run and write the feature and
depth overlays at that stride.

22. multi_device (main process, after phase 14): the multi-device part at
   config 3's widths, on meshes of ``cuda:0`` repeated (distinct cards where
   the machine has them; each line prints which). Input: one steady scan of
   phase 3's replay (scans 0-29 through ``LioPipeline``, then scan 30's
   downsampled 512 corner / 2048 surf features, the state's pose and its
   local map of 16384 corner / 65536 surf slots). (a) ``sharded_knn`` with
   ``map`` = 1, 2, 4 against the unsharded ``knn``, both classes: sorted
   distances within 1e-4 (rel and abs), equal neighbour sets for >= 98% of
   the valid queries; (b) ``sharded_scan_to_map`` with ``map`` = 1, 2, 4
   against ``scan_to_map``: x6 within 5e-4, residual counts within 2,
   ``converged`` equal (``tests/test_parallel.py``'s bounds); ms each; (c)
   ``make_batched_step`` on a (batch 4, map 1) mesh over four sequences of 16
   scans starting at scans 0, 20, 40, 60 (features from the port's front
   end): each sequence's outputs and final state bit-equal (sha256) to its
   own unbatched ``map_step`` run, the keyframe clouds distinct; the GN in
   lockstep, one per device: K1 / K2 launched as many times as the
   unbatched runs' per-step GN iterations imply (a step: its longest GN's
   iterations of K2, its refreshes of K1), and fewer than the unbatched
   runs launch them; the ms
   and host syncs of a lockstep step beside 4 x an unbatched step (logged,
   not gated); (d) ``make_batched_loop_step`` on that
   state with keyframe 0 made 100 s older (the ICP runs): equal to four
   unbatched ``loop_closure_step`` calls.
24. lvi_replay (a spawned process): phase 14's configuration with the
   batched fused replay (``replay_batch = 16``, ``bench.py:539``) over the
   same 12 s stream, 2 s warm and 10 s timed: the interactive path until
   the VIO is up, then every 16 events one upload, one ``replay_batch_step``
   and one deferred readback. Gates: the replay activated and shipped
   batches; one upload and one readback a batch; every staged event came
   back; VIO initialized, 0 failures; aligned ATE <= LVI_BAND x the worst
   JAX replay reading (``utils/anchors.LVI_REPLAY``: its own and four
   one-ulp runs); the configuration (kernels aside) and stream hashes the
   anchor's; the first 4 s bit-identical on repeat. Reports RTF, handler ms,
   host syncs and K1 launches a scan event and a frame event.
25. lvi_replay_full (a spawned process): phase 15's configuration with
   ``replay_batch = 16`` (``bench.py:733``), 2 s warm, 5 s timed. Gates: the
   replay's as in 24; K1-K4 each launched inside the replay, K3 = K4 = the
   frame events; loop-database inserts = VIO keyframes after
   initialization; ATE <= 0.10 m. ``[lvi_replay_vs_parity]`` and
   ``[lvi_replay_full_vs_full]`` print 24 and 25 beside 14 and 15.

26. tools (main process, after phase 22): the port's tools
   (``lvislam_tpu_torch/scripts/``) on the card: the benchmark's ``imu`` and
   ``vio`` sections (every ``bench.py`` key present and finite; K3 and K4
   launched in ``tracker_step_ms``'s call); ``profile stages`` on phase 3's
   scans and ``profile query`` at the full shapes (the stages' device time
   within 10% of the whole step's; K1's wrapper, its plain version and
   ``torch.topk`` select the same neighbours); ``train_vocab`` at toy
   arguments on the card and on the CPU (vocabulary and idf equal).

``--loop`` adds the 38 s revisit arm of ``bench.py:770-887`` on the parity
configuration (192 keyframes, 16 loop slots): at least one loop factor.

Then one JSON line of kernel records, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
There is no CPU path: without a GPU the script fails.

``python3 chip_smoke.py --profile N`` adds torch.profiler traces of N
steady scans, N steady tracker frames and the last N frames of each VIO run
(device busy share, device time by kernel; K1-K4's launches and device time
a scan or frame) before the result. ``--sweep`` adds to phases 8 and 11
the launch sizes beside the wrappers' own, at 576x1024 and 480x752: K3 at 1
to 8 slabs a tile or group, K4 in blocks of 12 to 48 rows by 16 to 128
columns from column 0 (the aligned cut) and, where tw % 8 == 0, at 9 to 36
rows of one lattice cell; both general kernels, K4's also on the frame's
first 64 rows (as many rows a block, fewer blocks: its cost a block).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

# cuBLAS needs a fixed workspace for deterministic mode
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = os.path.dirname(os.path.abspath(__file__))

# the bench's configurations and streams (one home: the port's benchmark);
# N_SCANS, RATE: the LIO replay; UPLOAD_BATCH, REPLAY_BATCH: phases 3b, 24, 25
from lvislam_tpu_torch.scripts.bench_inputs import (  # noqa: E402
    N_SCANS, RATE, REPLAY_BATCH, UPLOAD_BATCH, Prefetch, full_width_config, lvi_full_config,
    lvi_loop_config, lvi_parity_config, lvi_stream, scan_jobs, stream_pool)
from lvislam_tpu_torch.scripts.profile import RANGES  # noqa: E402

ATE_LIMIT_PCT = 5.0  # BASELINE criterion: not more than 5% worse than the anchor
N_WARM = 11
# the tracker sequence: 20 frames at 10 Hz from t = 0.1 s (bench.py's
# camera timing); depth for the last 5 frames against scans 8..19
N_FRAMES, DEPTH_FRAMES = 20, 5
CLOUD_SCANS, CLOUD_PER_SCAN = range(8, 20), 4096
FOCAL_VIRTUAL = 460.0  # the tracker's rejectWithF focal length
DEPTH_SHARE_TOL = 0.10  # absolute, on the share of features given a depth
DEPTH_ERR_FACTOR, DEPTH_ERR_SLACK_M = 1.5, 0.02  # median error <= 1.5 x JAX + 2 cm
# one H100 SXM at its 700 W limit (NVIDIA's H100 data sheet)
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12
L2_BYTES = 50e6  # phase 8 rotates inputs through twice this
GRID_SAMPLE_TOL = 1e-5  # K4's yardstick against the plain version (its own blend order)
# K2's f32 operations a point, counted by hand from csrc/gn_partials.cu
# (transform, gate, mean, scatter, eigensystem, 1 or 2 eigenvectors, plane
# or line coefficients, J row, 27 partials, the block tree)
K2_FLOPS_PER_POINT = {"corner": 450, "surf": 600}
# phases 9-12: the IMU side and the VIO estimator
IMU_SECONDS, IMU_HZ = 60.0, 200  # the dead-reckoning stream
DR_TEST_TOL = {"pos": 2e-4, "quat": 2e-6, "vel": 2e-4}  # the JAX parity test's, 64 samples
DR_SEQ_TOL = {"pos": 2e-2, "quat": 1e-5, "vel": 1e-3}  # 12000 samples, f32 sequential
DR_F64_TOL = {"pos": 2e-3, "quat": 1e-6, "vel": 1e-4}  # 12000 samples, float64
TRUE_BG, TRUE_BA = (0.02, -0.01, 0.015), (0.05, 0.08, -0.06)  # injected IMU biases
FUSION_SAMPLES = 24  # IMU samples a correction (200 Hz / 10 Hz = 20, padded)
VIO_SECONDS, VIO_ATE_LIMIT_M = 5.0, 0.5
# The RANSAC draws of the VIO phases' runs: every entry is run and none is
# picked. 0 stands for the port's own default draws, as a plain
# `VioRunner(cfg)` makes them (a generator on the card, seeded 0 at each
# call); s > 0 for a host generator seeded s (the card then draws what a CPU
# run draws). Each is printed beside the JAX CPU run of the same number
# (0: the JAX package's default key; s: s folded into it). The phase needs
# as many runs that meet the gates as JAX had over the same numbers, less
# VIO_OK_SLACK: one run's outcome is chance (the card does not follow a CPU
# run of the same seed: one rounding moves an 8-point model), so equal rates
# can differ by one. Three entries: a run takes 35-60 s of the script's time.
VIO_SEEDS = (0, 1, 2)
VIO_OK_SLACK = 1
BA_WINDOW, BA_FEATURES = 10, 150
BA_REFERENCE_BUDGET = "35ms/10iterations"  # the reference estimator's solver budget
# phases 13-15: the fused system (config 5)
LVI_WARM_S, LVI_PARITY_S, LVI_REPEAT_S, LVI_FULL_S, LVI_LOOP_S = 2.0, 12.0, 4.0, 7.0, 38.0
# the parity gate: the worst of the JAX package's clean-CPU readings of the
# sequence (interactive path and batched replay) times the ~5% build band
# NOTES r5 measured on the JAX side (0.0904-0.0961 m)
LVI_BAND = 1.05
LVI_FULL_ATE_M = 0.10  # an absolute bound of the shipped-scale sequence


T_START = time.perf_counter()


def log(phase: str, **kw):
    """One line a result; `t` is the seconds since the script started."""
    kw["t"] = round(time.perf_counter() - T_START, 1)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def sha256(*arrays) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def cuda_ms(fn, reps: int = 50, warm: int = 5) -> float:
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_us(launch, n_launch: int = 100, replays: int = 5) -> float:
    """Device µs per launch with no host enqueue in the way: `n_launch`
    back-to-back calls of ``launch(i, stream)`` (a raw kernel entry point;
    ``i`` picks the input set) captured in one CUDA graph on the capture
    stream, the graph replayed and timed with CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            launch(i, side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(n_launch):
            launch(i, stream)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (replays * n_launch)


def bound_us(n_bytes: float, n_flops: float):
    """(least µs, what sets it): bytes over HBM rate vs f32 operations over
    the f32 peak (H100 SXM data sheet)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e6
    t_ops = n_flops / F32_FLOPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cold_copies(tensors, n_bytes):
    """Enough copies of `tensors` (`n_bytes` a set) that launches taking
    them in turn pass the L2 twice over, and so find their inputs cold (at
    most 128: a graph of `graph_us` takes 100)."""
    n = min(max(2, -(-int(2 * L2_BYTES) // int(n_bytes)) + 1), 128)
    return [[t.clone() for t in tensors] for _ in range(n)]


def parity_inputs(dev):
    """Map points on the synthetic world's surfaces (16384 corner, 65536
    surf), their voxel hashes, and perturbed queries at the step's sizes."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.ops import voxel_hash as vh
    from lvislam_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(0)
    w = syn.default_world(seed=0)
    P = w.plane_p0.shape[0]
    k = rng.integers(0, P, 65536)
    ua = rng.uniform(-1, 1, 65536)[:, None] * w.plane_ext[k, 0:1]
    ub = rng.uniform(-1, 1, 65536)[:, None] * w.plane_ext[k, 1:2]
    surf = w.plane_p0[k] + ua * w.plane_a[k] + ub * w.plane_b[k]
    # corners: points along 200 vertical edges spread over the room
    lines = rng.uniform(-13.0, 13.0, (200, 2))
    corner = np.c_[lines[rng.integers(0, 200, 16384)], rng.uniform(-1.6, 2.6, 16384)]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    surf, corner = f32(surf), f32(corner)
    h_c = vh.build(corner, torch.ones(16384, dtype=torch.bool, device=dev), 1.0, 1 << 14, 32)
    h_s = vh.build(surf, torch.ones(65536, dtype=torch.bool, device=dev), 1.0, 1 << 16, 16)
    q_c = corner[torch.as_tensor(rng.integers(0, 16384, 512), device=dev)] + f32(rng.normal(0, 0.3, (512, 3)))
    q_s = surf[torch.as_tensor(rng.integers(0, 65536, 2048), device=dev)] + f32(rng.normal(0, 0.3, (2048, 3)))
    x6 = f32(rng.uniform(-0.05, 0.05, 6))
    return corner, surf, h_c, h_s, q_c, q_s, x6


def knn_set(h, q):
    """K1's inputs (cand, want_tag, corner_off, bucket) for queries `q`
    against hash `h`, as ``voxel_hash.query_score`` forms them."""
    from lvislam_tpu_torch.ops import voxel_hash as vh

    return vh._query_set(h, vh.query_gather(h, q), q)


def check_knn_pair(sets, names):
    """K1's pair launch against its plain version on two query sets:
    positions identical and distances bit-equal. Returns (max abs err,
    kernel ms, plain ms) of the pair."""
    import torch

    from lvislam_tpu_torch.ops import knn_tail as kt

    got = kt.knn_tail_pair(*sets, k=5)
    ref = kt.knn_tail_pair_plain(*sets, k=5)
    torch.cuda.synchronize()
    for (d1, p1), (d0, p0), name in zip(got, ref, names):
        if not torch.equal(p1, p0):
            raise AssertionError(f"K1 {name}: positions differ at "
                                 f"{int((p1 != p0).sum())} of {p1.numel()}")
        if not torch.equal(d1.view(torch.int32), d0.view(torch.int32)):
            raise AssertionError(f"K1 {name}: distances not bit-equal "
                                 f"(max {float((d1 - d0).abs().max()):.3e})")
    err = max(float((g[0] - r[0]).abs().max()) for g, r in zip(got, ref))
    ms = cuda_ms(lambda: kt.knn_tail_pair(*sets, k=5))
    plain_ms = cuda_ms(lambda: kt.knn_tail_pair_plain(*sets, k=5))
    found = [round(float((r[0] < 1e9).float().mean()), 4) for r in ref]
    shape = ",".join(f"{n}:Q={s[0].shape[0]},B={s[3]}" for n, s in zip(names, sets))
    log("parity", kernel="K1", shape=shape, positions="identical", distances="bit-equal",
        max_abs_err=err, found_frac=found, ms=round(ms, 4), plain_ms=round(plain_ms, 4))
    return err, ms, plain_ms


def gn_blocks(h, map_pts, q_world, x6):
    """K2's packed (pts, nbr) blocks for world-frame queries `q_world`
    observed from pose `x6`, neighbours from hash `h` over `map_pts`."""
    import torch

    from lvislam_tpu_torch.core import lie
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import scan2map
    from lvislam_tpu_torch.ops import voxel_hash as vh

    R = lie.x6_rotation(x6)
    t = x6[3:6]
    q_lidar = (q_world - t) @ R  # R^T (p - t)
    valid = torch.ones(q_lidar.shape[0], dtype=torch.bool, device=q_lidar.device)
    idx, _ = vh.query(h, scan2map.apply_pose(R, t, q_lidar), 5)
    nbrs = map_pts[torch.clamp(idx, min=0).long()]
    return gnp.pack_pts(q_lidar, valid), gnp.pack_nbrs(nbrs, idx >= 0)


def gn_pose(x6):
    from lvislam_tpu_torch.core import lie
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import scan2map

    return gnp.pack_pose(lie.x6_rotation(x6), x6[3:6], scan2map._euler_jac_mats(x6))


def gn_per_class_path(c_pts, c_nbr, s_pts, s_nbr, par):
    """The per-class path K2's pair launch must equal bit for bit: each
    class's block rows summed by ``torch.sum(rows, dim=0)``, the classes
    then added. The rows come from the kernel's own scratch (one raw pair
    launch). Returns ((H, g, n) of the pair launch, of the per-class path)."""
    import torch

    from lvislam_tpu_torch.ops import _kernels

    dev = par.device
    bc, bs = (c_pts.shape[1] + 127) // 128, (s_pts.shape[1] + 127) // 128
    rows = torch.empty((bc + bs, 28), device=dev)
    out = torch.empty(43, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    _kernels.check(_kernels.library().lvt_gn_partials_pair(
        c_pts.data_ptr(), c_nbr.data_ptr(), c_pts.shape[1], s_pts.data_ptr(),
        s_nbr.data_ptr(), s_pts.shape[1], par.data_ptr(), rows.data_ptr(),
        ticket.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "lvt_gn_partials_pair")
    sym = torch.tensor([[min(a, b) * (11 - min(a, b)) // 2 + max(a, b) for b in range(6)]
                        for a in range(6)], device=dev)

    def assemble(part):
        return part[sym], part[21:27], part[27].to(torch.int32)

    Hc, gc, nc = assemble(torch.sum(rows[:bc], dim=0))
    Hs, gs, ns = assemble(torch.sum(rows[bc:], dim=0))
    return ((out[:36].view(6, 6), out[36:42], out[42:].view(torch.int32)[0]),
            (Hc + Hs, gc + gs, nc + ns))


def bits_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


def check_gn_pair(blocks, par):
    """K2 on the corner and surf classes' `blocks`: each class's launch
    against its plain version (residual count exact, H and g within 2e-4 of
    the class's scale), and the pair launch bit-equal to the per-class path
    and to the two single-class launches added. Returns (max abs err of the
    pair against its plain version, kernel ms, plain ms)."""
    import torch

    from lvislam_tpu_torch.ops import gn_partials as gnp

    (c_pts, c_nbr), (s_pts, s_nbr) = blocks
    H1, g1, n1 = gnp.gn_partials_pair(c_pts, c_nbr, s_pts, s_nbr, par)
    H0, g0, _ = gnp.gn_partials_pair_plain(c_pts, c_nbr, s_pts, s_nbr, par)
    raw, per_class = gn_per_class_path(c_pts, c_nbr, s_pts, s_nbr, par)
    single = [gnp.gn_partials(*b, par, kind) for b, kind in zip(blocks, ("corner", "surf"))]
    plain = [gnp.gn_partials_plain(*b, par, kind) for b, kind in zip(blocks, ("corner", "surf"))]
    torch.cuda.synchronize()
    for (Hk, gk, nk), (Hp, gp, np_), kind in zip(single, plain, ("corner", "surf")):
        if int(nk) != int(np_):
            raise AssertionError(f"K2 {kind}: n_res {int(nk)} vs plain {int(np_)}")
        torch.testing.assert_close(Hk, Hp, atol=2e-4 * max(float(Hp.abs().max()), 1e-6),
                                   rtol=2e-4)
        torch.testing.assert_close(gk, gp, atol=2e-4 * max(float(gp.abs().max()), 1e-6),
                                   rtol=2e-4)
    if not bits_equal(raw, per_class):
        raise AssertionError("K2: the pair launch differs from the per-class path "
                             "(block rows + torch.sum + add)")
    if not bits_equal((H1, g1, n1), raw):
        raise AssertionError("K2: gn_partials_pair differs from the raw launch")
    (Hc, gc, nc), (Hs, gs, ns) = single
    if not bits_equal((H1, g1, n1), (Hc + Hs, gc + gs, nc + ns)):
        raise AssertionError("K2: the pair launch differs from two single-class launches added")
    err = max(float((H1 - H0).abs().max()), float((g1 - g0).abs().max()))
    ms = cuda_ms(lambda: gnp.gn_partials_pair(c_pts, c_nbr, s_pts, s_nbr, par))
    plain_ms = cuda_ms(lambda: gnp.gn_partials_pair_plain(c_pts, c_nbr, s_pts, s_nbr, par))
    log("parity", kernel="K2", shape=f"corner:N={c_pts.shape[1]},surf:N={s_pts.shape[1]}",
        n_res=int(n1), per_class_path="bit-equal", max_abs_err=err,
        H_scale=float(H0.abs().max()), ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        sha256=sha256(*(t.cpu().numpy() for t in (H1, g1, n1))))
    return err, ms, plain_ms


def replay(cfg, scans, dev):
    """One full replay through LioPipeline; returns (trajectory (N,6),
    per-scan seconds, host syncs per scan, keyframes, GN iterations per
    scan)."""
    import torch

    from lvislam_tpu_torch.core import hostsync
    from lvislam_tpu_torch.models.lio.pipeline import LioPipeline

    pipe = LioPipeline(cfg, device=dev)
    torch.cuda.synchronize()
    times, syncs, iters = [], [], []
    for s in scans:
        hostsync.reset()
        t0 = time.perf_counter()
        out = pipe.process_scan(s[0], s[1], s[2], s[3])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        syncs.append(hostsync.COUNT)
        iters.append(out.gn_iters)
    return (pipe.trajectory_array(), times, syncs, int(pipe.state.kf_count),
            torch.stack(iters).cpu().numpy().astype(int))


def lio_upload_batch_phase(scans, dev, ref_sha: str, ref_ms: float) -> dict:
    """Phase 3b: the port benchmark's LIO section (`bench.lio_section`:
    phase 3's configuration at `upload_batch = UPLOAD_BATCH`, 11 warm scans,
    then the faster of two segments of 40) over phase 3's 91 scans. Gates:
    the trajectory's sha256 equal to phase 3's; ceil(N_SCANS / UPLOAD_BATCH)
    uploads (the pipeline's own count of its host-to-device copies);
    `ate_vs_cpu_ref_pct` <= ATE_LIMIT_PCT. Prints `bench.py`'s headline keys
    beside phase 3's ms a scan. The JAX package's dispatch modes
    (`async_dispatch`, `pipelined_uploads`) select nothing here: one run
    covers them. Returns the run's K1 / K2 launches."""
    import math

    from lvislam_tpu_torch.scripts import bench

    want = math.ceil(len(scans) / UPLOAD_BATCH)
    out = {}
    got = bench.lio_section(out, scans, dev)
    sha = sha256(got["trajectory"])
    log("lio_upload_batch", upload_batch=UPLOAD_BATCH, uploads=got["uploads"],
        uploads_expected=want, phase3_ms_per_scan=round(ref_ms, 3), trajectory_sha256=sha,
        phase3_sha256=ref_sha, bit_equal=sha == ref_sha, **out)
    if sha != ref_sha:
        raise AssertionError(f"lio_upload_batch: trajectory {sha} is not phase 3's {ref_sha}")
    if got["uploads"] != want:
        raise AssertionError(f"lio_upload_batch: {got['uploads']} uploads for {len(scans)} "
                             f"scans at {UPLOAD_BATCH} a batch ({want})")
    if not out["ate_vs_cpu_ref_pct"] <= ATE_LIMIT_PCT:
        raise AssertionError(f"lio_upload_batch: ATE {out['ate_rmse_m']} m is "
                             f"{out['ate_vs_cpu_ref_pct']:+}% vs the anchor (limit "
                             f"+{ATE_LIMIT_PCT}%)")
    return got["launches"]


def profile_steady(cfg, scans, dev, n_prof: int):
    """Replay the warm-up scans, then trace `n_prof` steady scans with
    torch.profiler: device busy share and device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lvislam_tpu_torch.models.lio.pipeline import LioPipeline

    pipe = LioPipeline(cfg, device=dev)
    for s in scans[:N_WARM]:
        pipe.process_scan(s[0], s[1], s[2], s[3])
    torch.cuda.synchronize()
    iters = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in scans[N_WARM:N_WARM + n_prof]:
            iters.append(pipe.process_scan(s[0], s[1], s[2], s[3]).gn_iters)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels launched inside the GN loop: launch calls on the host that
    # fall inside a `lio.scan_to_map` range
    evts = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in evts
             if e.name == "lio.scan_to_map" and e.device_type == torch.autograd.DeviceType.CPU]
    gn_launches = sum(1 for e in evts if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC")
                      and any(a <= e.time_range.start <= b for a, b in spans))
    n_it = int(torch.stack(iters).sum())
    log("profile", gn_iters=n_it, kernels_in_gn_loop=gn_launches,
        kernels_per_gn_iter=round(gn_launches / max(n_it, 1), 1))
    # device-side kernel events only (an op's row repeats its kernels' time,
    # and a range's device row spans the kernels inside it)
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and not e.key.startswith(RANGES)]
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows if r[1] > 0)
    log("profile", scans=n_prof, wall_ms_per_scan=round(wall_us / n_prof / 1e3, 3),
        device_ms_per_scan=round(busy / n_prof / 1e3, 3),
        device_busy_share=round(busy / wall_us, 4),
        device_ops_per_scan=round(launches / n_prof, 1),
        host_ops_per_scan=round(sum(e.count for e in prof.key_averages()
                                    if e.key.startswith("aten::")) / n_prof, 1))
    for key, us, cnt in sorted(rows, key=lambda r: -r[1])[:15]:
        print(f"  {us / n_prof / 1e3:8.4f} ms/scan  {cnt / n_prof:7.1f}/scan  {key[:90]}",
              flush=True)
    for e in prof.key_averages():
        if e.key.startswith("lio.") and e.device_type == torch.autograd.DeviceType.CPU:
            log("profile", stage=e.key, calls_per_scan=round(e.count / n_prof, 2),
                host_ms_per_scan=round(e.cpu_time_total / n_prof / 1e3, 3))
    for name in ("knn_tail", "gn_partials"):
        us = sum(r[1] for r in rows if name in r[0])
        cnt = sum(r[2] for r in rows if name in r[0])
        log("profile", kernel=name, launches_per_scan=round(cnt / n_prof, 2),
            device_us_per_launch=round(us / max(cnt, 1), 2),
            device_ms_per_scan=round(us / n_prof / 1e3, 4))


def alone_reporter(rec: dict):
    """`report(name, µs, bytes, operations, shape)`: holds a kernel-alone
    time against its bound, logs the line and files the record in `rec`."""
    def report(name, us, n_bytes, n_flops, shape):
        b, by = bound_us(n_bytes, n_flops)
        rec[name] = {"kernel_us": us, "bound_us": b, "bound_by": by, "bound_share": b / us,
                     "library_ms": None}
        log("alone", kernel=name, shape=shape, kernel_us=round(us, 3), bound_us=round(b, 4),
            bound_by=by, bound_share=round(b / us, 4), MB=round(n_bytes / 1e6, 3))
        return rec[name]
    return report


K1_K = 5  # neighbours a query


def k1_set(cand, want, off, B, dev):
    """A K1 query set for timing: its fresh outputs, bytes, operations and
    enough copies of its inputs to find them cold in L2."""
    import torch

    Q = cand.shape[0]
    outs = (torch.empty((Q, K1_K), device=dev),
            torch.empty((Q, K1_K), dtype=torch.int32, device=dev))
    n_bytes = nbytes((cand, want, off, *outs))
    return {"Q": Q, "B": B, "outs": outs, "bytes": n_bytes,
            "flops": Q * 27 * B * 8,  # 3 offset adds, 3 squares, 2 adds a candidate
            "inputs": (cand, want, off), "copies": cold_copies((cand, want, off), n_bytes)}


def k1_rows(qs, lo: int, hi: int):
    """Rows [lo, hi) of a `k1_set` (views of its inputs, copies, outputs)."""
    return {"Q": hi - lo, "B": qs["B"], "outs": tuple(o[lo:hi] for o in qs["outs"]),
            "copies": [[t[lo:hi] for t in c] for c in qs["copies"]]}


def k1_launch(pairs):
    """`launch(i, stream)` of the raw K1 pair entry point: one launch for
    each (corner set, surf set) of `pairs` (None for an empty set), on
    copy i of their inputs."""
    from lvislam_tpu_torch.ops import _kernels

    lib = _kernels.library()

    def launch(i, stream):
        for pair in pairs:
            args = []
            for qs in pair:
                if qs is None:
                    args += [None] * 5 + [0, 0]
                    continue
                c, w, o = qs["copies"][i % len(qs["copies"])]
                args += [c.data_ptr(), w.data_ptr(), o.data_ptr(), qs["outs"][0].data_ptr(),
                         qs["outs"][1].data_ptr(), qs["Q"], qs["B"]]
            _kernels.check(lib.lvt_knn_tail_pair(*args, K1_K, stream), "lvt_knn_tail_pair")
    return launch


def k1_library_ms(sets) -> float:
    """The library yardstick for K1's selection half: torch.topk on the
    precomputed masked distances of each set (the port never calls it)."""
    import torch

    ms = 0.0
    for qs in sets:
        (c, w, o), Q, B = qs["inputs"], qs["Q"], qs["B"]
        cc, oo = c.reshape(Q, 27, 4, B), o.reshape(Q, 3, 27)
        d = sum((cc[:, :, i, :].float() + oo[:, i, :, None]) ** 2 for i in range(3))
        d = torch.where(cc[:, :, 3, :].int() == w[:, :, None], d, 1e10).reshape(Q, 27 * B)
        ms += cuda_ms(lambda d=d: torch.topk(d, K1_K, dim=1, largest=False))
    return ms


def kernel_alone(sets, blocks, par, frame, dev, sweep: bool = False):
    """Phase 8: each kernel's raw entry point alone, CUDA-graph timed at the
    main path's shapes (K1's two query sets `sets`, K2's two classes'
    `blocks`, K3 and K4 on `frame`: see `clahe_alone`), against its bound.
    Inputs rotate through enough copies that each launch finds them cold in
    L2. Returns {name: record}."""
    import torch

    from lvislam_tpu_torch.ops import _kernels

    lib = _kernels.library()
    rec = {}
    report = alone_reporter(rec)

    # ---- K1: the pair launch, each query set alone, and one query (the
    # launch's latency floor) ----
    k1 = [k1_set(*qs, dev) for qs in sets]
    one = k1_set(*(t[:1] for t in sets[0][:3]), sets[0][3], dev)
    for name, pair in (("K1_corner", (k1[0], None)), ("K1_surf", (None, k1[1])),
                       ("K1_pair", k1), ("K1_one_query", (one, None))):
        used = [qs for qs in pair if qs is not None]
        report(name, graph_us(k1_launch([pair])), sum(qs["bytes"] for qs in used),
               sum(qs["flops"] for qs in used),
               ",".join(f"Q={qs['Q']},B={qs['B']}" for qs in used))
    rec["K1_pair"]["library_ms"] = k1_library_ms(k1)

    # ---- K2: the pair launch, each class alone, and one point of each (the
    # latency floor); inputs stay in L2, as on the main path, where they are
    # reused across iterations ----
    n_blocks = sum((pts.shape[1] + 127) // 128 for pts, _ in blocks)
    rows = torch.empty((n_blocks, 28), device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty(43, device=dev)
    fixed = nbytes((par, out))

    def k2_launch(pair):  # (corner blocks, surf blocks), None for an empty class
        args = []
        for b in pair:
            args += [b[0].data_ptr(), b[1].data_ptr(), b[0].shape[1]] if b else [None, None, 0]
        return lambda i, stream: _kernels.check(lib.lvt_gn_partials_pair(
            *args, par.data_ptr(), rows.data_ptr(), ticket.data_ptr(), out.data_ptr(), stream),
            "lvt_gn_partials_pair")

    one_pt = [(p[:, :1].contiguous(), nb[:, :1].contiguous()) for p, nb in blocks]
    for name, pair in (("K2_corner", (blocks[0], None)), ("K2_surf", (None, blocks[1])),
                       ("K2_pair", blocks), ("K2_one_point_each", one_pt)):
        used = [(b, kind) for b, kind in zip(pair, ("corner", "surf")) if b is not None]
        report(name, graph_us(k2_launch(pair)), sum(nbytes(b) for b, _ in used) + fixed,
               sum(b[0].shape[1] * K2_FLOPS_PER_POINT[kind] for b, kind in used),
               ",".join(f"{kind}:N={b[0].shape[1]}" for b, kind in used))

    clahe_alone(frame, dev, report, sweep)
    return rec


BATCH_S = 4  # sequences of the batched kernels' phase-8 checks (phase 22c's count)


def batched_inputs(parity, S: int):
    """S sequences at the steady scan's shapes from the parity inputs: the
    maps' hashes stacked S times, seen from S poses, each sequence's
    queries moved by an offset of its own. Returns (K1's stacked query sets,
    each sequence's pair of sets, K2's stacked class blocks, each
    sequence's blocks, the stacked poses (S, 39))."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.ops import voxel_hash as vh

    corner, surf, h_c, h_s, q_c, q_s, x6 = parity
    dev = x6.device
    rng = np.random.default_rng(7)
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    shifts = [f32(rng.normal(0, 0.2, 3)) for _ in range(S)]
    x6s = [x6 + f32(rng.normal(0, 0.01, 6)) for _ in range(S)]
    qcs = torch.stack([q_c + d for d in shifts])
    qss = torch.stack([q_s - d for d in shifts])
    hcb, hsb = vh.stack([h_c] * S), vh.stack([h_s] * S)
    sets = [vh._query_set_batched(hcb, vh.query_gather_batched(hcb, qcs), qcs),
            vh._query_set_batched(hsb, vh.query_gather_batched(hsb, qss), qss)]
    singles = [(knn_set(h_c, qcs[i]), knn_set(h_s, qss[i])) for i in range(S)]
    blk = [(gn_blocks(h_c, corner, qcs[i], x6s[i]), gn_blocks(h_s, surf, qss[i], x6s[i]))
           for i in range(S)]
    blocks = [tuple(torch.stack([b[c][j] for b in blk]) for j in (0, 1)) for c in (0, 1)]
    return sets, singles, blocks, blk, torch.stack([gn_pose(x) for x in x6s])


def batched_alone(parity, dev, rec, S: int = BATCH_S):
    """Phase 8 for the batched forms of K1 and K2 (``knn_tail_batched``,
    ``gn_partials_pair_batched``) at S sequences of the steady scan's
    shapes: K1's result equal to its plain version and to S unbatched pair
    launches, K2's bit-equal to S unbatched pair launches and each
    sequence's within 2e-4 of its plain version's scale, n_res exact (the
    plain version sums in another order); then each raw
    entry point alone, CUDA-graph timed (K1's inputs cold in L2, K2's in L2
    as on the main path), beside S single launches, against its bound (S
    times the unbatched one). Adds the records to `rec` and returns the
    wrappers' error, ms and plain ms for the kernels line."""
    import torch

    from lvislam_tpu_torch.ops import _kernels
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import knn_tail as kt

    sets, singles, blocks, blk, pars = batched_inputs(parity, S)
    report = alone_reporter(rec)
    lib = _kernels.library()
    out = {}

    # ---- K1 ----
    got = kt.knn_tail_batched(sets, S, k=K1_K)
    plain = [kt.knn_tail_plain(*qs, k=K1_K) for qs in sets]
    one = [kt.knn_tail_pair(*pair, k=K1_K) for pair in singles]
    torch.cuda.synchronize()
    for c, name in enumerate(("corner", "surf")):
        d, p = got[c]
        if not (torch.equal(p.reshape(-1, K1_K), plain[c][1])
                and bits_equal((d.reshape(-1, K1_K),), (plain[c][0],))):
            raise AssertionError(f"K1 batched {name}: differs from the plain version")
        for i in range(S):
            if not (torch.equal(p[i], one[i][c][1]) and bits_equal((d[i],), (one[i][c][0],))):
                raise AssertionError(f"K1 batched {name}: sequence {i} differs from its "
                                     "unbatched launch")
    out["K1_batched"] = {
        "max_abs_err": max(float((got[c][0].reshape(-1, K1_K) - plain[c][0]).abs().max())
                           for c in (0, 1)),
        "ms": cuda_ms(lambda: kt.knn_tail_batched(sets, S, k=K1_K)),
        "plain_ms": cuda_ms(lambda: [kt.knn_tail_plain(*qs, k=K1_K) for qs in sets], 10, 2)}
    k1 = [k1_set(*qs, dev) for qs in sets]
    n_bytes, n_flops = sum(qs["bytes"] for qs in k1), sum(qs["flops"] for qs in k1)
    shape = f"S={S}," + ",".join(f"Q={qs['Q'] // S},B={qs['B']}" for qs in k1)
    r = report(f"K1_batched_S{S}", graph_us(k1_launch([k1])), n_bytes, n_flops, shape)
    qc, qs_ = k1[0]["Q"] // S, k1[1]["Q"] // S
    per = [(k1_rows(k1[0], i * qc, (i + 1) * qc), k1_rows(k1[1], i * qs_, (i + 1) * qs_))
           for i in range(S)]
    r1 = report(f"K1_pair_x{S}", graph_us(k1_launch(per)), n_bytes, n_flops, shape)
    r["library_ms"] = k1_library_ms(k1)
    log("batched_alone", kernel="K1", sequences=S, equal_plain=True, equal_unbatched=True,
        kernel_us=round(r["kernel_us"], 3), singles_us=round(r1["kernel_us"], 3),
        bound_us=round(r["bound_us"], 4), bound_share=round(r["bound_share"], 4),
        singles_over_batched=round(r1["kernel_us"] / r["kernel_us"], 3),
        ms=round(out["K1_batched"]["ms"], 4), plain_ms=round(out["K1_batched"]["plain_ms"], 4))

    # ---- K2 ----
    (c_pts, c_nbr), (s_pts, s_nbr) = blocks
    H, g, n = gnp.gn_partials_pair_batched(c_pts, c_nbr, s_pts, s_nbr, pars)
    ones = [gnp.gn_partials_pair(*b[0], *b[1], pars[i]) for i, b in enumerate(blk)]
    H0, g0, n0 = gnp.gn_partials_pair_batched_plain(c_pts, c_nbr, s_pts, s_nbr, pars)
    torch.cuda.synchronize()
    for i in range(S):
        if not bits_equal((H[i], g[i], n[i]), ones[i]):
            raise AssertionError(f"K2 batched: sequence {i} differs from its unbatched launch")
        # against the plain version as check_gn_pair holds the pair launch
        if int(n[i]) != int(n0[i]):
            raise AssertionError(f"K2 batched: sequence {i} n_res {int(n[i])} vs plain "
                                 f"{int(n0[i])}")
        torch.testing.assert_close(H[i], H0[i], rtol=2e-4,
                                   atol=2e-4 * max(float(H0[i].abs().max()), 1e-6))
        torch.testing.assert_close(g[i], g0[i], rtol=2e-4,
                                   atol=2e-4 * max(float(g0[i].abs().max()), 1e-6))
    out["K2_batched"] = {
        "max_abs_err": max(float((H - H0).abs().max()), float((g - g0).abs().max())),
        "ms": cuda_ms(lambda: gnp.gn_partials_pair_batched(c_pts, c_nbr, s_pts, s_nbr, pars)),
        "plain_ms": cuda_ms(lambda: gnp.gn_partials_pair_batched_plain(
            c_pts, c_nbr, s_pts, s_nbr, pars), 10, 2)}
    Nc, Ns = c_pts.shape[2], s_pts.shape[2]
    nb = (Nc + 127) // 128 + (Ns + 127) // 128
    rows, tickets = torch.empty((S, nb, 28), device=dev), torch.zeros(S, dtype=torch.int32,
                                                                       device=dev)
    res = torch.empty((S, 43), device=dev)
    rows1, ticket1, res1 = (torch.empty((nb, 28), device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            torch.empty(43, device=dev))

    def launch_batched(i, stream):
        _kernels.check(lib.lvt_gn_partials_pair_batched(
            c_pts.data_ptr(), c_nbr.data_ptr(), Nc, s_pts.data_ptr(), s_nbr.data_ptr(), Ns, S,
            pars.data_ptr(), rows.data_ptr(), tickets.data_ptr(), res.data_ptr(), stream),
            "lvt_gn_partials_pair_batched")

    def launch_singles(i, stream):
        for j in range(S):
            _kernels.check(lib.lvt_gn_partials_pair(
                c_pts[j].data_ptr(), c_nbr[j].data_ptr(), Nc, s_pts[j].data_ptr(),
                s_nbr[j].data_ptr(), Ns, pars[j].data_ptr(), rows1.data_ptr(),
                ticket1.data_ptr(), res1.data_ptr(), stream), "lvt_gn_partials_pair")

    n_bytes = nbytes((c_pts, c_nbr, s_pts, s_nbr, pars, res))
    n_flops = S * (Nc * K2_FLOPS_PER_POINT["corner"] + Ns * K2_FLOPS_PER_POINT["surf"])
    shape = f"S={S},corner:N={Nc},surf:N={Ns}"
    r = report(f"K2_batched_S{S}", graph_us(launch_batched), n_bytes, n_flops, shape)
    r1 = report(f"K2_pair_x{S}", graph_us(launch_singles), n_bytes, n_flops, shape)
    log("batched_alone", kernel="K2", sequences=S, equal_unbatched=True, within_plain=True,
        n_res=",".join(str(int(x)) for x in n.tolist()),
        plain_n_res=",".join(str(int(x)) for x in n0.tolist()),
        max_abs_err=out["K2_batched"]["max_abs_err"], H_scale=float(H0.abs().max()),
        kernel_us=round(r["kernel_us"], 3), singles_us=round(r1["kernel_us"], 3),
        bound_us=round(r["bound_us"], 4), bound_share=round(r["bound_share"], 4),
        singles_over_batched=round(r1["kernel_us"] / r["kernel_us"], 3),
        ms=round(out["K2_batched"]["ms"], 4), plain_ms=round(out["K2_batched"]["plain_ms"], 4))
    return out


def clahe_alone(frame, dev, report, sweep: bool, tag: str = ""):
    """Phase 8 for K3 and K4: the raw entry points on the rendered `frame`
    with the kernel and launch size the wrappers pick at its shape (cold in
    L2): the vector kernels at the rig's 576x1024, the aligned ones at the
    EuRoC camera's 480x752 (tw = 94), the general ones where W % 4 != 0.
    Then the library yardsticks (``torch.bincount`` for K3, ``F.grid_sample``
    for K4, each checked against the plain version). Without a `tag`, also
    on the smallest image the vector kernels take (8x8 in one tile: the
    launches' fixed cost), and K3 on a constant frame (every lane of a warp
    on one shared-memory counter). Every timed launch's result must equal
    the plain version's. With `sweep`, also K3 at other slab counts and K4
    at other rows and columns a block (0: the general kernels), on the
    rendered frame. Records are named K3<tag>, K4<tag> (a `tag` names a
    second shape of the main paths) and carry the path taken."""
    import torch

    from lvislam_tpu_torch.ops import _kernels, clahe
    from lvislam_tpu_torch.ops import image as imops

    lib = _kernels.library()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def k3(imgs, tiles, slabs):
        H, W = imgs[0].shape
        hist = torch.empty((tiles * tiles, 256), device=dev)
        us = graph_us(lambda i, s: _kernels.check(lib.lvt_clahe_hist(
            imgs[i % len(imgs)].data_ptr(), hist.data_ptr(), H, W, tiles, 256, slabs, s),
            "lvt_clahe_hist"))
        if not torch.equal(hist, clahe.tile_hist_plain(imgs[0], tiles)):
            raise AssertionError(f"K3 slabs={slabs} on {H}x{W}: counts differ")
        return us, nbytes((imgs[0], hist)), 3 * H * W

    def k4(imgs, tiles, rows, cols=0):
        H, W = imgs[0].shape
        cdf = imops.clip_cdf(clahe.tile_hist_plain(imgs[0], tiles), (H // tiles) * (W // tiles))
        res = torch.empty_like(imgs[0])
        us = graph_us(lambda i, s: _kernels.check(lib.lvt_clahe_apply(
            imgs[i % len(imgs)].data_ptr(), cdf.data_ptr(), res.data_ptr(), H, W, tiles, 256,
            rows, cols, s), "lvt_clahe_apply"))
        if not torch.equal(res, clahe.apply_cdf_plain(imgs[0], cdf, tiles)):
            raise AssertionError(f"K4 rows={rows} cols={cols} on {H}x{W}: pixels differ")
        return us, nbytes((imgs[0], cdf, res)), 12 * H * W

    img0 = torch.as_tensor(frame, device=dev)
    H, W = img0.shape
    th, tw = H // 8, W // 8
    imgs = [c[0] for c in cold_copies([img0], H * W * 4)]
    # the launch sizes the wrappers choose (0 slabs / 0 rows: the general
    # kernels), on every copy's address
    ptrs = [i.data_ptr() for i in imgs]
    (p3, slabs), = {(clahe.hist_path(H, W, 8, p), clahe.hist_launch(H, W, 8, p, n_sm))
                    for p in ptrs}
    (p4, rows, cols), = {(clahe.apply_path(H, W, 8, 256, p), *clahe.apply_launch(H, W, 8, 256, p))
                         for p in ptrs}
    r3 = report("K3" + tag, *k3(imgs, 8, slabs), f"{H}x{W},{p3},slabs={slabs}")
    r4 = report("K4" + tag, *k4(imgs, 8, rows, cols), f"{H}x{W},{p4},rows={rows},cols={cols}")
    r3["path"], r4["path"] = p3, p4
    # the library yardstick for K3: one torch.bincount over the pixels'
    # precomputed keys tile * 256 + bin (the port never calls it)
    tile = ((torch.arange(th * 8, device=dev) // th)[:, None] * 8
            + (torch.arange(tw * 8, device=dev) // tw)[None, :])
    keys = (tile * 256 + clahe._bins(img0[: th * 8, : tw * 8], 256)).reshape(-1)
    counts = torch.bincount(keys, minlength=64 * 256)
    if not torch.equal(counts.reshape(64, 256).float(), clahe.tile_hist_plain(img0, 8)):
        raise AssertionError(f"K3 on {H}x{W}: torch.bincount of the keys differs")
    r3["library_ms"] = cuda_ms(lambda: torch.bincount(keys, minlength=64 * 256))
    log("alone_library", kernel="K3" + tag, shape=f"{H}x{W}",
        library="torch.bincount(keys, minlength=64*256)", library_ms=round(r3["library_ms"], 4))
    # the library yardstick for K4: one F.grid_sample of the CDF volume at
    # precomputed coordinates (the lookup half; the port never calls it)
    cdf0 = imops.clip_cdf(clahe.tile_hist_plain(img0, 8), th * tw)
    vol, grid = grid_sample_inputs(img0, cdf0)
    err = float((grid_sample_apply(vol, grid) - clahe.apply_cdf_plain(img0, cdf0)).abs().max())
    if not err <= GRID_SAMPLE_TOL:
        raise AssertionError(f"K4 on {H}x{W}: F.grid_sample differs from the plain version "
                             f"by {err:.3e} (tolerance {GRID_SAMPLE_TOL})")
    r4["library_ms"] = cuda_ms(lambda: grid_sample_apply(vol, grid))
    log("alone_library", kernel="K4" + tag, shape=f"{H}x{W}",
        library="F.grid_sample(5-D, bilinear, border, align_corners=True)",
        library_ms=round(r4["library_ms"], 4), max_abs_err=err)
    if not tag:
        flat = [torch.full_like(img0, 0.5)] * 2
        tiny = [torch.rand((8, 8), device=dev)] * 2
        report("K3_constant", *k3(flat, 8, slabs), f"{H}x{W},slabs={slabs}")
        report("K3_floor", *k3(tiny, 1, clahe.hist_slabs(8, 1, n_sm)), "8x8,tiles=1")
        report("K4_floor", *k4(tiny, 1, clahe.APPLY_ROWS), "8x8,tiles=1")
    if not sweep:
        return
    for n in (0, 1, 2, 4, 8):
        report(f"K3_slabs{n}{tag}", *k3(imgs, 8, n), f"{H}x{W}")
    # the general K4 on the frame's first 64 rows (th = 8): its blocks do the
    # frame's work a block, 1/7.5 of them at 480x752
    report(f"K4_general_64rows{tag}", *k4([i[:64] for i in imgs], 8, 0), f"64x{W}")
    lattice = (0, 9, 12, 16, 18, 24, 32, 36) if tw % 8 == 0 else (0,)
    for r in lattice:
        report(f"K4_rows{r}{tag}", *k4(imgs, 8, r), f"{H}x{W}")
    for c in (16, 32, 64, 128):
        for r in (12, 16, 24, 32, 48):
            if c <= min(tw, 256):
                report(f"K4_rows{r}_cols{c}{tag}", *k4(imgs, 8, r, c), f"{H}x{W}")


def grid_sample_inputs(img, cdf, tiles: int = 8):
    """K4's library yardstick: the CDFs as a (1, 1, n_bins, tiles, tiles)
    volume and each pixel's normalised (tile column, tile row, bin)
    coordinates for one 5-D ``F.grid_sample`` (bilinear, border padding,
    ``align_corners=True``): ``((i + 0.5) / span - 0.5) / (tiles - 1) * 2 -
    1`` along each axis, ``b / (n_bins - 1) * 2 - 1`` along the bins. The
    border padding reproduces ``lerp_mat``'s clamps. Never called by the
    port."""
    import torch

    from lvislam_tpu_torch.ops import clahe

    H, W = img.shape
    n_bins = cdf.shape[1]
    vol = cdf.reshape(1, 1, tiles, tiles, n_bins).permute(0, 1, 4, 2, 3).contiguous()

    def axis(n, span):  # on the host: a true division, as clahe._lerp_taps
        return (((torch.arange(n, dtype=torch.float32) + 0.5) / span - 0.5) / (tiles - 1) * 2
                - 1).to(img.device)

    gx = axis(W, W // tiles)[None, :].expand(H, W)
    gy = axis(H, H // tiles)[:, None].expand(H, W)
    gz = clahe._bins(img, n_bins).float() / (n_bins - 1) * 2 - 1
    return vol, torch.stack([gx, gy, gz], -1)[None, None]


def grid_sample_apply(vol, grid):
    """The yardstick's one call: (H, W) f32 from `grid_sample_inputs`."""
    import torch.nn.functional as F

    return F.grid_sample(vol, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)[0, 0, 0]


def tracker_frame_jobs():
    """The MEI 1024x576 rig's frames of the LIO replay's world and
    trajectory at t = 0.1 + i/10, quantized to 8 bits and back as the
    system's frame packer does (`frame_step.py:72,139`), as (jobs, finish):
    finish gives (camera, world, trajectory, stamps, frames as (H, W)
    float32 arrays)."""
    import numpy as np

    from lvislam_tpu_torch.core.config import CameraIntrinsics
    from lvislam_tpu_torch.utils import synthetic as syn

    cam = CameraIntrinsics()
    ts = [0.1 + i / RATE for i in range(N_FRAMES)]

    def finish(u8s):
        frames = [u8.astype(np.float32) * np.float32(1.0 / 255.0) for u8 in u8s]
        return (cam, syn.default_world(seed=0), syn.figure8_trajectory(scale=3.0, period=40.0),
                ts, frames)

    return [("image", (0, 3.0, 40.0), t, 320, 240, 200.0, cam) for t in ts], finish


def tracker_frames():
    """The tracker phase's frames, rendered here (`tracker_frame_jobs`)."""
    return Prefetch(None, *tracker_frame_jobs()).get()


def depth_cloud(scans, traj):
    """The fused system's depth ring: 4096 evenly strided points of each
    of 12 lidar scans (dicts of `simulate_lidar_scan`), each point moved to
    the world frame at the ground-truth pose of its own measurement time.
    Returns (12*4096, 3) float32."""
    import numpy as np

    pts = []
    for s in scans:
        sel = np.linspace(0, s["xyz"].shape[0] - 1, CLOUD_PER_SCAN).astype(np.int64)
        p, R = traj.pose(s["stamp"] + s["time"][sel].astype(np.float64))
        pts.append(p + np.einsum("nij,nj->ni", R, s["xyz"][sel].astype(np.float64)))
    return np.concatenate(pts).astype(np.float32)


def body_pose(traj, t):
    """(trans (3,), quat [w, x, y, z] (4,)) float32 of the body in the world."""
    import numpy as np
    from scipy.spatial.transform import Rotation as Rsc

    p, R = traj.pose(np.array([t]))
    x, y, z, w = Rsc.from_matrix(R[0]).as_quat()
    return p[0].astype(np.float32), np.array([w, x, y, z], np.float32)


def epipolar_median_px(outs, ts, traj) -> float:
    """Median distance (virtual-focal pixels) of each consecutive-frame
    track's current normalized point from the epipolar line of its previous
    one under the ground-truth relative camera pose. `outs`: per frame
    dicts with `norm` (N, 2) and `valid` (N,); a valid slot is tracked from
    the previous frame in the same slot."""
    import numpy as np

    from lvislam_tpu_torch.utils.synthetic import R_CAM_BODY

    res = []
    for k in range(1, len(outs)):
        v = outs[k]["valid"]
        if not v.any():
            continue
        (p1,), (R1,) = traj.pose(np.array([ts[k - 1]]))
        (p2,), (R2,) = traj.pose(np.array([ts[k]]))
        Rc1, Rc2 = R1 @ R_CAM_BODY, R2 @ R_CAM_BODY
        R = Rc2.T @ Rc1  # X_c2 = R X_c1 + t
        t = Rc2.T @ (p1 - p2)
        E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R
        n1 = np.c_[outs[k - 1]["norm"][v].astype(np.float64), np.ones(v.sum())]
        n2 = np.c_[outs[k]["norm"][v].astype(np.float64), np.ones(v.sum())]
        line = n1 @ E.T
        res.append(np.abs(np.sum(n2 * line, axis=1)) / np.hypot(line[:, 0], line[:, 1]))
    return float(np.median(np.concatenate(res)) * FOCAL_VIRTUAL)


def depth_metrics(outs, depths, ts, world, traj):
    """(share of valid features given a depth, median |depth - raycast
    depth| in m) over frames; `depths` per frame (N,), -1 = none."""
    import numpy as np

    from lvislam_tpu_torch.utils import synthetic as syn

    n_valid, errs = 0, []
    for out, d, t in zip(outs, depths, ts):
        v = out["valid"]
        n_valid += int(v.sum())
        got = v & (d > 0)
        (p,), (R,) = traj.pose(np.array([t]))
        ray = np.c_[out["norm"][got].astype(np.float64), np.ones(got.sum())]
        scale = np.linalg.norm(ray, axis=1)
        dirs = (ray / scale[:, None]) @ (R @ syn.R_CAM_BODY).T
        rng = syn.raycast(world, np.broadcast_to(p, dirs.shape), dirs)
        errs.append(np.abs(d[got] - rng / scale))
    errs = np.concatenate(errs)
    return len(errs) / max(n_valid, 1), float(np.median(errs))


def rig_clahe_images(frame):
    """Phase 5's images as {name: (array, the kernels they must take)}: a
    rendered frame and a uniform-random image at the rig's 576x1024 (the
    vector kernels: tw = 128), the rendered frame cropped to the EuRoC
    camera's 480x752 and a uniform-random 480x752 image (the aligned
    kernels: tw = 94, W % 4 == 0), and the rendered frame cropped to
    571x1021 (the general kernels: W % 4 != 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return {"rendered": (frame, "vector"),
            "uniform": (rng.random(frame.shape, dtype=np.float32), "vector"),
            "rendered_480x752": (frame[:480, :752].copy(), "aligned"),
            "uniform_480x752": (rng.random((480, 752), dtype=np.float32), "aligned"),
            "cropped": (frame[:-5, :-3].copy(), "general")}


def check_clahe_kernels(images, dev):
    """K3 and K4 against their plain versions, bit for bit, on each of
    `images` ({name: (array, expected path)}), with CUDA-event timings of
    both. Returns {name: (K3 max abs err, K4 max abs err, times)}."""
    import torch

    from lvislam_tpu_torch.ops import clahe
    from lvislam_tpu_torch.ops import image as imops

    res = {}
    for name, (arr, want) in images.items():
        img = torch.as_tensor(arr, device=dev)
        H, W = img.shape
        h1 = clahe.tile_hist(img)
        h0 = clahe.tile_hist_plain(img)
        cdf = imops.clip_cdf(h0, (H // 8) * (W // 8))
        o1 = clahe.apply_cdf(img, cdf)
        o0 = clahe.apply_cdf_plain(img, cdf)
        torch.cuda.synchronize()
        paths = (clahe.hist_path(H, W, 8, img.data_ptr()),
                 clahe.apply_path(H, W, 8, 256, img.data_ptr(), cdf.data_ptr()))
        if paths != (want, want):
            raise AssertionError(f"K3/K4 {name}: {H}x{W} took the {paths} kernels, "
                                 f"not the {want} ones")
        if not torch.equal(h1, h0):
            raise AssertionError(f"K3 {name}: counts differ in "
                                 f"{int((h1 != h0).sum())} of {h1.numel()} bins")
        if int(h1.sum()) != (H // 8) * (W // 8) * 64:
            raise AssertionError(f"K3 {name}: {int(h1.sum())} pixels counted")
        if not torch.equal(o1, o0):
            raise AssertionError(f"K4 {name}: {int((o1 != o0).sum())} of {o1.numel()} pixels "
                                 f"differ (max {float((o1 - o0).abs().max()):.3e})")
        t = {"K3": cuda_ms(lambda: clahe.tile_hist(img)),
             "K3_plain": cuda_ms(lambda: clahe.tile_hist_plain(img)),
             "K4": cuda_ms(lambda: clahe.apply_cdf(img, cdf)),
             "K4_plain": cuda_ms(lambda: clahe.apply_cdf_plain(img, cdf))}
        log("parity", kernels="K3,K4", image=f"{name}:{H}x{W}", path=paths[0],
            K3_counts="identical", K4_pixels="identical",
            K3_sha256=sha256(h1.cpu().numpy()), K4_sha256=sha256(o1.cpu().numpy()),
            **{f"{k}_ms": round(v, 4) for k, v in t.items()})
        res[name] = (float((h1 - h0).abs().max()), float((o1 - o0).abs().max()), t)
    return res


def track_sequence(frames, ts, cam, dev):
    """One pass of the frames through FeatureTracker; returns (per-frame
    output dicts as numpy, per-frame seconds, host syncs per frame)."""
    import torch

    from lvislam_tpu_torch.core import hostsync
    from lvislam_tpu_torch.models.vio.feature_tracker import FeatureTracker

    tracker = FeatureTracker(cam=cam)
    state = tracker.init_state(dev)
    imgs = [torch.as_tensor(f, device=dev) for f in frames]
    torch.cuda.synchronize()
    outs, times, syncs = [], [], []
    for img, t in zip(imgs, ts):
        hostsync.reset()
        t0 = time.perf_counter()
        state, out = tracker(state, img, t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        syncs.append(hostsync.COUNT)
        outs.append({k: getattr(out, k).cpu().numpy()
                     for k in ("ids", "uv", "norm", "valid", "n_tracked")})
    return outs, times, syncs


def register_last_frames(outs, ts, cloud, traj, dev):
    """register_depth of the last DEPTH_FRAMES frames' features; returns
    (per-frame depths as numpy, ms per call)."""
    import torch

    from lvislam_tpu_torch.models.vio.feature_tracker import register_depth

    cw = torch.as_tensor(cloud, device=dev)
    cv = torch.ones(cw.shape[0], dtype=torch.bool, device=dev)
    depths, calls = [], []
    for out, t in zip(outs[-DEPTH_FRAMES:], ts[-DEPTH_FRAMES:]):
        p, q = (torch.as_tensor(a, device=dev) for a in body_pose(traj, t))
        norm = torch.as_tensor(out["norm"], device=dev)
        valid = torch.as_tensor(out["valid"], device=dev)
        calls.append(lambda norm=norm, valid=valid, p=p, q=q:
                     register_depth(norm, valid, cw, cv, p, q))
        depths.append(calls[-1]().cpu().numpy())
    return depths, cuda_ms(calls[-1], reps=20)


def profile_tracker(frames, ts, cam, dev, n_prof: int):
    """torch.profiler over `n_prof` steady tracker frames: device busy share
    and the largest device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lvislam_tpu_torch.models.vio.feature_tracker import FeatureTracker

    tracker = FeatureTracker(cam=cam)
    state = tracker.init_state(dev)
    imgs = [torch.as_tensor(f, device=dev) for f in frames]
    for img, t in zip(imgs[:2], ts[:2]):
        state, _ = tracker(state, img, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for img, t in zip(imgs[2:2 + n_prof], ts[2:2 + n_prof]):
            state, _ = tracker(state, img, t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    log("profile", tracker_frames=n_prof, wall_ms_per_frame=round(wall_us / n_prof / 1e3, 3),
        device_ms_per_frame=round(busy / n_prof / 1e3, 3),
        device_busy_share=round(busy / wall_us, 4),
        device_ops_per_frame=round(sum(r[2] for r in rows) / n_prof, 1))
    for key, us, cnt in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"  {us / n_prof / 1e3:8.4f} ms/frame  {cnt / n_prof:7.1f}/frame  {key[:90]}",
              flush=True)
    for kernel, name in (("K3", "clahe_hist"), ("K4", "clahe_apply")):
        us = sum(r[1] for r in rows if name in r[0])
        cnt = sum(r[2] for r in rows if name in r[0])
        log("profile", kernel=kernel, launches_per_frame=round(cnt / n_prof, 2),
            device_us_per_launch=round(us / max(cnt, 1), 2),
            device_ms_per_frame=round(us / n_prof / 1e3, 4))


# ---------------------------------------------------------------------------
# Phases 9-12: the IMU side and the sliding-window VIO estimator
# ---------------------------------------------------------------------------

def device_kernels(fn, n: int):
    """(device kernels a call, device ms a call, the five largest kernels) of
    `n` calls of ``fn(i)`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith(RANGES)]
    top = [(key[:70], round(us / n / 1e3, 4), round(cnt / n, 1))
           for key, us, cnt in sorted(rows, key=lambda r: -r[1])[:5]]
    return sum(r[2] for r in rows) / n, sum(r[1] for r in rows) / n / 1e3, top


def body_velocity(traj, t):
    """(3,) float64 velocity of the body in the world at time t, by central
    differences as the JAX package's tests take it."""
    import numpy as np

    return (traj.pose(np.array([t + 1e-4]))[0][0] - traj.pose(np.array([t - 1e-4]))[0][0]) / 2e-4


def imu_dead_reckoning(dev):
    """Phase 9a: `navstate_predict` (parallel prefix) over 60 s x 200 Hz of
    the figure-8's ideal IMU stream against the sequential recursion and the
    float64 numpy one. Gates: at the 64-sample length of the JAX package's
    parity test, its tolerances (quat 2e-6, vel and pos 2e-4); over all 12000
    samples DR_SEQ_TOL against the f32 sequential recursion (12000 dependent
    f32 steps) and DR_F64_TOL against float64."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.ops import preintegration as pre
    from lvislam_tpu_torch.utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=3.0, period=40.0)
    n = int(IMU_SECONDS * IMU_HZ)
    ts = (np.arange(n) + 1) / IMU_HZ
    gyrs, accs = traj.imu(ts)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    p0, q0 = body_pose(traj, ts[0])
    z3 = torch.zeros(3, device=dev)
    nav0 = pre.NavState(pos=f32(p0), quat=f32(q0), vel=f32(body_velocity(traj, ts[0])), ba=z3, bg=z3)
    dts = torch.full((n,), float(np.float32(1.0 / IMU_HZ)), device=dev)
    accs, gyrs = f32(accs), f32(gyrs)
    G = torch.tensor([0.0, 0.0, -syn.GRAVITY], device=dev)

    def diffs(a, b):
        return {k: float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
                for k, x, y in zip(("pos", "quat", "vel"), a, b)}

    def check(what, d, tol):
        over = {k: (d[k], tol[k]) for k in d if not d[k] <= tol[k]}
        if over:
            raise AssertionError(f"imu dead reckoning, {what}: beyond tolerance {over}")

    out = {}
    for m in (64, n):
        par = pre.navstate_predict(nav0, dts[:m], accs[:m], gyrs[:m], G)
        t0 = time.perf_counter()
        seq = pre.navstate_predict_seq(nav0, dts[:m], accs[:m], gyrs[:m], G)
        par, seq = [[x.cpu().numpy() for x in (s.pos, s.quat, s.vel)] for s in (par, seq)]
        seq_s = time.perf_counter() - t0
        f64 = pre.navstate_predict_np(p0, q0, nav0.vel.cpu().numpy(), np.zeros(3), np.zeros(3),
                                      dts[:m].cpu().numpy(), accs[:m].cpu().numpy(),
                                      gyrs[:m].cpu().numpy(), G.cpu().numpy())
        out[m] = (diffs(par, seq), diffs(par, f64), seq_s)
        check(f"{m} samples, parallel vs sequential", out[m][0],
              DR_TEST_TOL if m == 64 else DR_SEQ_TOL)
        check(f"{m} samples, parallel vs float64", out[m][1], DR_F64_TOL)
    ms = cuda_ms(lambda: pre.navstate_predict(nav0, dts, accs, gyrs, G), reps=20)
    fmt = lambda d: ",".join(f"{k}:{v:.3g}" for k, v in d.items())
    log("imu_predict", samples=n, seconds=IMU_SECONDS, vs_seq_64=fmt(out[64][0]),
        vs_seq=fmt(out[n][0]), vs_f64=fmt(out[n][1]), predict_ms=round(ms, 3),
        rtf=round(IMU_SECONDS / (ms / 1e3), 1), seq_ms=round(out[n][2] * 1e3, 1))
    return ms


def imu_rate_prediction(dev):
    """Phase 9c: `predict_imu_rate` over 5 s x 200 Hz from the true start
    state, as the JAX package's config-1 dead-reckoning test: under 0.5 m
    from the truth at the end, under 0.15 m over the first half."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.models.lio import imu_fusion as fus
    from lvislam_tpu_torch.utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=3.0, period=30.0)
    t, w, f = syn.simulate_imu_stream(traj, 0.0, 5.0, rate=200.0)
    params = fus.FusionParams(imuGravity=syn.GRAVITY)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    p0, q0 = body_pose(traj, 0.0)
    st = fus.fusion_init(params, device=dev)._replace(
        pos=f32(p0), quat=f32(q0), vel=f32(body_velocity(traj, 0.0)),
        sqrt_info=torch.eye(15, device=dev),
        initialized=torch.ones((), dtype=torch.bool, device=dev))
    dts = f32(np.diff(t, prepend=t[0]))
    t0 = time.perf_counter()
    ps, qs, vs = fus.predict_imu_rate(st, dts, f32(f), f32(w), params)
    ps = ps.cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    err = np.linalg.norm(ps - traj.pose(t)[0], axis=1)
    log("imu_rate", samples=len(t), end_err_m=round(float(err[-1]), 6),
        first_half_max_err_m=round(float(err[: len(err) // 2].max()), 6),
        ms=round(ms, 1), ms_per_sample=round(ms / len(t), 4))
    if not (np.isfinite(ps).all() and err[-1] < 0.5 and err[: len(err) // 2].max() < 0.15):
        raise AssertionError(f"imu rate prediction: {err[-1]:.3f} m from the truth at the end, "
                             f"{err[: len(err) // 2].max():.3f} m over the first half")


def fusion_inputs(traj6):
    """Phase 9b's inputs as numpy: the smoother's settings (the JAX bias
    test's), the first pose, and one correction a later scan: (dts, accs,
    gyrs) of the 200 Hz samples since the scan before, with the injected
    biases and noise (seed 0), padded to FUSION_SAMPLES, and the scan's
    pose (position, wxyz quaternion). `traj6` (N, 6) is the replay's [roll,
    pitch, yaw, x, y, z] a scan, scan i at i / RATE s."""
    import numpy as np
    from scipy.spatial.transform import Rotation as Rsc

    from lvislam_tpu_torch.utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=3.0, period=40.0)
    n = traj6.shape[0]
    t, w, f = syn.simulate_imu_stream(traj, 0.0, n / RATE, rate=200.0, gyro_bias=np.array(TRUE_BG),
                                      accel_bias=np.array(TRUE_BA), gyro_noise=1e-4,
                                      accel_noise=1e-3)
    params = dict(imuGravity=syn.GRAVITY, imuAccBiasN=2e-2, imuGyrBiasN=5e-3, priorBiasSigma=0.1)
    # x6's rotation is Rz(yaw) Ry(pitch) Rx(roll)
    quats = np.roll(Rsc.from_euler("ZYX", traj6[:, 2::-1].astype(np.float64)).as_quat(), 1, axis=1)
    pos = traj6[:, 3:6]
    M = FUSION_SAMPLES
    steps = []
    for k in range(1, n):
        sel = (t > (k - 1) / RATE) & (t <= k / RATE)
        m = int(sel.sum())
        if not 0 < m <= M:
            raise AssertionError(f"fusion: {m} IMU samples before scan {k}")
        dts, accs, gyrs = np.zeros(M, np.float32), np.zeros((M, 3), np.float32), np.zeros((M, 3), np.float32)
        dts[:m] = np.diff(t[sel], prepend=(k - 1) / RATE)
        accs[:m], gyrs[:m] = f[sel], w[sel]
        accs[m:], gyrs[m:] = accs[m - 1], gyrs[m - 1]
        steps.append((dts, accs, gyrs, np.asarray(pos[k], np.float32),
                      np.asarray(quats[k], np.float32)))
    return params, (np.asarray(pos[0], np.float32), np.asarray(quats[0], np.float32)), steps


def fusion_errors(bg_est, ba_est, p_end, p_last):
    """(gyro bias error / |true|, accelerometer bias error / |true|, fused
    position's distance to the last correction) of a smoother's end state."""
    import numpy as np

    bg, ba = np.array(TRUE_BG), np.array(TRUE_BA)
    return (float(np.linalg.norm(np.asarray(bg_est, np.float64) - bg) / np.linalg.norm(bg)),
            float(np.linalg.norm(np.asarray(ba_est, np.float64) - ba) / np.linalg.norm(ba)),
            float(np.linalg.norm(np.asarray(p_end, np.float64) - np.asarray(p_last, np.float64))))


def fusion_over_replay(traj6, dev):
    """Phase 9b: the two-state smoother over the LIO replay
    (`fusion_inputs`): `fusion_initialize` on the first pose, then one
    `fusion_correct` a scan with the replay's own pose as the correction.
    Gates: never failed; the gyro bias within 0.6 |true| of the injected
    one; the fused position within 0.1 m of the last correction pose. The
    JAX package's `fusion_correct` on the CPU over the same poses (when the
    replay is the one `utils/anchors.FUSION_REPLAY` names) is printed
    beside the card's errors."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.core import hostsync
    from lvislam_tpu_torch.models.lio import imu_fusion as fus
    from lvislam_tpu_torch.utils import anchors

    settings, first, arrays = fusion_inputs(traj6)
    params = fus.FusionParams(**settings)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    steps = [tuple(f32(a) for a in step) for step in arrays]
    bg = np.array(TRUE_BG)
    pos = traj6[:, 3:6]
    no = torch.zeros((), dtype=torch.bool, device=dev)
    st = fus.fusion_initialize(fus.fusion_init(params, device=dev), f32(first[0]), f32(first[1]),
                               params)
    failed = no
    torch.cuda.synchronize()
    times, syncs = [], []
    for step in steps:
        hostsync.reset()
        t0 = time.perf_counter()
        st = fus.fusion_correct(st, *step, no, params)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        syncs.append(hostsync.COUNT)
        failed = failed | st.failed
    bg_est, ba_est, p_end = (x.cpu().numpy().astype(np.float64) for x in (st.bg, st.ba, st.pos))
    bg_err, ba_err, pos_err = fusion_errors(bg_est, ba_est, p_end, pos[-1])
    jref = anchors.FUSION_REPLAY
    same_poses = sha256(traj6) == jref["poses_sha256"]
    # two corrections: under the profiler one takes seconds of host time
    last = steps[-2:]
    kernels, dev_ms, top = device_kernels(lambda i: fus.fusion_correct(st, *last[i], no, params), 2)
    steady = np.asarray(times[5:]) * 1e3
    log("fusion", corrections=len(steps), failed=bool(failed.item()),
        bg_est=",".join(f"{v:.4f}" for v in bg_est), true_bg=",".join(map(str, TRUE_BG)),
        bg_err_over_true=round(bg_err, 4), ba_est=",".join(f"{v:.4f}" for v in ba_est),
        ba_err_over_true=round(ba_err, 4), pos_err_m=round(pos_err, 4),
        jax_same_poses=same_poses, jax_bg_err_over_true=round(jref["bg_err_over_true"], 4),
        jax_ba_err_over_true=round(jref["ba_err_over_true"], 4),
        jax_pos_err_m=round(jref["pos_err_m"], 4), ms_per_correction=round(float(steady.mean()), 2),
        ms_p50=round(float(np.median(steady)), 2), first_ms=round(times[0] * 1e3, 1),
        host_syncs_per_correction=round(float(np.mean(syncs)), 2),
        device_kernels_per_correction=round(kernels, 1),
        device_ms_per_correction=round(dev_ms, 3),
        device_busy_share=round(dev_ms / float(steady.mean()), 4))
    for key, ms, cnt in top:
        print(f"  {ms:8.4f} ms/correction  {cnt:7.1f}/correction  {key}", flush=True)
    if bool(failed.item()) or not all(np.isfinite(x).all() for x in (bg_est, ba_est, p_end)):
        raise AssertionError("fusion: the smoother failed or went non-finite")
    if not bg_err < 0.6 or not bg_est[0] > 0.005:
        raise AssertionError(f"fusion: gyro bias {bg_est} against the injected {bg} "
                             f"(|error| / |true| = {bg_err:.3f}, limit 0.6)")
    if not pos_err < 0.1:
        raise AssertionError(f"fusion: fused position {pos_err:.3f} m from the last correction")
    return float(steady.mean())


def vio_config(full: bool):
    """The `VioRunnerConfig` of the fixture's camera file (320x240 pinhole,
    f = 200, 64 features, 128 slots, 4 iterations, td fixed) or, with `full`,
    the runner's own configuration for the public EuRoC cam0 size (752x480,
    150 features at 30 px, CLAHE on, 256 slots, 6 iterations) with the
    distortion taken out. Both at 10 Hz with the renderer's camera mounting
    (camera z forward = body x)."""
    import numpy as np
    from scipy.spatial.transform import Rotation as Rsc

    from lvislam_tpu_torch.core.config import CameraIntrinsics
    from lvislam_tpu_torch.models.vio import estimator as est
    from lvislam_tpu_torch.models.vio import feature_manager as fm
    from lvislam_tpu_torch.models.vio import feature_tracker as ft
    from lvislam_tpu_torch.models.vio.pipeline import VioRunnerConfig
    from lvislam_tpu_torch.ops import ba
    from lvislam_tpu_torch.utils.synthetic import R_CAM_BODY

    qic = tuple(float(v) for v in np.roll(Rsc.from_matrix(R_CAM_BODY).as_quat(), 1))
    zero = dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    if full:
        cam = CameraIntrinsics(model_type="PINHOLE", image_width=752, image_height=480,
                               gamma1=458.654, gamma2=458.654, u0=367.215, v0=248.375, **zero)
        return VioRunnerConfig(
            camera=cam, tracker=ft.TrackerParams(max_cnt=150, min_dist=30, equalize=True),
            caps=fm.VioCaps(window=10, max_features=256, imu_buf=64, frame_features=150),
            params=est.VioParams(g_norm=9.81),
            ba=ba.BAConfig(window=10, max_features=256, iterations=6),
            image_height=480, image_width=752, freq=10.0, qic=qic)
    cam = CameraIntrinsics(model_type="PINHOLE", image_width=320, image_height=240,
                           gamma1=200.0, gamma2=200.0, u0=160.0, v0=120.0, **zero)
    return VioRunnerConfig(
        camera=cam, tracker=ft.TrackerParams(max_cnt=64, min_dist=16, equalize=False),
        caps=fm.VioCaps(window=10, max_features=128, imu_buf=64, frame_features=64),
        params=est.VioParams(g_norm=9.81, acc_n=3.9939570888238808e-01,
                             gyr_n=1.5636343949698187e-01, acc_w=6.4356659353532566e-03,
                             gyr_w=3.5640318696367613e-03),
        ba=ba.BAConfig(window=10, max_features=128, iterations=4, estimate_td=False),
        image_height=240, image_width=320, freq=10.0, qic=qic)


def vio_input_jobs(full: bool):
    """The 5 s camera + IMU stream of the VIO phases as (jobs, finish)
    (`synthetic.vio_stream_jobs`): world seed 0, the figure-8 at scale 1.5
    and period 8 s (enough accelerometer excitation to observe scale), 200
    Hz IMU, 10 Hz frames quantized to 8 bits. finish gives (trajectory,
    events, gyro, acc, frames)."""
    from lvislam_tpu_torch.utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=1.5, period=8.0)
    cam = vio_config(True).camera if full else None
    head, jobs = syn.vio_stream_jobs(VIO_SECONDS, cam=cam, world_seed=0, scale=1.5, period=8.0)
    return jobs, lambda imgs: (traj, *syn.vio_stream_join(head, imgs))


def vio_inputs(full: bool):
    """The VIO phases' stream, rendered here (`vio_input_jobs`)."""
    return Prefetch(None, *vio_input_jobs(full)).get()


def vio_sampler(seed: int):
    """The VIO phases' RANSAC draws for entry `seed` of VIO_SEEDS. 0: None,
    the port's default draws. s > 0: the port's Gumbel top-k with its uniform
    numbers from a host generator seeded with s on every call, so the card
    draws what a CPU run of the port draws (a generator on the card gives
    another stream)."""
    import torch

    from lvislam_tpu_torch.ops import ransac

    if seed == 0:
        return None
    return lambda weights, n_hyp, k: ransac.sample_indices(
        weights, n_hyp, k, torch.Generator().manual_seed(seed))


def vio_summary(trajectory, traj):
    """(ATE in m after rigid alignment, positions, quaternions) of a
    runner's `trajectory` list against the ground truth `traj`."""
    import numpy as np

    from lvislam_tpu_torch.utils.metrics import ate_rmse

    ts = np.array([x[0] for x in trajectory])
    pos = np.stack([x[1] for x in trajectory])
    quat = np.stack([x[2] for x in trajectory])
    ate = ate_rmse(pos.astype(np.float64), traj.pose(ts)[0], align=True)
    return float(ate), pos, quat


def run_vio(cfg, stream, dev, sampler, split: bool = False):
    """The stream through `VioRunner`, one frame at a time. Returns a dict:
    the `runner`, `init_at` (index of the first frame with an initialized
    output), and per processed frame `syncs` (host reads), `walls` (seconds,
    device drained) and `ba_iterations`. With `split`, also `stages`: the
    seconds of the runner's `track`, `propagate` and `estimate` a frame, each
    wrapped here to drain the device before and after."""
    import torch

    from lvislam_tpu_torch.core import hostsync
    from lvislam_tpu_torch.models.vio.pipeline import VioRunner

    _, events, gyro, acc, frames = stream
    runner = VioRunner(cfg, device=dev, sampler=sampler)
    stages = {"track": [], "propagate": [], "estimate": []}

    def timed(fn, into):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return call

    if split:
        for name, into in stages.items():
            setattr(runner, name, timed(getattr(runner, name), into))
    torch.cuda.synchronize()
    run = {"runner": runner, "init_at": None, "syncs": [], "walls": [], "ba_iterations": [],
           "stages": stages}
    for t, kind, i in events:
        if kind == "imu":
            runner.feed_imu(t, gyro[i], acc[i])
            continue
        hostsync.reset()
        t0 = time.perf_counter()
        out = runner.feed_image(t, frames[i])
        torch.cuda.synchronize()
        run["walls"].append(time.perf_counter() - t0)
        run["syncs"].append(hostsync.COUNT)
        run["ba_iterations"].append(out["ba_iterations"])
        if run["init_at"] is None and runner.trajectory:
            run["init_at"] = i
    return run


def vio_status(live: bool, failure_count: int, frame_count: int, ate) -> str:
    """A VIO run against the gates: "ok" (`live`: initialized at the end
    with a trajectory; no failure, a full window, ATE under
    VIO_ATE_LIMIT_M), "misinitialized" (live and unflagged, but the ATE is
    over: a wrong bootstrap that the failure checks did not catch),
    "rebooted" (a failure was counted) or "never_initialized"."""
    if failure_count:
        return "rebooted"
    if not live:
        return "never_initialized"
    return "ok" if ate < VIO_ATE_LIMIT_M and frame_count >= 10 else "misinitialized"


def vio_outcome(run, traj) -> dict:
    """One `run_vio` result in numbers, with its `vio_status`."""
    import numpy as np

    from lvislam_tpu_torch.core.hostsync import host_bool, host_int

    runner = run["runner"]
    out = {"initialized_at_frame": run["init_at"], "trajectory_points": len(runner.trajectory),
           "failure_count": host_int(runner.vio.failure_count),
           "frame_count": host_int(runner.vio.frame_count), "ate_m": None}
    if runner.frame_count != out["frame_count"]:
        raise AssertionError(f"vio: the runner's frame count {runner.frame_count} is not the "
                             f"state's {out['frame_count']}")
    live = host_bool(runner.vio.initialized) and len(runner.trajectory) >= 3
    if live:
        out["ate_m"], pos, quat = vio_summary(runner.trajectory, traj)
        if not (np.isfinite(pos).all() and np.isfinite(quat).all()):
            raise AssertionError("vio: non-finite trajectory")
    out["status"] = vio_status(live, out["failure_count"], out["frame_count"], out["ate_m"])
    return out


def check_vio(name, cfg, stream, ref, dev, n_prof: int = 0):
    """Phases 10 and 11: the stream through `VioRunner` once for every seed
    of VIO_SEEDS (the RANSAC draws), each held to the gates by `vio_outcome`.
    `ref` holds the JAX CPU run's outcome on the same stream for each of its
    keys (`utils/anchors.py`). The phase fails unless as many runs are "ok"
    as of JAX's over the same seeds, less VIO_OK_SLACK, and one at least.
    The first "ok" run is the one whose frame times, host reads and K3/K4
    launches are reported, and it is run again: the second trajectory must
    be bit-identical. Returns that run's (K3, K4) launch counts and every
    run's outcome by seed."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.ops import clahe

    traj = stream[0]
    runs = {}
    for seed in VIO_SEEDS:
        clahe.HIST_LAUNCHES = 0
        clahe.APPLY_LAUNCHES = 0
        run = run_vio(cfg, stream, dev, vio_sampler(seed), split=True)
        run["launched"] = (clahe.HIST_LAUNCHES, clahe.APPLY_LAUNCHES)
        run["outcome"] = vio_outcome(run, traj)
        runs[seed] = run
        jax = ref[seed]
        log(f"{name}_seed", seed=seed, **{k: (round(v, 5) if k == "ate_m" and v else v)
                                          for k, v in run["outcome"].items()},
            jax_status=jax["status"], jax_initialized_at_frame=jax["initialized_at_frame"],
            jax_ate_m=jax["ate_m"])
    n_frames = len(stream[4])
    want = n_frames if cfg.tracker.equalize else 0
    for seed, run in runs.items():
        if run["launched"] != (want, want):
            raise AssertionError(f"{name} seed {seed}: K3/K4 launched {run['launched']} times in "
                                 f"{n_frames} frames (equalize={cfg.tracker.equalize})")
    ok = [seed for seed, run in runs.items() if run["outcome"]["status"] == "ok"]
    jax_ok = [seed for seed in VIO_SEEDS if ref[seed]["status"] == "ok"]
    need = max(1, len(jax_ok) - VIO_OK_SLACK)
    status = {seed: run["outcome"]["status"] for seed, run in runs.items()}
    if len(ok) < need:
        raise AssertionError(f"{name}: {len(ok)} of {len(VIO_SEEDS)} runs met the gates "
                             f"({status}); the JAX CPU runs: {len(jax_ok)}; needed {need}")

    seed = ok[0]
    run, res = runs[seed], runs[seed]["outcome"]
    init_at = run["init_at"]
    _, pos, quat = vio_summary(run["runner"].trajectory, traj)
    # steady state: the frames after the one that initialized
    s0 = init_at + 1
    tr, imu, img = (float(np.mean(run["stages"][k][s0:])) * 1e3
                    for k in ("track", "propagate", "estimate"))
    H, W = cfg.image_height, cfg.image_width
    probe = torch.empty((H, W), device=dev)
    log(name, frames=n_frames, image=f"{H}x{W}", features=cfg.tracker.max_cnt,
        window=cfg.caps.window, slots=cfg.caps.max_features, ba_iterations_max=cfg.ba.iterations,
        seeds=",".join(map(str, VIO_SEEDS)), ok_seeds=",".join(map(str, ok)),
        jax_ok_seeds=",".join(map(str, jax_ok)), needed_ok=need,
        misinitialized_seeds=",".join(str(k) for k, v in status.items() if v == "misinitialized"),
        reported_seed=seed, initialized_at_frame=init_at,
        trajectory_points=len(pos), failure_count=res["failure_count"],
        frame_count=res["frame_count"], ate_m=round(res["ate_m"], 5),
        steady_ms_per_frame=round(tr + imu + img, 2), tracker_ms=round(tr, 2),
        process_imu_ms=round(imu, 2), process_image_ms=round(img, 2),
        first_solved_frame_ms=round(run["walls"][init_at] * 1e3, 1),
        ba_iterations_per_frame=round(float(np.mean(run["ba_iterations"][s0:])), 2),
        host_syncs_per_frame=round(float(np.mean(run["syncs"][s0:])), 2),
        host_syncs_max=max(run["syncs"]),
        launches_K3=run["launched"][0], launches_K4=run["launched"][1],
        K3_path=clahe.hist_path(H, W, 8, probe.data_ptr()),
        K4_path=clahe.apply_path(H, W, 8, 256, probe.data_ptr()),
        trajectory_sha256=sha256(pos, quat))
    again = run_vio(cfg, stream, dev, vio_sampler(seed))
    _, pos2, quat2 = vio_summary(again["runner"].trajectory, traj)
    if again["init_at"] != init_at or not (np.array_equal(pos, pos2)
                                           and np.array_equal(quat, quat2)):
        raise AssertionError(f"{name} determinism: the second run of seed {seed} differs")
    log(f"{name}_determinism", seed=seed, identical=True,
        steady_ms_per_frame_unsplit=round(float(np.mean(again["walls"][s0:])) * 1e3, 2))
    if n_prof:
        # two frames at most: under the profiler a frame's ~40k small
        # launches through torch.func take tens of seconds of host time
        profile_vio(name, cfg, stream, dev, vio_sampler(seed), min(n_prof, 2, n_frames - s0),
                    float(np.mean(again["walls"][s0:])) * 1e3)
    return run["launched"], {k: r["outcome"] for k, r in runs.items()}


def profile_vio(name, cfg, stream, dev, sampler, n_prof: int, steady_ms: float):
    """torch.profiler over the last `n_prof` frames of the stream through a
    fresh `VioRunner`: device kernels and device ms a frame, and that device
    time's share of `steady_ms`, the steady frame of this script run's
    unprofiled repeat (under the profiler the host is several times slower,
    the kernels are not)."""
    from lvislam_tpu_torch.models.vio.pipeline import VioRunner

    _, events, gyro, acc, frames = stream
    runner = VioRunner(cfg, device=dev, sampler=sampler)
    first = len(frames) - n_prof
    tail = []

    def feed(ev):
        for t, kind, i in ev:
            if kind == "imu":
                runner.feed_imu(t, gyro[i], acc[i])
            else:
                runner.feed_image(t, frames[i])

    cut = next(k for k, e in enumerate(events) if e[1] == "img" and e[2] == first)
    # each profiled call: one frame and the IMU samples after it
    for e in events[cut:]:
        if e[1] == "img":
            tail.append([e])
        else:
            tail[-1].append(e)
    feed(events[:cut])
    kernels, dev_ms, top = device_kernels(lambda i: feed(tail[i]), n_prof)
    log("profile", path=name, frames=n_prof, device_kernels_per_frame=round(kernels, 1),
        device_ms_per_frame=round(dev_ms, 3), unprofiled_steady_ms_per_frame=round(steady_ms, 2),
        device_busy_share=round(dev_ms / steady_ms, 4))
    for key, ms, cnt in top:
        print(f"  {ms:8.4f} ms/frame  {cnt:7.1f}/frame  {key}", flush=True)


def ba_alone(dev):
    """Phase 12: `ba.solve` with each of the three solvers on the exact
    synthetic window at the reference shape (window 10, 150 features, empty
    prior), the states perturbed (positions + 3 cm, velocities + 5 cm/s) so
    that every solver has work to do. Gates, as the JAX package's solver
    parity test: "cholesky" and "schur" end within 2e-3 m of "qr" in every
    position and at no more than 1.2 x its cost. Timed with CUDA events at a
    fixed `iterations` steps (ftol = 0: no early stop, no host read)."""
    import dataclasses

    import torch

    from lvislam_tpu_torch.core import hostsync
    from lvislam_tpu_torch.ops import ba
    from lvislam_tpu_torch.utils import synthetic as syn

    caps, cfg, ws, pints, table, G = syn.consistent_window(BA_WINDOW, BA_FEATURES, seed=0,
                                                           device=dev)
    ws_p = ws._replace(Ps=ws.Ps + 0.03, Vs=ws.Vs + 0.05)
    fv = torch.ones(cfg.window + 1, dtype=torch.bool, device=dev)
    prior = ba.empty_prior(cfg, device=dev)
    td0 = torch.zeros((), device=dev)

    def solve(c):
        return ba.solve(ws_p, table.inv_depth, table.obs, table.vel, table.obs_valid,
                        table.start_frame, table.ids >= 0, table.lidar_flag, pints, fv, prior,
                        G, td0, c)

    res, ms = {}, {}
    for solver in ("qr", "cholesky", "schur"):
        c = dataclasses.replace(cfg, solver=solver)
        hostsync.reset()
        res[solver] = solve(c)
        syncs = hostsync.COUNT
        fixed = dataclasses.replace(c, ftol=0.0)
        ms[solver] = cuda_ms(lambda: solve(fixed), reps=5, warm=1)
        log("ba", solver=solver, window=cfg.window, features=cfg.max_features,
            rows=cfg.d_state + cfg.window * 15 + cfg.max_features * (cfg.window + 1) * 2,
            columns=cfg.d_total, iterations=res[solver].iterations,
            final_cost=float(res[solver].final_cost), host_syncs=syncs,
            ms_per_solve=round(ms[solver], 2), fixed_iterations=cfg.iterations,
            ms_per_iteration=round(ms[solver] / cfg.iterations, 2),
            reference_budget=BA_REFERENCE_BUDGET)
    qr = res["qr"]
    for solver in ("cholesky", "schur"):
        dP = float((res[solver].ws.Ps - qr.ws.Ps).abs().max())
        ratio = float(res[solver].final_cost / qr.final_cost)
        log("ba_parity", solver=solver, max_dP_vs_qr_m=round(dP, 6), cost_over_qr=round(ratio, 4))
        if not (dP <= 2e-3 and ratio < 1.2):
            raise AssertionError(f"ba: {solver} ends {dP:.2e} m from qr at {ratio:.3f} x its cost")
    if not all(bool(torch.isfinite(r.ws.Ps).all() & torch.isfinite(r.final_cost)) for r in res.values()):
        raise AssertionError("ba: a solver went non-finite")
    return ms


# ---------------------------------------------------------------------------
# Phases 13-15: visual loop detection and the fused LVI system (config 5)
# ---------------------------------------------------------------------------

def loop_scene_phase(stream, dev):
    """Phase 13: `add_and_detect` alone over the revisit scene, the port's
    default draws, against the JAX CPU run's accepted pairs."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.models.loop import loop_detector as ld
    from lvislam_tpu_torch.ops import brief, gftt
    from lvislam_tpu_torch.utils import anchors
    from lvislam_tpu_torch.utils import synthetic as syn

    world, traj, times, imgs = stream
    caps = ld.LoopCaps(**anchors.LOOP_SCENE["caps"])
    db = ld.db_init(caps, device=dev)
    found, verified, ms = [], [], []
    z2, zb = torch.zeros((1, 2), device=dev), torch.zeros(1, dtype=torch.bool, device=dev)
    for i, (t, img) in enumerate(zip(times, imgs)):
        im = torch.as_tensor(img, device=dev)
        kp, ok = gftt.detect(im, z2, zb, max_pts=caps.window_points, cell=20, border=16)
        kp_np = kp.cpu().numpy()
        pts, hit = syn.ray_points(world, traj, t, kp_np)
        norm = torch.as_tensor(((kp_np - [160, 120]) / 200.0).astype(np.float32), device=dev)
        valid = ok & torch.as_tensor(hit, device=dev)
        pts = torch.as_tensor(pts, device=dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        db, cand = ld.add_and_detect(db, im, kp, norm, pts, valid, t, caps, focal=200.0)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        if int(cand.old_index) >= 0:
            verified.append([i, int(cand.old_index), int(cand.n_matches)])
        if bool(cand.found):
            found.append([i, int(cand.old_index)])
    ref = anchors.LOOP_SCENE
    gate = caps.min_loop_matches
    card_v, jax_v = {v[0]: v for v in verified}, {v[0]: v for v in ref["verified"]}
    # where the card verified another old slot than JAX: the card's top five
    # eligible (slot, BoW score) of that frame, recomputed as add_and_detect
    # scored them (the database holds every frame's bag, slot = frame here)
    other_slot = {}
    for i in sorted(card_v):
        if i in jax_v and card_v[i][1] != jax_v[i][1]:
            sc = brief.bow_scores(db.bags[i], db.bags).cpu().numpy()[: i - caps.recent_exclude]
            top = np.argsort(-sc, kind="stable")[:5]
            other_slot[i] = [[int(k), float(sc[k])] for k in top]
    exact = found == ref["pairs"]
    log("loop_db", frames=len(times), pairs=found, jax_pairs=ref["pairs"], exact=exact,
        verified=verified, jax_verified=ref["verified"], inserts=int(db.count),
        other_slot_scores=other_slot,
        ms_per_add_and_detect=round(float(np.mean(ms[1:])), 3),
        ms_max=round(float(np.max(ms)), 3))
    if int(db.count) != len(times):
        raise AssertionError(f"loop_db: {int(db.count)} inserts for {len(times)} frames")
    if ref["pairs"] and not found:
        raise AssertionError(f"loop_db: no loop accepted, JAX accepts {ref['pairs']}")
    if any(i - o < caps.recent_exclude for i, o in found):
        raise AssertionError(f"loop_db: a pair closer than recent_exclude: {found}")
    if not exact:
        # tolerated only where rounding moved one PnP verification across
        # min_loop_matches: one pair differs, both runs verified that frame
        # against the same old slot, and the card's inliers are within 2 of
        # the gate
        diff = ([p for p in found if p not in ref["pairs"]]
                + [p for p in ref["pairs"] if p not in found])
        i, o = diff[0]
        card_n, jax_n = card_v.get(i, [i, -1, -1]), jax_v.get(i, [i, -1, -1])
        print(f"  loop_db: pairs differ from JAX at {diff}; frame {i} inliers: card "
              f"{card_n[2]} (slot {card_n[1]}), JAX {jax_n[2]} (slot {jax_n[1]}), "
              f"gate > {gate}", flush=True)
        if not (len(diff) == 1 and card_n[1] == jax_n[1] == o and abs(card_n[2] - gate) <= 2):
            raise AssertionError(f"loop_db: pairs {found} against JAX {ref['pairs']}")
    return float(np.mean(ms[1:]))


def watch_system(sys_):
    """Instrument a fused system's two handlers: per processed scan and
    frame, the host syncs and the launches of K1-K4 inside it; per frame,
    the lidar seed's availability and the summary. Returns the record."""
    from lvislam_tpu_torch.core import hostsync
    from lvislam_tpu_torch.ops import clahe
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import knn_tail as kt

    rec = {"scans": [], "frames": []}
    counters = lambda: (hostsync.COUNT, kt.LAUNCHES, gnp.LAUNCHES, clahe.HIST_LAUNCHES,
                        clahe.APPLY_LAUNCHES)
    on_lidar, on_image, lidar_seed = sys_._on_lidar, sys_._on_image, sys_._lidar_seed
    seeded = [False]

    # an event the batched replay staged (`replay_batch` > 1) is not a
    # processed one here: `watch_replay` records the replay's events
    staged = lambda: sys_.replay_counts["staged"]

    def lidar(stamp, scan):
        n0, c0, s0 = len(sys_.trajectory), counters(), staged()
        on_lidar(stamp, scan)
        if len(sys_.trajectory) > n0 and staged() == s0:
            rec["scans"].append((stamp, *[b - a for a, b in zip(c0, counters())]))

    def image(stamp, msg):
        n0, c0, s0 = sys_.vio_frames, counters(), staged()
        seeded[0] = False
        on_image(stamp, msg)
        if sys_.vio_frames > n0 and staged() == s0:
            s = sys_.frame_summary
            rec["frames"].append((stamp, *[b - a for a, b in zip(c0, counters())],
                                  seeded[0], bool(s[17] > 0.5), bool(s[18] > 0.5),
                                  sys_.vio_frames))

    def seed(stamp):
        out = lidar_seed(stamp)
        seeded[0] = out is not None
        return out

    sys_._on_lidar, sys_._on_image, sys_._lidar_seed = lidar, image, seed
    return rec


def lvi_summary(sys_, rec, traj, t_lo: float):
    """Numbers of a fused run: ATE of `trajectory` against the truth, the
    init frame and path, and per processed scan / frame (stamps >= t_lo)
    the handlers' ms (`MetricsLogger`), host syncs and kernel launches."""
    import numpy as np

    from lvislam_tpu_torch.utils.metrics import ate_rmse

    est = np.stack([x6[3:6] for _, x6 in sys_.trajectory]).astype(np.float64)
    gt = np.stack([traj.pose(np.array([t]))[0][0] for t, _ in sys_.trajectory])
    init = next(((f[9], "lidar_seed" if f[6] else "visual")
                 for f in rec["frames"] if f[7]), (None, None))
    scans = [r for r in rec["scans"] if r[0] >= t_lo]
    frames = [r for r in rec["frames"] if r[0] >= t_lo]
    done = {t for t, *_ in sys_.trajectory}
    lid = [r["dt"] * 1e3 for r in sys_.metrics.records
           if r["stage"] == "lidar" and r["stamp"] >= t_lo and r["stamp"] in done]
    img = [r["dt"] * 1e3 for r in sys_.metrics.records
           if r["stage"] == "image" and r["stamp"] >= t_lo]
    per = lambda rows, k: float(np.mean([r[k] for r in rows])) if rows else 0.0
    return dict(
        ate_m=float(ate_rmse(est, gt, align=True)), init_frame=init[0], init_path=init[1],
        trajectory_points=len(sys_.trajectory), vio_frames=sys_.vio_frames,
        failure_count=int(sys_.vio.failure_count), keyframes=int(sys_.lio.state.kf_count),
        vins_odom=sys_.vins_odom is not None, scans_timed=len(scans), frames_timed=len(frames),
        lidar_ms_mean=float(np.mean(lid)), lidar_ms_p50=float(np.median(lid)),
        image_ms_mean=float(np.mean(img)), image_ms_p50=float(np.median(img)),
        syncs_per_scan=per(scans, 1), syncs_per_frame=per(frames, 1),
        K1_per_scan=per(scans, 2), K2_per_scan=per(scans, 3),
        K3_per_frame=per(frames, 4), K4_per_frame=per(frames, 5),
        launches={k: sum(r[i] for r in rec["scans"] + rec["frames"])
                  for k, i in (("K1", 2), ("K2", 3), ("K3", 4), ("K4", 5))},
        sha=sha256(np.stack([np.r_[t, x6] for t, x6 in sys_.trajectory])),
    )


def run_lvi(cfg, data, dev, warm_s: float, end_s: float):
    """A fused system through its entry points: `feed_*` of [0, warm_s),
    `run`, then [warm_s, end_s) timed. Returns (system, record, wall s)."""
    import torch

    from lvislam_tpu_torch.models.pipeline import LviSystem
    from lvislam_tpu_torch.utils import synthetic as syn

    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
    sys_ = LviSystem(cfg, device=dev)
    rec = watch_system(sys_)
    syn.feed_lvi(sys_, data, 0.0, warm_s)
    sys_.run()
    syn.feed_lvi(sys_, data, warm_s, end_s)
    sync()
    t0 = time.perf_counter()
    sys_.run()
    sync()
    return sys_, rec, time.perf_counter() - t0


def fmt_run(r: dict) -> dict:
    return {k: (round(v, 5) if isinstance(v, float) else v) for k, v in r.items()
            if k != "launches"}


def lvi_parity_phase(stream, dev):
    """Phase 14: config 5 at the parity scale through `LviSystem`, 2 s warm
    then 10 s timed; gated against the JAX package's clean-CPU readings of
    the same sequence; the first 4 s repeated bit for bit."""
    import numpy as np

    from lvislam_tpu_torch.utils import anchors
    from lvislam_tpu_torch.utils import synthetic as syn

    ref = anchors.LVI_PARITY
    cfg = lvi_parity_config()
    cfg_cpu = anchors.config_sha256(lvi_parity_config(kernels=False))
    data = stream.get()
    seq = syn.lvi_sequence_sha256(data)
    if cfg_cpu != ref["config_sha256"] or seq != ref["stream_sha256"]:
        raise AssertionError(f"lvi_parity: config {cfg_cpu} / stream {seq} are not the "
                             f"anchor's ({ref['config_sha256']} / {ref['stream_sha256']})")
    with open(os.path.join(ROOT, "bench_anchors.json")) as f:
        batched = float(json.load(f)["lvi_ate_cpu_ref_m"])  # the batched replay's
    traj = syn.figure8_trajectory(scale=3.0, period=30.0)
    sys_, rec, wall = run_lvi(cfg, data, dev, LVI_WARM_S, LVI_PARITY_S)
    r = lvi_summary(sys_, rec, traj, LVI_WARM_S)
    limit = LVI_BAND * max(ref["ate_m"], batched)
    log("lvi_parity", seconds=LVI_PARITY_S, timed_s=LVI_PARITY_S - LVI_WARM_S,
        rtf=round((LVI_PARITY_S - LVI_WARM_S) / wall, 4), wall_s=round(wall, 2),
        ate_limit_m=round(limit, 5), jax_interactive_ate_m=round(ref["ate_m"], 5),
        jax_batched_ate_m=batched, jax_init_frame=ref["init_frame"],
        jax_init_path=ref["init_path"], config_sha256=anchors.config_sha256(cfg),
        cpu_config_sha256=cfg_cpu, stream_sha256=seq, stream_wait_s=round(stream.waited_s, 1),
        **fmt_run(r))
    if not (r["init_frame"] and r["failure_count"] == 0 and r["vins_odom"]):
        raise AssertionError(f"lvi_parity: VIO init frame {r['init_frame']}, "
                             f"failures {r['failure_count']}, vins_odom {r['vins_odom']}")
    if not r["ate_m"] <= limit:
        raise AssertionError(f"lvi_parity: ATE {r['ate_m']:.4f} m over {limit:.4f} m")
    # determinism: the first 4 s again, with the debug hooks on (`debug_dir`):
    # they read the device back at their stride and must change nothing
    dbg = os.path.join(ROOT, ".chip_tmp", "lvi_debug")
    shutil.rmtree(dbg, ignore_errors=True)
    sys2, _, _ = run_lvi(dataclasses.replace(cfg, debug_dir=dbg, debug_every=DEBUG_EVERY),
                         data, dev, LVI_WARM_S, LVI_REPEAT_S)
    rows = lambda s: np.stack([np.r_[t, x6] for t, x6 in s.trajectory if t < LVI_REPEAT_S])
    a, b = rows(sys_), rows(sys2)
    files = sorted(os.listdir(dbg)) if os.path.isdir(dbg) else []
    want = sorted(f"{kind}_{n:05d}.ppm" for kind in ("feature", "depth")
                  for n in range(DEBUG_EVERY, sys2.vio_frames + 1, DEBUG_EVERY))
    log("lvi_parity_determinism", seconds=LVI_REPEAT_S, rows=len(b), sha256=sha256(b),
        identical=bool(np.array_equal(a, b)), debug_every=DEBUG_EVERY,
        debug_files=len(files), debug_files_expected=len(want))
    if not np.array_equal(a, b):
        raise AssertionError("lvi_parity determinism: the first 4 s differ (debug hooks on)")
    if files != want or not all(os.path.getsize(os.path.join(dbg, f)) > 0 for f in files):
        raise AssertionError(f"lvi_parity debug: wrote {files}, expected {want}")
    return dict(r, rtf=(LVI_PARITY_S - LVI_WARM_S) / wall)


def lvi_full_phase(data, dev):
    """Phase 15: config 5 at the shipped scale over `data` (the stream's
    `lvi_sequence` dict), 2 s warm then 5 s timed. Returns the first run's
    summary, the gated run's, and the first run's trajectory rows [t, x6]."""
    import numpy as np

    from lvislam_tpu_torch.utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=3.0, period=30.0)
    runs = {}
    for rebuild in (None, 1):
        cfg = lvi_full_config(rebuild)
        sys_, rec, wall = run_lvi(cfg, data, dev, LVI_WARM_S, LVI_FULL_S)
        r = lvi_summary(sys_, rec, traj, LVI_WARM_S)
        after = [f for f in rec["frames"] if f[7]]
        kf_after = sum(1 for f in after if f[8])
        r.update(rtf=(LVI_FULL_S - LVI_WARM_S) / wall, wall_s=wall,
                 loop_inserts=int(sys_.loop_db.count), keyframes_after_init=kf_after,
                 loops=int(sys_.lio.state.n_loops),
                 map_rebuild_every=cfg.lio.params.mapRebuildEvery)
        runs[rebuild] = (r, rec, np.stack([np.r_[t, x6] for t, x6 in sys_.trajectory]))
        log("lvi_full" if rebuild is None else "lvi_full_rebuild1", seconds=LVI_FULL_S,
            timed_s=LVI_FULL_S - LVI_WARM_S, ate_limit_m=LVI_FULL_ATE_M, **fmt_run(r))
        if r["ate_m"] <= LVI_FULL_ATE_M:
            break
        print(f"  lvi_full: ATE {r['ate_m']:.4f} m over {LVI_FULL_ATE_M} m with "
              f"mapRebuildEvery={r['map_rebuild_every']}: rerun with mapRebuildEvery=1",
              flush=True)
    r, rec, _ = runs[rebuild]
    if not (r["init_frame"] and r["failure_count"] == 0):
        raise AssertionError(f"lvi_full: VIO init frame {r['init_frame']}, "
                             f"failures {r['failure_count']}")
    if r["loop_inserts"] != r["keyframes_after_init"]:
        raise AssertionError(f"lvi_full: {r['loop_inserts']} loop-database inserts for "
                             f"{r['keyframes_after_init']} keyframes after initialization")
    if min(r["launches"].values()) <= 0:
        raise AssertionError(f"lvi_full: a kernel was never launched {r['launches']}")
    if not r["ate_m"] <= LVI_FULL_ATE_M:
        raise AssertionError(f"lvi_full: ATE {r['ate_m']:.4f} m over {LVI_FULL_ATE_M} m")
    return runs[None][0], r, runs[None][2]


def lvi_loop_phase(stream, dev):
    """`--loop`: the 38 s revisit arm (`bench.py:770-887`) on the parity
    configuration with 192 keyframes and 16 loop slots, on the interactive
    path: at least one loop factor accepted; the loop count and the
    keyframe ATE."""
    import numpy as np

    from lvislam_tpu_torch.utils import synthetic as syn
    from lvislam_tpu_torch.utils.metrics import ate_rmse

    cfg = lvi_loop_config(replay_batch=1)
    data = stream.get()
    traj = syn.figure8_trajectory(scale=3.0, period=30.0)
    sys_, rec, wall = run_lvi(cfg, data, dev, LVI_WARM_S, LVI_LOOP_S)
    r = lvi_summary(sys_, rec, traj, LVI_WARM_S)
    st = sys_.lio.state
    n_kf = int(st.kf_count)
    kf_t = st.kf_time[:n_kf].cpu().numpy()
    kf_p = st.kf_trans[:n_kf].cpu().numpy().astype(np.float64)
    gt_kf = np.stack([traj.pose(np.array([t]))[0][0] for t in kf_t])
    loops = int(st.n_loops)
    log("lvi_loop", seconds=LVI_LOOP_S, loops=loops,
        kf_ate_m=round(float(ate_rmse(kf_p, gt_kf, align=True)), 5),
        rtf=round((LVI_LOOP_S - LVI_WARM_S) / wall, 4), **fmt_run(r))
    if loops < 1:
        raise AssertionError("lvi_loop: no loop factor accepted")


class ShiftedTrajectory:
    """A trajectory read at t + dt: a bag replay feeds stamps relative to
    the bag's first message, the ground truth runs on absolute time."""

    def __init__(self, traj, dt: float):
        self.traj, self.dt = traj, dt

    def pose(self, t):
        import numpy as np

        return self.traj.pose(np.asarray(t, np.float64) + self.dt)


def replay_bag(argv, dev):
    """The port's `run_rosbag_lvi.main(argv + --device)` in-process, its
    system watched (`watch_system`), every kernel count set to 0 just
    before and read just after. Returns (main's result, record, launches,
    wall s of the whole call)."""
    import torch

    from lvislam_tpu_torch.ops import clahe
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import knn_tail as kt
    from lvislam_tpu_torch.scripts import run_rosbag_lvi as script

    rec = {}
    plain = script.LviSystem

    class Watched(plain):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec.update(watch_system(self))

    script.LviSystem = Watched
    try:
        kt.LAUNCHES = gnp.LAUNCHES = clahe.HIST_LAUNCHES = clahe.APPLY_LAUNCHES = 0
        t0 = time.perf_counter()
        r = script.main([*argv, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": kt.LAUNCHES, "K2": gnp.LAUNCHES, "K3": clahe.HIST_LAUNCHES,
                    "K4": clahe.APPLY_LAUNCHES}
    finally:
        script.LviSystem = plain
    return r, rec, launches, wall


def check_tum(path: str, name: str):
    """The TUM file's rows: at least 10, finite, stamps strictly increasing,
    a motion span in (0.05, 50) m (`tests/test_rosbag_e2e.py:40-47`)."""
    import numpy as np

    tum = np.loadtxt(path)
    span = float(np.linalg.norm(tum[:, 1:4].max(0) - tum[:, 1:4].min(0))) if tum.ndim == 2 else 0.0
    if not (tum.ndim == 2 and tum.shape[1] == 8 and tum.shape[0] >= 10
            and np.isfinite(tum).all() and (np.diff(tum[:, 0]) > 0).all() and 0.05 < span < 50.0):
        raise AssertionError(f"{name}: bad TUM trajectory {tum.shape}, span {span:.3f} m")
    return tum


def bag_fixture_phase(dev):
    """Phase 16: the committed fixture bag (`tests/data/fixture_mid360.db3`,
    JPEG frames) through the port's `run_rosbag_lvi` with the fixture YAMLs,
    gated against the JAX script's CPU run (`utils/anchors.ROSBAG_FIXTURE`)."""
    import hashlib

    import numpy as np

    from lvislam_tpu_torch.utils import anchors
    from lvislam_tpu_torch.utils import synthetic as syn
    from lvislam_tpu_torch.utils.bag import Rosbag2Reader

    ref = anchors.ROSBAG_FIXTURE
    data = os.path.join(ROOT, "tests", "data")
    bag = os.path.join(data, "fixture_mid360.db3")
    out = os.path.join(ROOT, ".chip_tmp", "bag_fixture")
    os.makedirs(out, exist_ok=True)
    # the decoded frames, hashed against PIL's (the port's JPEG decoder)
    t0 = time.perf_counter()
    h, n_img = hashlib.sha256(), 0
    for _, _, kind, msg in Rosbag2Reader(bag):
        if kind == "image":
            h.update(np.ascontiguousarray(msg["image"]).tobytes())
            n_img += 1
    decode_s = time.perf_counter() - t0
    frames_sha = h.hexdigest()[:16]
    tum_path, map_dir = os.path.join(out, "trajectory.tum"), os.path.join(out, "map")
    r, rec, launches, wall = replay_bag(
        [bag, "--lidar-yaml", os.path.join(data, "fixture_lidar.yaml"),
         "--camera-yaml", os.path.join(data, "fixture_camera.yaml"),
         "--out", tum_path, "--save-map", map_dir], dev)
    sys_ = r["system"]
    cfg_sha = anchors.config_sha256(sys_.cfg)
    traj = ShiftedTrajectory(syn.figure8_trajectory(scale=3.0, period=30.0), r["t0"])
    s = lvi_summary(sys_, rec, traj, 0.0)
    # as phase 14: the band over the worst of the JAX package's readings of
    # the bag, its own run and its runs with one input a float32 step off
    jax_worst = max(ref["ate_m"], *ref["ate_one_ulp_m"].values())
    limit = LVI_BAND * jax_worst
    log("bag_fixture", messages=r["messages"], skipped=r["skipped"], frames_sha256=frames_sha,
        jax_frames_sha256=ref["frames_sha256"], decode_s=round(decode_s, 2),
        decode_ms_per_frame=round(1e3 * decode_s / max(n_img, 1), 2), config_sha256=cfg_sha,
        span_s=round(r["span_s"], 3), rtf=round(r["span_s"] / r["wall_s"], 4),
        run_wall_s=round(r["wall_s"], 2), script_wall_s=round(wall, 2),
        ate_limit_m=round(limit, 5), jax_ate_m=round(ref["ate_m"], 5),
        jax_one_ulp_ate_m={k: round(v, 5) for k, v in ref["ate_one_ulp_m"].items()},
        within_band_of_unperturbed_jax=s["ate_m"] <= LVI_BAND * ref["ate_m"],
        jax_trajectory_points=ref["trajectory_points"], jax_keyframes=ref["keyframes"],
        map=r["map"], kernels=launches, **fmt_run(s))
    want = {"imu": 1200, "livox": 59, "image": 59}
    if r["messages"] != want or r["skipped"] != 0 or ref["messages"] != want:
        raise AssertionError(f"bag_fixture: messages {r['messages']} skipped {r['skipped']}, "
                             f"want {want} and 0")
    if frames_sha != ref["frames_sha256"]:
        raise AssertionError(f"bag_fixture: decoded frames {frames_sha} are not PIL's "
                             f"{ref['frames_sha256']}")
    if anchors.config_fields(sys_.cfg) != ref["config"] or cfg_sha != ref["config_sha256"]:
        raise AssertionError(f"bag_fixture: the script's configuration {cfg_sha} is not the "
                             f"JAX script's {ref['config_sha256']}")
    check_tum(tum_path, "bag_fixture")
    if not any(f.endswith(".pcd") for f in os.listdir(map_dir)):
        raise AssertionError(f"bag_fixture: no .pcd in {map_dir}")
    if any(launches.values()):
        raise AssertionError(f"bag_fixture: kernels launched on a path that runs none {launches}")
    if not s["ate_m"] <= limit:
        raise AssertionError(f"bag_fixture: ATE {s['ate_m']:.4f} m over {limit:.4f} m")
    return s, launches


# the fields of `configs/params_camera.yaml` that phase 15's configuration
# (`lvi_full_config`, `bench.py:668-767`) sets otherwise, as phase 17
# writes them beside its bag; `configs/params_lidar.yaml` goes unchanged
# (phase 15 keeps its YAML fields at their defaults)
def shipped_camera_overrides() -> dict:
    from lvislam_tpu_torch.models.vio import estimator as est
    from lvislam_tpu_torch.utils import synthetic as syn

    p = est.VioParams(g_norm=syn.GRAVITY)
    return {
        "extrinsicRotation": [float(v) for v in syn.R_CAM_BODY.reshape(-1)],  # the render's rig
        "extrinsicTranslation": [0.0, 0.0, 0.0],
        "acc_n": p.acc_n, "gyr_n": p.gyr_n, "acc_w": p.acc_w, "gyr_w": p.gyr_w,
        "g_norm": p.g_norm,
        "max_num_iterations": 4,  # BAConfig(iterations=4)
        "estimate_td": 0,
    }


def write_shipped_yamls(out: str):
    """`configs/params_{lidar,camera}.yaml` copied beside the bag, the camera
    file's `shipped_camera_overrides` fields replaced in its text; checked by
    loading both and comparing with the shipped configuration."""
    import dataclasses
    import re

    from lvislam_tpu_torch.core.config import load_yaml

    src = os.path.join(ROOT, "configs")
    with open(os.path.join(src, "params_lidar.yaml")) as f:
        lidar = f.read()
    with open(os.path.join(src, "params_camera.yaml")) as f:
        camera = f.read()
    over = shipped_camera_overrides()
    for key, v in over.items():
        if isinstance(v, list):
            pat = rf"(^{key}: !!opencv-matrix\n(?:  .*\n)*?  data: )\[[^\]]*\]"
            text = "[" + ", ".join(repr(x) for x in v) + "]"
        else:
            pat, text = rf"(^{key}: ).*$", repr(v)
        camera, n = re.subn(pat, lambda m: m.group(1) + text, camera, flags=re.M)
        if n != 1:
            raise AssertionError(f"bag_shipped: {key} not found once in params_camera.yaml")
    paths = os.path.join(out, "params_lidar.yaml"), os.path.join(out, "params_camera.yaml")
    for path, text in zip(paths, (lidar, camera)):
        with open(path, "w") as f:
            f.write(text)
    got, base = load_yaml(*paths), load_yaml(*[os.path.join(src, os.path.basename(p)) for p in paths])
    want = dataclasses.replace(base.vins, **{
        k: (tuple(v) if isinstance(v, list) else type(getattr(base.vins, k))(v))
        for k, v in over.items()})
    if got.lidar != base.lidar or got.vins != want:
        raise AssertionError("bag_shipped: the written YAMLs do not load as intended")
    return paths


def write_shipped_bag(data: dict, path: str) -> int:
    """Phase 15's stream (`lvi_sequence`) as a rosbag2 file: 200 Hz
    sensor_msgs/Imu with the stream's attitude, livox CustomMsg scans (the
    finite points, as the sensor publishes them) and raw mono8
    sensor_msgs/Image frames, each stamped to the nanosecond."""
    import numpy as np
    from scipy.spatial.transform import Rotation as Rsc

    from lvislam_tpu_torch.utils import bag_writer as bw

    ns = lambda t: int(round(t * 1e9))
    msgs = []
    quats = Rsc.from_euler("ZYX", np.asarray(data["rpys"], np.float64)[:, ::-1]).as_quat()
    for i, t in enumerate(data["imu_ts"]):
        q = quats[i]
        msgs.append((ns(t), 0, bw.encode_imu(t, data["w"][i], data["f"][i],
                                             (q[3], q[0], q[1], q[2]))))
    for t, sc in data["scans"]:
        ok = np.isfinite(sc["xyz"]).all(-1)
        msgs.append((ns(t), 1, bw.encode_livox(t, sc["xyz"][ok], sc["time"][ok],
                                               sc["ring"][ok], sc["intensity"][ok])))
    for t, im in data["imgs"]:
        msgs.append((ns(t), 2, bw.encode_image(t, im)))
    return bw.write_bag(path, [("/livox/imu", "sensor_msgs/msg/Imu"),
                               ("/livox/lidar", "livox_ros_driver2/msg/CustomMsg"),
                               ("/camera/image", "sensor_msgs/msg/Image")], msgs)


def write_shipped_inputs(data: dict):
    """Phase 17's inputs in `.chip_tmp/bag_shipped/`: the YAML pair and the
    bag of phase 15's stream. Returns (bag, lidar YAML, camera YAML,
    messages written, seconds taken)."""
    out = os.path.join(ROOT, ".chip_tmp", "bag_shipped")
    os.makedirs(out, exist_ok=True)
    bag = os.path.join(out, "shipped.db3")
    t0 = time.perf_counter()
    lidar_yaml, camera_yaml = write_shipped_yamls(out)
    n_msgs = write_shipped_bag(data, bag)
    return bag, lidar_yaml, camera_yaml, n_msgs, time.perf_counter() - t0


def bag_shipped_phase(inputs, dev):
    """Phase 17: the bag of `write_shipped_inputs` (phase 15's stream at the
    shipped scale, the shipped YAMLs with the rig's fields replaced),
    replayed by the port's `run_rosbag_lvi`. Gates: K3 and K4 once a frame,
    VIO initialized with no failure, ATE <= LVI_FULL_ATE_M. Returns the
    summary, the launches and the trajectory rows [t + t0, x6]."""
    import numpy as np

    from lvislam_tpu_torch.utils import anchors
    from lvislam_tpu_torch.utils import synthetic as syn

    bag, lidar_yaml, camera_yaml, n_msgs, write_s = inputs
    tum_path = os.path.join(os.path.dirname(bag), "trajectory.tum")
    r, rec, launches, wall = replay_bag(
        [bag, "--lidar-yaml", lidar_yaml, "--camera-yaml", camera_yaml, "--out", tum_path], dev)
    sys_ = r["system"]
    traj = ShiftedTrajectory(syn.figure8_trajectory(scale=3.0, period=30.0), r["t0"])
    s = lvi_summary(sys_, rec, traj, 0.0)
    frames = rec["frames"]
    once = all(f[4] == 1 and f[5] == 1 for f in frames)
    log("bag_shipped", seconds=LVI_FULL_S, messages=r["messages"], skipped=r["skipped"],
        bag_mb=round(os.path.getsize(bag) / 1e6, 1), bag_messages=n_msgs,
        write_s=round(write_s, 2), span_s=round(r["span_s"], 3),
        rtf=round(r["span_s"] / r["wall_s"], 4), run_wall_s=round(r["wall_s"], 2),
        script_wall_s=round(wall, 2), config_sha256=anchors.config_sha256(sys_.cfg),
        phase15_config_sha256=anchors.config_sha256(lvi_full_config()),
        ate_limit_m=LVI_FULL_ATE_M, kernels=launches, **fmt_run(s))
    check_tum(tum_path, "bag_shipped")
    if not (frames and once and launches["K3"] == launches["K4"] == len(frames) == sys_.vio_frames):
        raise AssertionError(f"bag_shipped: K3/K4 launched {launches['K3']}/{launches['K4']} "
                             f"times over {sys_.vio_frames} frames (once a frame: {once})")
    if r["skipped"] or not (s["init_frame"] and s["failure_count"] == 0):
        raise AssertionError(f"bag_shipped: skipped {r['skipped']}, VIO init frame "
                             f"{s['init_frame']}, failures {s['failure_count']}")
    if not s["ate_m"] <= LVI_FULL_ATE_M:
        raise AssertionError(f"bag_shipped: ATE {s['ate_m']:.4f} m over {LVI_FULL_ATE_M} m")
    rows = np.stack([np.r_[t + r["t0"], np.asarray(x6, np.float64)] for t, x6 in sys_.trajectory])
    return s, launches, rows


def compare_with_full(bag_rows, full_rows):
    """Phase 17's poses against phase 15's on the same stream, at the stamps
    both processed (phase 15's rows hold float32 stamps)."""
    import numpy as np

    near = np.abs(bag_rows[None, :, 0] - full_rows[:, :1].astype(np.float64))
    pairs = [(i, int(np.argmin(near[i]))) for i in range(len(full_rows)) if near[i].min() < 1e-4]
    d = (np.array([np.linalg.norm(bag_rows[j, 4:7] - full_rows[i, 4:7]) for i, j in pairs])
         if pairs else np.full(1, np.inf))
    log("bag_shipped_vs_full", poses=len(pairs), max_m=round(float(d.max()), 5),
        rms_m=round(float(np.sqrt(np.mean(d ** 2))), 5))


def phase_worker_init(t_start: float):
    """A phase pool process: deterministic as the main process; its `t=`
    counts from `t_start` (the main process's start; `perf_counter` is the
    machine's monotonic clock)."""
    import torch

    global T_START
    T_START = t_start
    import lvislam_tpu_torch  # noqa: F401  (full-f32 math settings)

    torch.use_deterministic_algorithms(True)


# ---------------------------------------------------------------------------
# Phases 18-21: the host tools, the calibration tool and the two entry
# points of slice 6b
# ---------------------------------------------------------------------------

EUROC_T0_NS = 1_403_636_580_000_000_000  # MH_01-era epoch (tests/test_euroc_e2e.py)
CALIB_ROWS, CALIB_COLS, CALIB_SQ = 5, 7, 0.03  # tests/test_chessboard_calibration_e2e.py
CALIB_F, CALIB_CX, CALIB_CY = 250.0, 160.0, 120.0
MEI_TRUTH = [1.0, 900.0, 890.0, 500.0, 300.0, -0.03, 0.01, 5e-4, -2e-4]  # tests/test_calibration.py
MEI_PERTURB = [0.1, 0.05, -0.05, 0.01, -0.01, -1.0, -1.0, -1.0, -1.0]
SYNTHETIC_S = 6.0  # run_synthetic_lvi's default duration
DEBUG_EVERY = 5  # phase 14's repeat drops its overlays every 5 frames


def drain(dev):
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def native_blob(n=100, step=20, seed=3):
    """`tests/test_native.py:make_blob`: n packed points (x, y, z,
    intensity f32, ring u16; one NaN row), no time field."""
    import numpy as np

    rng = np.random.default_rng(seed)
    raw = np.zeros((n, step), np.uint8)
    xyz = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    xyz[5] = np.nan
    inten = rng.uniform(0, 255, n).astype(np.float32)
    ring = rng.integers(0, 4, n).astype(np.uint16)
    raw[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    raw[:, 12:16] = inten[:, None].view(np.uint8)
    raw[:, 16:18] = ring[:, None].view(np.uint8)
    return raw.tobytes()


def native_calls(scan):
    """The native library's three entry points on `tests/test_native.py`'s
    blob and on one shipped-scale scan (packed as a PointCloud2 with a
    time field)."""
    import numpy as np

    n = len(scan["xyz"])
    raw = np.zeros((n, 22), np.uint8)
    raw[:, 0:12] = np.asarray(scan["xyz"], np.float32).view(np.uint8).reshape(n, 12)
    raw[:, 12:16] = np.asarray(scan["intensity"], np.float32)[:, None].view(np.uint8)
    raw[:, 16:18] = np.asarray(scan["ring"], np.uint16)[:, None].view(np.uint8)
    raw[:, 18:22] = np.asarray(scan["time"], np.float32)[:, None].view(np.uint8)
    xyz = np.asarray(scan["xyz"], np.float32)
    valid = np.ones(n, np.uint8)
    stamps = np.arange(2000) * 0.005 + 0.0012
    gyro = np.random.default_rng(2).normal(size=(2000, 3)).astype(np.float32)
    return [
        ("decode_pointcloud2", (native_blob(), 100, 20,
                                dict(x=0, y=4, z=8, intensity=12, ring=16, time=-1)),
         dict(capacity=128)),
        ("decode_pointcloud2", (raw.tobytes(), n, 22,
                                dict(x=0, y=4, z=8, intensity=12, ring=16, time=18)),
         dict(capacity=n)),
        ("imu_window", (stamps, gyro, gyro * 3 + 9.8, 1.0, 1.1, 64), {}),
        ("voxel_prefilter", (xyz, valid, 0.4, n), {}),
        ("voxel_prefilter", (xyz, valid, 0.2, 4096), {}),
    ]


def host_tools_phase(frame, scans, dev):
    """Phase 18: the native library built and equal to its NumPy path; a
    752x480 frame through the PNG writer and decoder byte for byte; the
    exact LOAM selection on the card equal to the port's CPU run; one
    `device_timer` reading."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.models.lio import frontend as tfe
    from lvislam_tpu_torch.models.lio import pipeline as tpl
    from lvislam_tpu_torch.ops import loam
    from lvislam_tpu_torch.utils import native, png
    from lvislam_tpu_torch.utils.profiling import device_timer

    scan = scans[5][0]  # one of the bench's 4 x 6000 scans
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("host_tools: the native library did not build (NumPy path)")
    build_s = time.perf_counter() - t0
    timings = {}
    for name, args, kw in native_calls(scan):
        fn = getattr(native, name)
        t1 = time.perf_counter()
        mine = fn(*args, **kw)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t1
        lib, tried = native._lib, native._tried
        native._lib, native._tried = None, True
        try:
            plain = fn(*args, **kw)
        finally:
            native._lib, native._tried = lib, tried
        for a, b in zip(mine, plain):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"host_tools: native {name} differs from its NumPy path")
    # PNG: phase 11's first frame as 8 bits, written and read back
    u8 = np.round(np.asarray(frame) * 255.0).astype(np.uint8)
    t1 = time.perf_counter()
    blob = png.encode(u8)
    enc_ms = (time.perf_counter() - t1) * 1e3
    dec = []
    for _ in range(3):
        t1 = time.perf_counter()
        back = png.decode_gray(blob)
        dec.append((time.perf_counter() - t1) * 1e3)
    if not np.array_equal(back, u8):
        raise AssertionError("host_tools: the PNG round trip changed the frame")
    # the exact greedy LOAM selection: the card against the port's CPU run
    cfg = full_width_config()
    P = cfg.point_capacity
    buf = torch.from_numpy(tpl.pack_scan(cfg, *scans[5]))
    pts = buf[: P * 6].reshape(6, P)
    M = cfg.imu_capacity
    imu = buf[P * 6: P * 6 + M * 8].view(torch.float32).reshape(M, 4)
    misc = buf[P * 6 + M * 8:].view(torch.float32)
    rv = pts[4].to(torch.int32)
    proj = tfe.project_scan(pts[0:3].float().T * tpl.POS_SCALE, pts[3].float(), rv % 256,
                            pts[5].float() * tpl.TIME_SCALE, rv >= 256, imu[:, 0], imu[:, 1:4],
                            misc[0].to(torch.int32), misc[1:4], misc[4] > 0.5,
                            n_scan=cfg.n_scan, horizon=cfg.horizon,
                            min_range=cfg.min_range, max_range=cfg.max_range)
    args = (loam.curvature(proj.point_range, proj.valid), proj.point_col,
            loam.occlusion_mask(proj.point_range, proj.point_col, proj.valid), proj.valid,
            proj.start_ring_index, proj.end_ring_index, cfg.edge_threshold)
    cpu = loam.select_edges(*args)
    box = {}
    with device_timer("select_edges", box, device=dev):
        card = loam.select_edges(*[a.to(dev) if torch.is_tensor(a) else a for a in args])
    if not torch.equal(card.cpu(), cpu):
        raise AssertionError("host_tools: select_edges on the card differs from the CPU run")
    log("host_tools", native=True, native_build_s=round(build_s, 3),
        native_ms={k: round(v * 1e3, 3) for k, v in timings.items()},
        png_bytes=len(blob), png_encode_ms=round(enc_ms, 2),
        png_decode_ms_per_frame=round(float(np.median(dec)), 2), png_round_trip=True,
        select_edges_points=P, select_edges_edges=int(cpu.sum()), select_edges_equal=True,
        device_timer_select_edges_ms=round(box["select_edges"] * 1e3, 3))
    return float(np.median(dec))


def calibration_phase(dev):
    """Phase 19: `tests/test_chessboard_calibration_e2e.py`'s eight rendered
    views detected and calibrated on the card, under that test's gates; the
    MEI case of `tests/test_calibration.py` under its own."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from lvislam_tpu_torch.ops import calibration as cal
    from lvislam_tpu_torch.ops import chessboard as cb
    from lvislam_tpu_torch.utils import synthetic as syn
    from lvislam_tpu_torch.utils.profiling import device_timer

    views = syn.calibration_board_poses()
    img_pts, worst, detect = [], 0.0, {}
    for k, (rv, tv) in enumerate(views):
        Hm = syn.board_view_homography(rv, tv, CALIB_F, CALIB_CX, CALIB_CY, CALIB_SQ)
        img, true_pix = syn.render_board(Hm, CALIB_ROWS, CALIB_COLS, H=240, W=320, seed=7)
        with device_timer(f"d{k}", detect, device=dev):
            corners, found = cb.find_chessboard(torch.as_tensor(img, device=dev),
                                                CALIB_ROWS, CALIB_COLS)
        if not bool(found):
            raise AssertionError(f"calibration: board not found in view {k}")
        c = corners.cpu().numpy()
        d, idx = cKDTree(c).query(true_pix)
        if sorted(idx.tolist()) != list(range(CALIB_ROWS * CALIB_COLS)) or d.max() >= 0.7:
            raise AssertionError(f"calibration: view {k} corners off (max {d.max():.3f} px)")
        worst = max(worst, float(d.max()))
        img_pts.append(c[idx])
    obj = cb.board_object_points(CALIB_ROWS, CALIB_COLS, CALIB_SQ, device=dev)[:, :2]
    V, N = len(views), CALIB_ROWS * CALIB_COLS
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    args = (obj, f32(np.stack(img_pts)), torch.ones((V, N), dtype=torch.bool, device=dev),
            f32([CALIB_F * 1.12, CALIB_F * 0.9, CALIB_CX + 6, CALIB_CY - 5, 0, 0, 0, 0]),
            f32(np.stack([v[0] for v in views]) + 0.02), f32(np.stack([v[1] for v in views]) * 1.08))
    cal.calibrate(*args, model_type="PINHOLE", iterations=25)  # warm
    box = {}
    with device_timer("pinhole", box, device=dev):
        res = cal.calibrate(*args, model_type="PINHOLE", iterations=25)
    est = res.intrinsics.cpu().numpy()
    rms = float(res.rms_px)
    ok = (rms < 0.3 and abs(est[0] / CALIB_F - 1) < 0.01 and abs(est[1] / CALIB_F - 1) < 0.01
          and np.abs(est[2:4] - [CALIB_CX, CALIB_CY]).max() < 10.0)
    # the MEI case (20 iterations), under tests/test_calibration.py's bounds
    truth = np.asarray(MEI_TRUTH, np.float32)
    board, uv, rv, tv = syn.calibration_views(
        lambda pc: cal._project(torch.as_tensor(truth), torch.as_tensor(pc), "MEI").numpy(), truth)
    margs = (f32(board), f32(uv), torch.ones(uv.shape[:2], dtype=torch.bool, device=dev),
             f32(truth * (1 + np.asarray(MEI_PERTURB))), f32(rv + 0.02), f32(tv * 1.05))
    with device_timer("mei", box, device=dev):
        mres = cal.calibrate(*margs, model_type="MEI", iterations=20)
    mest, mrms = mres.intrinsics.cpu().numpy(), float(mres.rms_px)
    mok = mrms < 0.2 and np.all(np.abs(mest[3:5] / truth[3:5] - 1) < 2e-2)
    log("calibration", views=V, corners_max_err_px=round(worst, 4),
        detect_ms_per_view=round(float(np.mean(list(detect.values()))) * 1e3, 2),
        pinhole_intrinsics=[round(float(x), 4) for x in est[:4]], pinhole_rms_px=round(rms, 5),
        pinhole_ms_per_solve=round(box["pinhole"] * 1e3, 2), pinhole_iterations=25,
        mei_intrinsics=[round(float(x), 4) for x in mest[:5]], mei_rms_px=round(mrms, 5),
        mei_ms_per_solve=round(box["mei"] * 1e3, 2), mei_iterations=20)
    if not ok:
        raise AssertionError(f"calibration: pinhole solve off: {est[:4]}, rms {rms:.4f} px")
    if not mok:
        raise AssertionError(f"calibration: MEI solve off: {mest[:5]}, rms {mrms:.4f} px")


def write_euroc_camera_yaml(path: str):
    """`tests/data/fixture_camera.yaml` with phase 11's rig in place of the
    fixture's: 752x480 pinhole at f = 458.654 (distortion out), CLAHE on,
    150 features at 30 px, VIO noise at `VioParams()`, 6 BA iterations, td
    estimated, freq 10, the renderer's mount. Checked by loading it through
    the port's `run_euroc_vio.build_config`: the result is `vio_config(True)`
    but for the slots (max(150, 128), as the script sizes them)."""
    import dataclasses
    import re

    from lvislam_tpu_torch.models.vio import estimator as est
    from lvislam_tpu_torch.scripts import run_euroc_vio

    p = est.VioParams()
    full = vio_config(True)
    cam = full.camera
    fields = {"image_width": cam.image_width, "image_height": cam.image_height,
              "fx": cam.gamma1, "fy": cam.gamma2, "cx": cam.u0, "cy": cam.v0,
              "acc_n": p.acc_n, "gyr_n": p.gyr_n, "acc_w": p.acc_w, "gyr_w": p.gyr_w,
              "g_norm": p.g_norm, "max_cnt": 150, "min_dist": 30, "freq": 10, "equalize": 1,
              "max_num_iterations": 6, "estimate_td": 1}
    with open(os.path.join(ROOT, "tests", "data", "fixture_camera.yaml")) as f:
        text = f.read()
    for key, v in fields.items():
        text, n = re.subn(rf"(^\s*{key}: ).*$", lambda m: m.group(1) + repr(v), text, flags=re.M)
        if n != 1:
            raise AssertionError(f"euroc: {key} not found once in fixture_camera.yaml")
    with open(path, "w") as f:
        f.write(text)
    got = run_euroc_vio.build_config(path)
    want = dataclasses.replace(
        full, caps=dataclasses.replace(full.caps, max_features=150),
        ba=dataclasses.replace(full.ba, max_features=150))
    if got != want:
        raise AssertionError(f"euroc: the camera YAML loads as {got}, not {want}")
    return path


def write_euroc_inputs(stream, out: str):
    """Phase 11's stream (events, gyro, acc, frames) as an EuRoC mav0 folder (`utils/bag_writer.
    write_euroc`: 8-bit PNG frames by the port's writer, IMU stamps in ns at
    the MH_01 epoch) and the camera YAML beside it. Returns (mav0, YAML)."""
    import shutil

    import numpy as np

    from lvislam_tpu_torch.utils import bag_writer

    events, gyro, acc, frames = stream
    root = os.path.join(out, "mav0")
    shutil.rmtree(root, ignore_errors=True)
    imu = [(t, i) for t, kind, i in events if kind == "imu"]
    img = [(t, i) for t, kind, i in events if kind == "img"]
    bag_writer.write_euroc(root, EUROC_T0_NS, [t for t, _ in imu], [gyro[i] for _, i in imu],
                           [acc[i] for _, i in imu], [t for t, _ in img],
                           [np.round(frames[i] * 255.0).astype(np.uint8) for _, i in img])
    return root, write_euroc_camera_yaml(os.path.join(out, "euroc_camera.yaml"))


def euroc_phase(stream, dev, entry0: dict):
    """Phase 20: the port's `run_euroc_vio` on phase 11's stream (events,
    gyro, acc, frames; the trajectory is rebuilt here) written as a
    EuRoC folder, 752x480 with CLAHE; K3 and K4 counted from 0 around the
    call. Gates: the decoded frames are phase 11's; K3 = K4 = frames; the
    TUM rows finite, increasing and the runner's trajectory; no
    "misinitialized" outcome. The status and ATE are printed beside phase
    11's entry 0 and the JAX CPU run of the same folder."""
    import hashlib

    import numpy as np
    import torch

    from lvislam_tpu_torch.core.hostsync import host_bool, host_int
    from lvislam_tpu_torch.ops import clahe
    from lvislam_tpu_torch.scripts import run_euroc_vio as script
    from lvislam_tpu_torch.utils import anchors
    from lvislam_tpu_torch.utils.bag import euroc_reader

    from lvislam_tpu_torch.utils import synthetic as syn

    events, _, _, frames = stream
    traj = syn.figure8_trajectory(scale=1.5, period=8.0)  # phase 11's (`vio_input_jobs`)
    out = os.path.join(ROOT, ".chip_tmp", "euroc")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    root, yaml = write_euroc_inputs(stream, out)
    write_s = time.perf_counter() - t0
    want = hashlib.sha256()
    for fr in frames:
        want.update(np.ascontiguousarray(fr).tobytes())
    got, n_img, t0 = hashlib.sha256(), 0, time.perf_counter()
    for _, _, kind, msg in euroc_reader(root):
        if kind == "image":
            got.update(np.ascontiguousarray(msg["image"]).tobytes())
            n_img += 1
    decode_ms = (time.perf_counter() - t0) / max(n_img, 1) * 1e3
    if got.hexdigest() != want.hexdigest():
        raise AssertionError("euroc: the decoded frames are not phase 11's")
    tum_path = os.path.join(out, "trajectory.tum")
    n_track = [0]
    plain_track = script.VioRunner.track

    def track(self, t, image):
        n_track[0] += 1
        return plain_track(self, t, image)

    script.VioRunner.track = track
    try:
        clahe.HIST_LAUNCHES = clahe.APPLY_LAUNCHES = 0
        t0 = time.perf_counter()
        runner = script.main([root, "--camera-yaml", yaml, "--max-seconds", "5",
                              "--out", tum_path, "--device", str(dev)])
        drain(dev)
        wall = time.perf_counter() - t0
        launches = (clahe.HIST_LAUNCHES, clahe.APPLY_LAUNCHES)
    finally:
        script.VioRunner.track = plain_track
    if launches != (n_track[0], n_track[0]) or n_track[0] != len(frames):
        raise AssertionError(f"euroc: K3/K4 launched {launches} for {n_track[0]} frames "
                             f"({len(frames)} written)")
    first = min(t for t, _, _ in events)  # the rebased stamps start here
    shifted = ShiftedTrajectory(traj, first)
    live = host_bool(runner.vio.initialized) and len(runner.trajectory) >= 3
    fails, fc = host_int(runner.vio.failure_count), host_int(runner.vio.frame_count)
    ate = vio_summary(runner.trajectory, shifted)[0] if live else None
    status = vio_status(live, fails, fc, ate)
    rows = None
    if runner.trajectory:
        rows = np.loadtxt(tum_path, ndmin=2)
        ts = np.array([x[0] for x in runner.trajectory])
        pos = np.stack([x[1] for x in runner.trajectory])
        quat = np.stack([x[2] for x in runner.trajectory])
        mine = np.column_stack([ts, pos, quat[:, 1:4], quat[:, 0]])
        if not (np.isfinite(rows).all() and (np.diff(rows[:, 0]) > 0).all()
                and rows.shape == mine.shape and np.abs(rows - mine).max() <= 5e-7):
            raise AssertionError("euroc: the TUM rows are not the runner's trajectory")
    ref = anchors.EUROC_VIO
    log("euroc", frames=n_img, image="480x752", frames_sha256=got.hexdigest()[:16],
        write_s=round(write_s, 2), png_decode_ms_per_frame=round(decode_ms, 2),
        wall_s=round(wall, 2), rtf=round(5.0 / wall, 4), launches_K3=launches[0],
        launches_K4=launches[1], status=status, failure_count=fails, frame_count=fc,
        trajectory_points=len(runner.trajectory), tum_rows=0 if rows is None else len(rows),
        ate_m=None if ate is None else round(ate, 5),
        vio_full_entry0_status=entry0["status"], vio_full_entry0_ate_m=entry0["ate_m"],
        jax_status=ref["status"], jax_ate_m=ref["ate_m"], jax_frames_sha256=ref["frames_sha256"])
    if status == "misinitialized":
        raise AssertionError(f"euroc: a misinitialized run (ATE {ate:.3f} m, unflagged)")
    return {"K3": launches[0], "K4": launches[1]}


def synthetic_phase(dev):
    """Phase 21: the port's `run_synthetic_lvi` at its default 6 s with
    `--save-map`, `--checkpoint` and `--html`. Gates: VIO initialized with
    no failure; ATE within LVI_BAND of the worst JAX CPU reading of the
    same run (`anchors.SYNTHETIC_LVI`: its own and with one input a float32
    step off); the PCD, PPM and HTML files written; the checkpoint reloads
    through `load_state` to an equal state."""
    import torch

    from lvislam_tpu_torch.core.hostsync import host_bool, host_int
    from lvislam_tpu_torch.ops import clahe
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import knn_tail as kt
    from lvislam_tpu_torch.scripts import run_synthetic_lvi as script
    from lvislam_tpu_torch.utils import anchors, checkpoint

    ref = anchors.SYNTHETIC_LVI
    out = os.path.join(ROOT, ".chip_tmp", "synthetic")
    os.makedirs(out, exist_ok=True)
    paths = {"map": os.path.join(out, "map"), "ckpt": os.path.join(out, "lio_state.pt"),
             "html": os.path.join(out, "viewer.html")}
    kt.LAUNCHES = gnp.LAUNCHES = clahe.HIST_LAUNCHES = clahe.APPLY_LAUNCHES = 0
    t0 = time.perf_counter()
    r = script.main([str(SYNTHETIC_S), "--save-map", paths["map"], "--checkpoint",
                     paths["ckpt"], "--html", paths["html"], "--device", str(dev)])
    drain(dev)
    call_s = time.perf_counter() - t0
    launches = {"K1": kt.LAUNCHES, "K2": gnp.LAUNCHES, "K3": clahe.HIST_LAUNCHES,
                "K4": clahe.APPLY_LAUNCHES}
    sys_ = r["system"]
    cfg_sha = anchors.config_sha256(sys_.cfg)
    init, fails = host_bool(sys_.vio.initialized), host_int(sys_.vio.failure_count)
    limit = LVI_BAND * max(ref["ate_m"], *ref["ate_one_ulp_m"].values())
    files = {name: os.path.getsize(os.path.join(paths["map"], name))
             for name in ("GlobalMap.pcd", "GlobalMap_topdown.ppm", "viewer.html")
             if os.path.exists(os.path.join(paths["map"], name))}
    back = checkpoint.load_state(paths["ckpt"], sys_.lio.state, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(checkpoint._flatten(back).values(),
                                                 checkpoint._flatten(sys_.lio.state).values()))
    log("synthetic", seconds=SYNTHETIC_S, call_s=round(call_s, 2), run_s=round(r["wall_s"], 2),
        rtf=round(SYNTHETIC_S / r["wall_s"], 4), ate_m=round(r["ate_m"], 5),
        ate_limit_m=round(limit, 5), jax_ate_m=round(ref["ate_m"], 5),
        config_sha256=cfg_sha, jax_config_sha256=ref["config_sha256"],
        vio_initialized=init, failure_count=fails, poses=len(sys_.trajectory),
        jax_poses=ref["trajectory_points"], keyframes=host_int(sys_.lio.state.kf_count),
        map=r["map"], files=files, html_bytes=os.path.getsize(paths["html"]),
        checkpoint_reloads_equal=same, launches=launches)
    if cfg_sha != ref["config_sha256"]:
        raise AssertionError("synthetic: the script's configuration is not the anchor's")
    if not (init and fails == 0):
        raise AssertionError(f"synthetic: VIO initialized {init}, failures {fails}")
    if not r["ate_m"] <= limit:
        raise AssertionError(f"synthetic: ATE {r['ate_m']:.4f} m over {limit:.4f} m")
    if len(files) != 3 or min(files.values()) == 0 or not os.path.getsize(paths["html"]):
        raise AssertionError(f"synthetic: map files missing: {files}")
    if not same:
        raise AssertionError("synthetic: the checkpoint does not reload to the same state")
    return launches


# ---------------------------------------------------------------------------
# Phase 22: the multi-device part (slice 7)
# ---------------------------------------------------------------------------

MD_STEADY_SCAN = 30  # phase 22's scan: phase 3's replay warmed over scans 0-29
MD_MAPS = (1, 2, 4)  # `map` axis widths of (a) and (b)
MD_STARTS, MD_STEPS = (0, 20, 40, 60), 16  # (c): four sequences of 16 scans
MD_KNN_TOL, MD_KNN_SETS = 1e-4, 0.98  # tests/test_parallel.py's bounds
MD_X6_TOL, MD_RES_TOL = 5e-4, 2


def phase_mesh(n: int, map_parallel: int):
    """A mesh of n slots, (n // map_parallel, map_parallel): distinct cards
    where the machine has n, else `cuda:0` repeated. Returns (mesh, which)."""
    import torch

    from lvislam_tpu_torch.parallel import mesh

    distinct = torch.cuda.device_count() >= n
    devs = [f"cuda:{i}" for i in range(n)] if distinct else ["cuda:0"] * n
    return (mesh.make_mesh(devices=devs, map_parallel=map_parallel),
            "distinct cards" if distinct else "cuda:0 repeated")


def steady_scan(cfg, scans, dev, n_warm: int):
    """Phase 3's replay (`LioPipeline`, config `cfg`) over scans 0..n_warm-1,
    then scan n_warm's downsampled features (`map_step`'s voxel filter:
    `scan_corner` / `scan_surf` slots), the state's pose as the initial guess
    and its local map: the 9 arguments of `scan_to_map`."""
    from lvislam_tpu_torch.models.lio.pipeline import LioPipeline
    from lvislam_tpu_torch.ops import pointcloud as pc

    pipe = LioPipeline(cfg, device=dev)
    for s in scans[:n_warm]:
        pipe.process_scan(*s)
    _, feats = pipe.features(*scans[n_warm])
    p, caps, st = cfg.params, cfg.caps, pipe.state
    c_xyz, c_val, _ = pc.voxel_downsample(feats.corner_xyz, feats.corner_valid,
                                          p.mappingCornerLeafSize, caps.scan_corner)
    s_xyz, s_val, _ = pc.voxel_downsample(feats.surf_xyz, feats.surf_valid,
                                          p.mappingSurfLeafSize, caps.scan_surf)
    return (st.x6, c_xyz, c_val, s_xyz, s_val, st.map_corner, st.map_corner_valid,
            st.map_surf, st.map_surf_valid)


def sequence_inputs(pipe, scans, starts, n_steps: int):
    """Per step, the scan info dicts and `FeatureResult`s of the sequences
    that start at `starts` (the port's front end, `LioPipeline.features`)."""
    return [[pipe.features(*scans[s + i]) for s in starts] for i in range(n_steps)]


def step_digest(outs, state) -> str:
    """sha256 of a sequence's per-step outputs and its final state."""
    import numpy as np

    from lvislam_tpu_torch.utils import convert

    arrays = [np.asarray(x.detach().cpu()) for o in outs for x in o]
    return sha256(*arrays, *convert.to_numpy(state).values())


def unbatched_runs(caps, params, steps, dev):
    """Each sequence of `steps` through `map_step` alone: (digests, final
    states, seconds a step of one sequence, K1 and K2 launches and host
    syncs, the GN iterations of each step (rows) and sequence (columns))."""
    from lvislam_tpu_torch.core import hostsync
    from lvislam_tpu_torch.models.lio import mapping
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import knn_tail as kt

    kt.LAUNCHES = gnp.LAUNCHES = 0
    hostsync.reset()
    digests, states, times, per_seq = [], [], [], []
    for b in range(len(steps[0])):
        st, outs = mapping.lio_init(caps, dev), []
        for step in steps:
            info, feats = step[b]
            drain(dev)
            t0 = time.perf_counter()
            st, out = mapping.map_step(st, info, feats, caps, params)
            drain(dev)
            times.append(time.perf_counter() - t0)
            outs.append(out)
        digests.append(step_digest(outs, st))
        states.append(st)
        per_seq.append(outs)
    launches = {"K1": kt.LAUNCHES, "K2": gnp.LAUNCHES, "host_syncs": hostsync.COUNT}
    iters = [[int(o.gn_iters) for o in row] for row in zip(*per_seq)]
    return digests, states, times, launches, iters


def lockstep_launches(iters, params) -> dict:
    """The K1 and K2 launches of the lockstep GN for the GN iterations
    `iters` of each step (rows) and sequence (columns; 0 where the gate
    failed), on one device: a step runs as many iterations as its longest
    GN, each one K2 launch, and K1 once a refresh (both classes in one
    launch with gather-once, else one a class)."""
    r = params.nnRefreshEvery
    per_refresh = 1 if params.gatherOncePerScan else 2
    k2 = sum(max(row) for row in iters)
    k1 = sum(-(-max(row) // r) * per_refresh for row in iters)
    return {"K1": k1, "K2": k2}


def batched_run(caps, params, steps, mesh, dev):
    """The sequences in lockstep through `make_batched_step` on `mesh`:
    (per-sequence digests, batched state, seconds a lockstep step, K1 and
    K2 launches)."""
    import torch

    from lvislam_tpu_torch.core import hostsync
    from lvislam_tpu_torch.models.lio.frontend import FeatureResult
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import knn_tail as kt
    from lvislam_tpu_torch.parallel import batch_replay, mesh as pmesh

    B = len(steps[0])
    step_fn = batch_replay.make_batched_step(caps, params, mesh)
    kt.LAUNCHES = gnp.LAUNCHES = 0
    hostsync.reset()
    state = batch_replay.batched_lio_init(caps, B, mesh)
    outs, times = [], []
    for step in steps:
        info = {k: torch.stack([i[k] for i, _ in step]) for k in step[0][0]}
        feats = FeatureResult(*(torch.stack(xs) for xs in zip(*[f for _, f in step])))
        drain(dev)
        t0 = time.perf_counter()
        state, out = step_fn(state, info, feats)
        drain(dev)
        times.append(time.perf_counter() - t0)
        outs.append(pmesh.tree_map(pmesh.gather, out))
    launches = {"K1": kt.LAUNCHES, "K2": gnp.LAUNCHES, "host_syncs": hostsync.COUNT}
    whole = pmesh.tree_map(pmesh.gather, state)
    digests = [step_digest([pmesh.tree_map(lambda x, b=b: x[b], o) for o in outs],
                           pmesh.tree_map(lambda x, b=b: x[b], whole)) for b in range(B)]
    return digests, state, times, launches


def knn_agreement(a, b, valid) -> tuple[float, float, bool]:
    """(max |sorted distance difference| over the valid queries, share of
    valid queries whose neighbour sets are equal, whether every difference
    is within MD_KNN_TOL relative and absolute) of two kNN results."""
    import numpy as np

    (ia, da), (ib, db) = [(i.cpu().numpy(), d.cpu().numpy()) for i, d in (a, b)]
    v = valid.cpu().numpy()
    diff = np.abs(np.sort(da[v], 1) - np.sort(db[v], 1))
    tol = MD_KNN_TOL + MD_KNN_TOL * np.abs(np.sort(db[v], 1))
    sets = float(np.mean([set(x) == set(y) for x, y in zip(ia[v], ib[v])]))
    return float(diff.max()), sets, bool((diff <= tol).all())


def multi_device_phase(cfg, scans, dev, n_warm: int = MD_STEADY_SCAN, maps=MD_MAPS,
                       starts=MD_STARTS, n_steps: int = MD_STEPS):
    """Phase 22: the multi-device part at config 3's widths. (a) the
    map-sharded kNN and (b) the map-sharded scan-to-map GN against the
    unsharded functions on one steady scan of phase 3's replay; (c) the
    batched LIO step of four sequences against their unbatched runs; (d)
    the batched loop closure against four unbatched calls. Returns the K1 /
    K2 launches of (c)'s batched run."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.core import lie
    from lvislam_tpu_torch.models.lio import mapping
    from lvislam_tpu_torch.models.lio.pipeline import LioPipeline
    from lvislam_tpu_torch.ops import scan2map
    from lvislam_tpu_torch.parallel import batch_replay, mesh as pmesh
    from lvislam_tpu_torch.parallel import sharded_knn, sharded_scan2map
    from lvislam_tpu_torch.utils import convert

    args = steady_scan(cfg, scans, dev, n_warm)
    x6, c_xyz, c_val, s_xyz, s_val, mc, mcv, ms, msv = args
    R, t = lie.x6_rotation(x6), x6[3:6]
    classes = {"corner": (c_xyz @ R.T + t, c_val, mc, mcv),
               "surf": (s_xyz @ R.T + t, s_val, ms, msv)}
    log("multi_device_inputs", scan=n_warm, corner=f"{int(c_val.sum())}/{c_xyz.shape[0]}",
        surf=f"{int(s_val.sum())}/{s_xyz.shape[0]}",
        map_corner=f"{int(mcv.sum())}/{mc.shape[0]}", map_surf=f"{int(msv.sum())}/{ms.shape[0]}")

    # (a) the map-sharded kNN
    for name, (q, qv, m, mv) in classes.items():
        ref = scan2map.knn(q, qv, m, mv, k=5)
        row = {"unsharded_ms": round(cuda_ms(lambda: scan2map.knn(q, qv, m, mv, k=5), 10, 2), 4)}
        for n_map in maps:
            mesh, which = phase_mesh(n_map, n_map)
            fn = sharded_knn.sharded_knn(mesh, k=5)
            m_sh = pmesh.put(m, mesh, pmesh.Placement("map"))
            mv_sh = pmesh.put(mv, mesh, pmesh.Placement("map"))
            err, sets, ok = knn_agreement(fn(q, qv, m_sh, mv_sh), ref, qv)
            row[f"map{n_map}_ms"] = round(cuda_ms(lambda: fn(q, qv, m_sh, mv_sh), 10, 2), 4)
            row[f"map{n_map}_dist_err"] = err
            row[f"map{n_map}_same_sets"] = round(sets, 4)
            if not (ok and sets >= MD_KNN_SETS):
                raise AssertionError(f"multi_device knn {name} map={n_map}: distance error "
                                     f"{err:.3e}, equal sets {sets:.4f}")
        log("multi_device_knn", cls=name, Q=q.shape[0], M=m.shape[0], mesh=which, **row)

    # (b) the map-sharded scan-to-map GN
    it = cfg.params.degeneracyEigenThreshold
    ref = scan2map.scan_to_map(*args, max_iters=20, eigen_thresh=it)
    t0 = time.perf_counter()
    scan2map.scan_to_map(*args, max_iters=20, eigen_thresh=it)
    drain(dev)
    row = {"unsharded_ms": round((time.perf_counter() - t0) * 1e3, 2), "iters": int(ref.it),
           "num_residuals": int(ref.num_residuals), "converged": bool(ref.converged)}
    for n_map in maps:
        mesh, which = phase_mesh(n_map, n_map)
        fn = sharded_scan2map.sharded_scan_to_map(mesh, max_iters=20, eigen_thresh=it)
        sharded = list(args[:5]) + [pmesh.put(a, mesh, pmesh.Placement("map")) for a in args[5:]]
        got = fn(*sharded)
        t0 = time.perf_counter()
        fn(*sharded)
        drain(dev)
        err = float((got.x6 - ref.x6).abs().max())
        dres = int(got.num_residuals) - int(ref.num_residuals)
        row.update({f"map{n_map}_ms": round((time.perf_counter() - t0) * 1e3, 2),
                    f"map{n_map}_x6_err": err, f"map{n_map}_dres": dres,
                    f"map{n_map}_iters": int(got.it)})
        if not (err <= MD_X6_TOL and abs(dres) <= MD_RES_TOL
                and bool(got.converged) == bool(ref.converged)):
            raise AssertionError(f"multi_device scan_to_map map={n_map}: x6 error {err:.3e}, "
                                 f"residuals {dres:+d}, converged {bool(got.converged)} vs "
                                 f"{bool(ref.converged)}")
    log("multi_device_gn", mesh=which, **row)

    # (c) the batched LIO step: four sequences in lockstep on (batch 4, map 1)
    caps, params = cfg.caps, cfg.params
    steps = sequence_inputs(LioPipeline(cfg, device=dev), scans, starts, n_steps)
    ref_d, ref_states, t_one, k_one, iters = unbatched_runs(caps, params, steps, dev)
    mesh, which = phase_mesh(len(starts), 1)
    got_d, bstate, t_b, k_b = batched_run(caps, params, steps, mesh, dev)
    # one lockstep GN a device: on one card all sequences share it
    devs = [str(d) for d in mesh.slot_devices("batch")]
    want = {"K1": 0, "K2": 0}
    for d in sorted(set(devs)):
        cols = [b for b in range(len(starts)) if devs[b * len(devs) // len(starts)] == d]
        for key, n in lockstep_launches([[row[b] for b in cols] for row in iters],
                                        params).items():
            want[key] += n
    whole = pmesh.tree_map(pmesh.gather, bstate)
    surf0 = [whole.kf_surf[b, 0] for b in range(len(starts))]
    distinct = all(not torch.equal(surf0[a], surf0[b])
                   for a in range(len(starts)) for b in range(a))
    steady = slice(2, None)
    step_ms, one_ms = 1e3 * np.mean(t_b[steady]), 1e3 * np.mean(
        [x for b in range(len(starts)) for x in t_one[b * n_steps:][:n_steps][steady]])
    log("multi_device_batch", mesh=which, sequences=len(starts), steps=n_steps,
        starts=",".join(map(str, starts)), keyframes=",".join(
            str(int(k)) for k in whole.kf_count.tolist()),
        identical=got_d == ref_d, digests=",".join(got_d), clouds_distinct=distinct,
        launches_K1=k_b["K1"], launches_K2=k_b["K2"],
        lockstep_K1=want["K1"], lockstep_K2=want["K2"],
        unbatched_K1=k_one["K1"], unbatched_K2=k_one["K2"],
        gn_iters=";".join(",".join(map(str, row)) for row in iters),
        host_syncs=k_b["host_syncs"], unbatched_host_syncs=k_one["host_syncs"],
        lockstep_step_ms=round(step_ms, 2), four_unbatched_steps_ms=round(len(starts) * one_ms, 2))
    if got_d != ref_d:
        raise AssertionError(f"multi_device batch: sequences differ from their unbatched runs "
                             f"({got_d} vs {ref_d})")
    if not distinct:
        raise AssertionError("multi_device batch: two sequences stored the same keyframe cloud")
    got_k = {key: k_b[key] for key in want}
    if (got_k != want or min(want.values()) <= 0
            or not (want["K1"] < k_one["K1"] and want["K2"] < k_one["K2"])):
        raise AssertionError(f"multi_device batch: launches {got_k} vs the lockstep counts "
                             f"{want} (unbatched {k_one})")

    # (d) the batched loop closure, keyframe 0 of every sequence made 100 s
    # older so the time gate opens and the submap ICP runs
    kf_time = whole.kf_time.clone()
    kf_time[:, 0] -= 100.0
    aged = pmesh.put_tree(whole._replace(kf_time=kf_time), mesh, pmesh.batch_sharding(mesh))
    t0 = time.perf_counter()
    lstate, lres = batch_replay.make_batched_loop_step(caps, params)(aged)
    drain(dev)
    loop_ms = (time.perf_counter() - t0) * 1e3
    lres, lstate = pmesh.tree_map(pmesh.gather, lres), pmesh.tree_map(pmesh.gather, lstate)
    aged_whole = pmesh.tree_map(pmesh.gather, aged)
    same = True
    for b in range(len(starts)):
        s2, r = mapping.loop_closure_step(pmesh.tree_map(lambda x, b=b: x[b], aged_whole),
                                          caps, params)
        got = [x[b] for x in lres]
        same &= all(torch.equal(x, y) for x, y in zip(r, got))
        a1 = convert.to_numpy(s2)
        a2 = convert.to_numpy(pmesh.tree_map(lambda x, b=b: x[b], lstate))
        same &= all(np.array_equal(a1[k], a2[k]) for k in a1)
    log("multi_device_loop", found=",".join(str(int(x)) for x in lres.found.tolist()),
        kf_to=",".join(str(int(x)) for x in lres.kf_to.tolist()),
        fitness=",".join(f"{float(x):.5f}" for x in lres.fitness.tolist()),
        identical=same, ms=round(loop_ms, 2))
    if not same:
        raise AssertionError("multi_device loop: the batched loop step differs from four "
                             "unbatched loop_closure_step calls")
    return k_b


def watch_replay(sys_):
    """Instrument the batched replay of a fused system: per event of
    `replay_batch_step` (its branch), the host syncs and K1-K4 launches
    inside it; per frame output the host drained, its initialized and
    keyframe flags. Returns the record."""
    from lvislam_tpu_torch.core import hostsync
    from lvislam_tpu_torch.models import replay as rp
    from lvislam_tpu_torch.ops import clahe
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import knn_tail as kt

    rec = {"scan": [], "frame": [], "outputs": [],
           "branches": (rp._scan_branch, rp._frame_branch)}
    counters = lambda: (hostsync.COUNT, kt.LAUNCHES, gnp.LAUNCHES, clahe.HIST_LAUNCHES,
                        clahe.APPLY_LAUNCHES)

    def counted(kind, branch):
        def run(*a, **kw):
            c0 = counters()
            out = branch(*a, **kw)
            rec[kind].append([b - a for a, b in zip(c0, counters())])
            return out
        return run

    # the worker looks the branches up in the module at each event
    rp._scan_branch = counted("scan", rp._scan_branch)
    rp._frame_branch = counted("frame", rp._frame_branch)
    take = sys_._take_outputs

    def outputs(meta, o):
        for (kind, _, _), row in zip(meta, o):
            if kind == rp.KIND_FRAME:
                s = row[1 + rp._SCAN_OUT:]
                rec["outputs"].append((bool(s[17] > 0.5), bool(s[18] > 0.5)))
        return take(meta, o)

    sys_._take_outputs = outputs
    return rec


def unwatch_replay(rec):
    """Put the replay's branches back (`watch_replay` wrapped them)."""
    from lvislam_tpu_torch.models import replay as rp

    rp._scan_branch, rp._frame_branch = rec["branches"]


def run_replay(cfg, data, dev, warm_s: float, end_s: float):
    """`run_lvi` with the replay's events recorded: (system, interactive
    record, replay record, wall s of the timed `run`)."""
    import torch

    from lvislam_tpu_torch.models.pipeline import LviSystem
    from lvislam_tpu_torch.utils import synthetic as syn

    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
    sys_ = LviSystem(cfg, device=dev)
    rec = watch_system(sys_)
    rrec = watch_replay(sys_)
    try:
        syn.feed_lvi(sys_, data, 0.0, warm_s)
        sys_.run()
        syn.feed_lvi(sys_, data, warm_s, end_s)
        sync()
        t0 = time.perf_counter()
        sys_.run()
        sync()
        wall = time.perf_counter() - t0
    finally:
        unwatch_replay(rrec)
    return sys_, rec, rrec, wall


def replay_summary(sys_, rec, rrec, traj, t_lo: float, seconds: float, wall: float) -> dict:
    """`lvi_summary` of a replay run, and the replay's own numbers: batches,
    uploads and readbacks a batch, events staged and returned, host syncs
    and K1-K4 launches a scan event and a frame event, and the keyframes
    after initialization (interactive frames and replay outputs)."""
    import numpy as np

    r = lvi_summary(sys_, rec, traj, t_lo)
    # the timed part is all replay events: the per-event numbers below
    # replace the interactive path's per-scan and per-frame ones
    for k in ("scans_timed", "frames_timed", "syncs_per_scan", "syncs_per_frame",
              "K1_per_scan", "K2_per_scan", "K3_per_frame", "K4_per_frame"):
        del r[k]
    rc = sys_.replay_counts
    per = lambda rows, i: float(np.mean([x[i] for x in rows])) if rows else 0.0
    tot = lambda rows, i: int(sum(x[i] for x in rows))
    ev = rrec["scan"] + rrec["frame"]
    r.update(
        rtf=(seconds - t_lo) / wall, wall_s=wall, activated=sys_._replay_statics is not None,
        batches=rc["batches"], uploads_per_batch=rc["uploads"] / max(rc["batches"], 1),
        readbacks_per_batch=rc["readbacks"] / max(rc["batches"], 1),
        events_staged=rc["staged"], events_returned=rc["returned"],
        stranded=len(sys_._ev_rows) + len(sys_._rp_pending),
        scan_events=len(rrec["scan"]), frame_events=len(rrec["frame"]),
        syncs_per_scan_event=per(rrec["scan"], 0), syncs_per_frame_event=per(rrec["frame"], 0),
        K1_per_scan_event=per(rrec["scan"], 1), K2_per_scan_event=per(rrec["scan"], 2),
        K3_replay=tot(ev, 3), K4_replay=tot(ev, 4), K1_replay=tot(ev, 1), K2_replay=tot(ev, 2),
        keyframes_after_init=(sum(1 for f in rec["frames"] if f[7] and f[8])
                              + sum(1 for ok, kf in rrec["outputs"] if ok and kf)),
        loop_inserts=int(sys_.loop_db.count),
    )
    for k, i in (("K1", 1), ("K2", 2), ("K3", 3), ("K4", 4)):
        r["launches"][k] += tot(ev, i)
    return r


def check_replay(name: str, r: dict):
    """The gates phases 24 and 25 share: the replay activated and shipped
    batches, one upload and one readback a batch, every staged event came
    back, the VIO initialized with no failure."""
    if not (r["activated"] and r["batches"] > 0 and r["scan_events"] > 0 and r["frame_events"] > 0):
        raise AssertionError(f"{name}: the replay did not run ({r['batches']} batches, "
                             f"{r['scan_events']} scan / {r['frame_events']} frame events)")
    if not (r["uploads_per_batch"] == r["readbacks_per_batch"] == 1.0):
        raise AssertionError(f"{name}: {r['uploads_per_batch']} uploads and "
                             f"{r['readbacks_per_batch']} readbacks a batch")
    if r["events_returned"] != r["events_staged"] or r["stranded"]:
        raise AssertionError(f"{name}: {r['events_staged']} events staged, "
                             f"{r['events_returned']} returned, {r['stranded']} stranded")
    if not (r["init_frame"] and r["failure_count"] == 0):
        raise AssertionError(f"{name}: VIO init frame {r['init_frame']}, "
                             f"failures {r['failure_count']}")


def lvi_replay_phase(data, dev):
    """Phase 24: phase 14's configuration with `replay_batch = REPLAY_BATCH`
    over the 12 s parity stream, 2 s warm then 10 s timed; gated against the
    JAX replay's clean-CPU readings (`anchors.LVI_REPLAY`); the first 4 s
    repeated bit for bit. Returns its summary."""
    import numpy as np

    from lvislam_tpu_torch.utils import anchors
    from lvislam_tpu_torch.utils import synthetic as syn

    ref = anchors.LVI_REPLAY
    cfg = dataclasses.replace(lvi_parity_config(), replay_batch=REPLAY_BATCH)
    cfg_cpu = anchors.config_sha256(dataclasses.replace(lvi_parity_config(kernels=False),
                                                        replay_batch=REPLAY_BATCH))
    seq = syn.lvi_sequence_sha256(data)
    if cfg_cpu != ref["config_sha256"] or seq != ref["stream_sha256"]:
        raise AssertionError(f"lvi_replay: config {cfg_cpu} / stream {seq} are not the "
                             f"anchor's ({ref['config_sha256']} / {ref['stream_sha256']})")
    traj = syn.figure8_trajectory(scale=3.0, period=30.0)
    sys_, rec, rrec, wall = run_replay(cfg, data, dev, LVI_WARM_S, LVI_PARITY_S)
    r = replay_summary(sys_, rec, rrec, traj, LVI_WARM_S, LVI_PARITY_S, wall)
    worst = max(ref["ate_m"], *ref["ate_one_ulp_m"].values())
    limit = LVI_BAND * worst
    log("lvi_replay", seconds=LVI_PARITY_S, timed_s=LVI_PARITY_S - LVI_WARM_S,
        replay_batch=REPLAY_BATCH, ate_limit_m=round(limit, 5), jax_ate_m=round(ref["ate_m"], 5),
        jax_worst_ate_m=round(worst, 5), jax_init_frame=ref["init_frame"],
        jax_vio_frames=ref["vio_frames"], config_sha256=anchors.config_sha256(cfg),
        cpu_config_sha256=cfg_cpu, stream_sha256=seq, **fmt_run(r))
    check_replay("lvi_replay", r)
    if not r["ate_m"] <= limit:
        raise AssertionError(f"lvi_replay: ATE {r['ate_m']:.4f} m over {limit:.4f} m")
    sys2, _, _, _ = run_replay(cfg, data, dev, LVI_WARM_S, LVI_REPEAT_S)
    rows = lambda s: np.stack([np.r_[t, x6] for t, x6 in s.trajectory if t < LVI_REPEAT_S])
    a, b = rows(sys_), rows(sys2)
    log("lvi_replay_determinism", seconds=LVI_REPEAT_S, rows=len(b), sha256=sha256(b),
        identical=bool(np.array_equal(a, b)))
    if not np.array_equal(a, b):
        raise AssertionError("lvi_replay determinism: the first 4 s differ")
    return r


def lvi_replay_full_phase(data, dev):
    """Phase 25: phase 15's configuration (the shipped scale) with
    `replay_batch = REPLAY_BATCH` (`bench.py:733`), 2 s warm then 5 s timed.
    Gates: the replay's (`check_replay`); K1-K4 each launched inside the
    replay, K3 = K4 = the frame events; loop-database inserts = VIO
    keyframes after initialization; ATE <= LVI_FULL_ATE_M. Returns its
    summary."""
    from lvislam_tpu_torch.utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=3.0, period=30.0)
    cfg = dataclasses.replace(lvi_full_config(), replay_batch=REPLAY_BATCH)
    sys_, rec, rrec, wall = run_replay(cfg, data, dev, LVI_WARM_S, LVI_FULL_S)
    r = replay_summary(sys_, rec, rrec, traj, LVI_WARM_S, LVI_FULL_S, wall)
    r["loops"] = int(sys_.lio.state.n_loops)
    log("lvi_replay_full", seconds=LVI_FULL_S, timed_s=LVI_FULL_S - LVI_WARM_S,
        replay_batch=REPLAY_BATCH, ate_limit_m=LVI_FULL_ATE_M, **fmt_run(r))
    check_replay("lvi_replay_full", r)
    if min(r["K1_replay"], r["K2_replay"], r["K3_replay"], r["K4_replay"]) <= 0:
        raise AssertionError(f"lvi_replay_full: a kernel was not launched inside the replay "
                             f"(K1-K4 {r['K1_replay']}, {r['K2_replay']}, {r['K3_replay']}, "
                             f"{r['K4_replay']})")
    if not r["K3_replay"] == r["K4_replay"] == r["frame_events"]:
        raise AssertionError(f"lvi_replay_full: K3 / K4 {r['K3_replay']} / {r['K4_replay']} "
                             f"for {r['frame_events']} frame events")
    if r["loop_inserts"] != r["keyframes_after_init"]:
        raise AssertionError(f"lvi_replay_full: {r['loop_inserts']} loop-database inserts for "
                             f"{r['keyframes_after_init']} keyframes after initialization")
    if not r["ate_m"] <= LVI_FULL_ATE_M:
        raise AssertionError(f"lvi_replay_full: ATE {r['ate_m']:.4f} m over {LVI_FULL_ATE_M} m")
    return r


@contextlib.contextmanager
def quoted(tag: str):
    """A tool's own output lines, printed after the block with `tag` in
    front (so no line of the script but its last two is a bare JSON
    object)."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield
    finally:
        for line in buf.getvalue().splitlines():
            print(f"  {tag}: {line}", flush=True)


TOOLS_VIO_REPS = 2  # phase 26: the bench's vio section at 2 calls a try (the bench: 8)
TOOLS_STAGES_REPS = 2  # phase 26: profile stages at 2 calls an item (the tool: 5)
TOOLS_STAGES_TOL = 0.10  # phase 26: the profiled stages' device time within 10% of the step's
TOOLS_VOCAB_ARGS = ["--worlds", "1", "--frames", "4", "--words", "64"]  # phase 26: toy training


def tools_phase(scans, dev) -> dict:
    """Phase 26: the port's tools on the card. (a) The benchmark's `imu`
    and `vio` sections (`bench.imu_section`, `bench.vio_section`): every
    `bench.py` key of the two present and finite, K3 and K4 launched in
    `tracker_step_ms`'s call. (b) `profile stages` on phase 3's scans (12
    warm) and `profile query` at the full shapes (65536 map points, 2048
    queries): unpack + project + features + `map_step` within
    TOOLS_STAGES_TOL of the whole step in device time; K1's wrapper, its
    plain version and `torch.topk` select the same neighbours. (c)
    `train_vocab` at toy arguments on the card and on the CPU: the same
    vocabulary and idf. Returns the phase's K1-K4 launches."""
    import numpy as np

    from lvislam_tpu_torch.scripts import bench, profile, train_vocab

    c0 = bench.counters()
    out = {}
    bench.imu_section(out, dev)
    bench.vio_section(out, dev, reps=TOOLS_VIO_REPS)
    keys = ("imu_dead_reckon_ms_per_60s", "imu_dead_reckon_rtf", "vio_ba_solve_ms",
            "vio_ba_iters_per_sec", "vio_ba_vs_ref_budget", "tracker_step_ms", "depth_reg_ms")
    log("tools_bench", **{k: out[k] for k in keys},
        **{k: v for k, v in out.items() if k not in keys})
    bad = [k for k in keys if not (k in out and np.isfinite(out[k]))]
    if bad:
        raise AssertionError(f"tools: bench keys missing or not finite: {bad}")
    k34 = out["tracker_step_launches"]
    if not (k34["K3"] >= 1 and k34["K4"] >= 1):
        raise AssertionError(f"tools: tracker_step_ms's call launched K3 / K4 {k34}")

    with quoted("profile"):
        st = profile.cmd_stages(profile.parse_args(
            ["stages", "--reps", str(TOOLS_STAGES_REPS), "--device", str(dev)]), dev, scans)[-1]
        q = profile.cmd_query(profile.parse_args(["query", "--device", str(dev)]), dev)[-1]
    log("tools_profile", stages_device_ms=st["stages_device_ms"],
        whole_device_ms=st["whole_device_ms"], device_sum_over_whole=st["device_sum_over_whole"],
        stages_ms=st["stages_ms"], whole_ms=st["whole_ms"], sum_over_whole=st["sum_over_whole"],
        query_selections_equal=q["selections_equal"], query_found_share=q["found_share"])
    if not abs(st["device_sum_over_whole"] - 1.0) <= TOOLS_STAGES_TOL:
        raise AssertionError(f"tools: the stages' device time is {st['device_sum_over_whole']} "
                             "of the whole step's")
    if not q["selections_equal"]:
        raise AssertionError(f"tools: query selections differ {q}")

    out_dir = os.path.join(ROOT, ".chip_tmp", "vocab")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    with quoted("train_vocab"):
        card = train_vocab.main([os.path.join(out_dir, "card.npz"), *TOOLS_VOCAB_ARGS,
                                 "--device", str(dev)])
        card_s = time.perf_counter() - t0
        cpu = train_vocab.main([os.path.join(out_dir, "cpu.npz"), *TOOLS_VOCAB_ARGS,
                                "--device", "cpu"])
    equal = [bool(np.array_equal(a, b)) for a, b in zip(card, cpu)]
    log("tools_train_vocab", args=" ".join(TOOLS_VOCAB_ARGS), words=card[0].shape[0],
        vocab_equal=equal[0], idf_equal=equal[1], card_s=round(card_s, 2))
    if not all(equal):
        raise AssertionError("tools: train_vocab's vocabulary or idf differ between the card "
                             "and the CPU")
    return dict(zip(("K1", "K2", "K3", "K4"),
                    [b - a for a, b in zip(c0[1:], bench.counters()[1:])]))


def main() -> int:
    import torch

    # ---- 0. device ----
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, ROOT)
    import lvislam_tpu_torch  # noqa: F401  (full-f32 math settings)

    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    pool = stream_pool()
    phases = phase_pool()
    try:
        return run_phases(pool, phases, dev)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        phases.shutdown(wait=True, cancel_futures=True)


def phase_pool():
    """Seven spawned processes (`phase_worker_init`) for phases 15, 16, 17,
    20, 21, 24 and 25, which run on the card while the main process runs
    18, 19, 14, 22 and 26: every phase is host-bound and the card is mostly
    idle, so the script's time stays under its limit on a slow host."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(7, mp_context=multiprocessing.get_context("spawn"),
                               initializer=phase_worker_init, initargs=(T_START,))


def run_phases(pool, phases, dev) -> int:
    import numpy as np
    import torch

    from lvislam_tpu_torch.core.config import CameraIntrinsics
    from lvislam_tpu_torch.ops import _kernels
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import knn_tail as kt
    from lvislam_tpu_torch.utils import synthetic as syn
    from lvislam_tpu_torch.utils.metrics import ate_rmse

    # every phase's stream, raycast by the pool in the order they are needed
    streams = {"scans": Prefetch(pool, *scan_jobs()),
               "tracker": Prefetch(pool, *tracker_frame_jobs()),
               "vio_fixture": Prefetch(pool, *vio_input_jobs(False)),
               "vio_full": Prefetch(pool, *vio_input_jobs(True)),
               "parity": lvi_stream(pool, duration=LVI_PARITY_S),
               "full": lvi_stream(pool, duration=LVI_FULL_S, horizon=6000, cam=CameraIntrinsics())}
    if "--loop" in sys.argv:
        streams["loop"] = lvi_stream(pool, duration=LVI_LOOP_S)
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 1. build ----
    t0 = time.perf_counter()
    _kernels.library()
    log("build", seconds=round(time.perf_counter() - t0, 2),
        nvcc_seconds=round(_kernels.BUILD_SECONDS, 2), flags=" ".join(_kernels.NVCC_FLAGS))
    for line in _kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:" + line.split("ptxas info")[-1], flush=True)

    # ---- 2. kernel parity at the step's shapes ----
    corner, surf, h_c, h_s, q_c, q_s, x6 = parity_inputs(dev)
    e1, m1, p1 = check_knn_pair([knn_set(h_c, q_c), knn_set(h_s, q_s)], ("corner", "surf"))
    e2, m2, p2 = check_gn_pair([gn_blocks(h_c, corner, q_c, x6), gn_blocks(h_s, surf, q_s, x6)],
                               gn_pose(x6))

    # ---- 3. full-width replay through the port's entry point ----
    scans = streams["scans"].get()
    log("scans", n=len(scans), wait_seconds=round(streams["scans"].waited_s, 1))
    gt = np.stack([s[0]["true_pos"] for s in scans])
    cfg = full_width_config()
    kt.LAUNCHES = 0
    gnp.LAUNCHES = 0
    traj1, times, syncs, n_kf, gn_iters = replay(cfg, scans, dev)
    launches = {"K1": kt.LAUNCHES, "K2": gnp.LAUNCHES}
    refresh = cfg.params.nnRefreshEvery
    n_refresh = int(sum((n + refresh - 1) // refresh for n in gn_iters))
    if traj1.shape != (N_SCANS, 6) or not np.isfinite(traj1).all():
        raise AssertionError(f"replay: bad trajectory {traj1.shape}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"replay: a kernel was never launched {launches}")
    if launches["K2"] != int(gn_iters.sum()) or launches["K1"] != n_refresh:
        raise AssertionError(f"replay: {launches} launches for {int(gn_iters.sum())} GN "
                             f"iterations and {n_refresh} refreshes (one K2 launch per "
                             "iteration, one K1 launch per refresh)")
    ate = ate_rmse(traj1[:, 3:6].astype(np.float64), gt, align=True)
    with open(os.path.join(ROOT, "bench_anchors.json")) as f:
        ate_ref = float(json.load(f)["ate_cpu_ref_m"])
    pct = 100.0 * (ate - ate_ref) / ate_ref
    steady = np.asarray(times[N_WARM:]) * 1e3
    log("replay", scans=N_SCANS, ate_m=round(ate, 5), ate_cpu_ref_m=ate_ref,
        ate_vs_ref_pct=round(pct, 2), steady_ms_mean=round(float(steady.mean()), 2),
        steady_ms_p50=round(float(np.median(steady)), 2),
        steady_ms_max=round(float(steady.max()), 2),
        first_scan_ms=round(times[0] * 1e3, 1),
        rtf=round((1.0 / RATE) / (float(steady.mean()) / 1e3), 2),
        host_syncs_per_scan=round(float(np.mean(syncs[N_WARM:])), 2),
        host_syncs_max=max(syncs), keyframes=n_kf, gn_iters=int(gn_iters.sum()),
        nn_refreshes=n_refresh, launches_K1=launches["K1"], launches_K2=launches["K2"],
        trajectory_sha256=sha256(traj1))
    if pct > ATE_LIMIT_PCT:
        raise AssertionError(f"replay: ATE {ate:.4f} m is {pct:+.2f}% vs the "
                             f"anchor {ate_ref} m (limit +{ATE_LIMIT_PCT}%)")

    # ---- 4. determinism ----
    traj2 = replay(cfg, scans, dev)[0]
    if not np.array_equal(traj1, traj2):
        raise AssertionError("determinism: second replay differs "
                             f"(max {np.abs(traj1 - traj2).max():.3e})")
    log("determinism", identical=True)

    # ---- 3b. the same replay at the bench's upload_batch ----
    batched_k = lio_upload_batch_phase(scans, dev, sha256(traj1),
                                       1e3 * float(np.mean(times[N_WARM:])))
    n_prof = int(sys.argv[sys.argv.index("--profile") + 1]) if "--profile" in sys.argv else 0
    if n_prof:
        profile_steady(cfg, scans, dev, n_prof)

    # ---- 5. CLAHE kernels at the rig's shape ----
    from lvislam_tpu_torch.ops import clahe
    from lvislam_tpu_torch.utils.anchors import TRACKER_SEQUENCE as ref

    cam, world, traj, ts, frames = streams["tracker"].get()
    log("frames", n=len(frames), shape=f"{frames[0].shape[0]}x{frames[0].shape[1]}",
        model=cam.model_type, wait_seconds=round(streams["tracker"].waited_s, 1))
    k34 = check_clahe_kernels(rig_clahe_images(frames[0]), dev)

    # ---- 6. the tracker sequence through FeatureTracker ----
    clahe.HIST_LAUNCHES = 0
    clahe.APPLY_LAUNCHES = 0
    outs, ftimes, fsyncs = track_sequence(frames, ts, cam, dev)
    launches["K3"], launches["K4"] = clahe.HIST_LAUNCHES, clahe.APPLY_LAUNCHES
    if launches["K3"] != N_FRAMES or launches["K4"] != N_FRAMES:
        raise AssertionError(f"tracker: K3/K4 launched {launches['K3']}/{launches['K4']} "
                             f"times in {N_FRAMES} frames")
    n_tr = [int(o["n_tracked"]) for o in outs]
    for o in outs:
        live = o["ids"] >= 0
        if not (np.isfinite(o["uv"][live]).all() and np.isfinite(o["norm"][live]).all()):
            raise AssertionError("tracker: non-finite feature coordinates")
    bad = [k for k in range(1, N_FRAMES)
           if abs(n_tr[k] - ref["n_tracked"][k]) > max(5, 0.05 * ref["n_tracked"][k])]
    if bad:
        raise AssertionError(f"tracker: n_tracked {n_tr} vs JAX {ref['n_tracked']} "
                             f"beyond max(5, 5%) on frames {bad}")
    epi = epipolar_median_px(outs, ts, traj)
    steady = np.asarray(ftimes[2:]) * 1e3
    log("tracker", frames=N_FRAMES, n_tracked=",".join(map(str, n_tr)),
        jax_n_tracked=",".join(map(str, ref["n_tracked"])),
        epipolar_median_px=round(epi, 4), jax_epipolar_median_px=ref["epipolar_median_px"],
        steady_ms_mean=round(float(steady.mean()), 2),
        steady_ms_p50=round(float(np.median(steady)), 2),
        first_frame_ms=round(ftimes[0] * 1e3, 1),
        host_syncs_per_frame=round(float(np.mean(fsyncs)), 2),
        launches_K3=launches["K3"], launches_K4=launches["K4"],
        tracks_sha256=sha256(*(o[key] for o in outs for key in ("ids", "uv", "norm"))))
    if epi > 2.0 * ref["epipolar_median_px"]:
        raise AssertionError(f"tracker: epipolar median {epi:.4f} px is over twice "
                             f"the JAX run's {ref['epipolar_median_px']} px")
    outs2, _, _ = track_sequence(frames, ts, cam, dev)
    for k, (a, b) in enumerate(zip(outs, outs2)):
        for key in ("ids", "uv", "norm"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"tracker determinism: {key} differs on frame {k}")
    log("tracker_determinism", identical=True)
    if n_prof:
        profile_tracker(frames, ts, cam, dev, min(n_prof, N_FRAMES - 2))

    # ---- 7. depth association for the last frames ----
    cloud = depth_cloud([scans[i][0] for i in CLOUD_SCANS], traj)
    depths, dms = register_last_frames(outs, ts, cloud, traj, dev)
    share, med = depth_metrics(outs[-DEPTH_FRAMES:], depths, ts[-DEPTH_FRAMES:], world, traj)
    log("depth", cloud_points=cloud.shape[0], frames=DEPTH_FRAMES, depth_share=round(share, 4),
        jax_depth_share=ref["depth_share"], median_err_m=round(med, 5),
        jax_median_err_m=ref["depth_median_err_m"], register_ms=round(dms, 4))
    if abs(share - ref["depth_share"]) > DEPTH_SHARE_TOL:
        raise AssertionError(f"depth: share {share:.4f} vs JAX {ref['depth_share']} "
                             f"(tolerance {DEPTH_SHARE_TOL})")
    if med > ref["depth_median_err_m"] * DEPTH_ERR_FACTOR + DEPTH_ERR_SLACK_M:
        raise AssertionError(f"depth: median error {med:.4f} m vs JAX "
                             f"{ref['depth_median_err_m']} m")

    # ---- 8. each kernel alone: device time per launch against its bound ----
    alone = kernel_alone([knn_set(h_c, q_c), knn_set(h_s, q_s)],
                         [gn_blocks(h_c, corner, q_c, x6), gn_blocks(h_s, surf, q_s, x6)],
                         gn_pose(x6), frames[0], dev, sweep="--sweep" in sys.argv)
    batched = batched_alone((corner, surf, h_c, h_s, q_c, q_s, x6), dev, alone)

    # ---- 9. the IMU side: dead reckoning, the smoother over the replay ----
    from lvislam_tpu_torch.utils import anchors

    imu_dead_reckoning(dev)
    fusion_over_replay(traj1, dev)
    imu_rate_prediction(dev)

    # ---- 10. VIO at the fixture's size ----
    stream = streams["vio_fixture"].get()
    log("vio_frames", n=len(stream[4]), shape="240x320", imu_samples=len(stream[2]),
        wait_seconds=round(streams["vio_fixture"].waited_s, 1))
    check_vio("vio_fixture", vio_config(False), stream, anchors.VIO_FIXTURE, dev, n_prof)

    # ---- 11. VIO at full width: the EuRoC cam0 size, CLAHE on ----
    stream = streams["vio_full"].get()
    log("vio_frames", n=len(stream[4]), shape="480x752", imu_samples=len(stream[2]),
        wait_seconds=round(streams["vio_full"].waited_s, 1))
    k34_vio = check_clahe_kernels({"euroc": (stream[4][0], "aligned")}, dev)["euroc"]
    clahe_alone(stream[4][0], dev, alone_reporter(alone), sweep="--sweep" in sys.argv,
                tag="_480x752")
    (vio_k3, vio_k4), vio_full_outcomes = check_vio(
        "vio_full", vio_config(True), stream, anchors.VIO_FULL_WIDTH, dev, n_prof)
    by_path = {"K1": {"lio_replay": launches["K1"]}, "K2": {"lio_replay": launches["K2"]},
               "K3": {"tracker": launches["K3"], "vio_full": vio_k3},
               "K4": {"tracker": launches["K4"], "vio_full": vio_k4}}
    launches = {k: sum(v.values()) for k, v in by_path.items()}

    # ---- 12. BA alone at the reference shape ----
    ba_alone(dev)

    # ---- 13. the visual loop detector alone ----
    loop_ms = loop_scene_phase(syn.loop_scene(), dev)

    # ---- 15, 16, 17, 20, 21, 24, 25: config 5 at the shipped scale, the
    # bag-replay, EuRoC and synthetic entry points and the batched replay,
    # each in a process of its own, on the card beside phases 14 and 22 ----
    full_data = streams["full"].get()
    log("lvi_full_stream", wait_seconds=round(streams["full"].waited_s, 1))
    shipped_inputs = write_shipped_inputs(full_data)
    jobs = [phases.submit(lvi_full_phase, full_data, dev),
            phases.submit(bag_fixture_phase, dev),
            phases.submit(bag_shipped_phase, shipped_inputs, dev),
            phases.submit(euroc_phase, stream[1:], dev, vio_full_outcomes[0]),
            phases.submit(synthetic_phase, dev),
            phases.submit(lvi_replay_phase, streams["parity"].get(), dev),
            phases.submit(lvi_replay_full_phase, full_data, dev)]

    # ---- 18. the host tools: native library, PNG codec, exact LOAM pick ----
    host_tools_phase(stream[4][0], scans, dev)

    # ---- 19. the calibration tool on the card ----
    calibration_phase(dev)

    # ---- 14. config 5 at the parity scale ----
    par = lvi_parity_phase(streams["parity"], dev)

    # ---- 22. the multi-device part at config 3's widths ----
    md = multi_device_phase(cfg, scans, dev)

    # ---- 26. the tools: bench sections, profile, train_vocab ----
    tools_k = tools_phase(scans, dev)

    (full, full_gated, full_rows), (_, bag_fix), (_, bag_ship, ship_rows), euroc_k, \
        synthetic_k, rep24, rep25 = [job.result() for job in jobs]
    compare_with_full(ship_rows, full_rows)
    # phases 24 and 25 beside 14 and 15 (each in its own process, at other
    # times): the replay's RTF, handler ms and host syncs an event
    for name, a, b in (("lvi_replay_vs_parity", rep24, par), ("lvi_replay_full_vs_full", rep25, full)):
        log(name, **{f"{k}_{tag}": round(r[k], 4) for tag, r in (("replay", a), ("interactive", b))
                     for k in ("rtf", "lidar_ms_mean", "image_ms_mean", "ate_m")},
            syncs_per_scan_event=round(a["syncs_per_scan_event"], 3),
            syncs_per_frame_event=round(a["syncs_per_frame_event"], 3),
            syncs_per_scan_interactive=round(b["syncs_per_scan"], 3),
            syncs_per_frame_interactive=round(b["syncs_per_frame"], 3))
    if "--loop" in sys.argv:
        lvi_loop_phase(streams["loop"], dev)
    for key in ("K1", "K2", "K3", "K4"):
        by_path[key]["lvi_parity"] = par["launches"][key]
        by_path[key]["lvi_full"] = full["launches"][key]
        if full_gated is not full:
            by_path[key]["lvi_full_rebuild1"] = full_gated["launches"][key]
        by_path[key]["bag_fixture"] = bag_fix[key]
        by_path[key]["bag_shipped"] = bag_ship[key]
        by_path[key]["synthetic_entry"] = synthetic_k[key]
        by_path[key]["lvi_replay"] = rep24["launches"][key]
        by_path[key]["lvi_replay_full"] = rep25["launches"][key]
        if key in batched_k:
            by_path[key]["lio_upload_batch"] = batched_k[key]
        if key in euroc_k:
            by_path[key]["euroc_entry"] = euroc_k[key]
        by_path[key]["tools"] = tools_k[key]
    launches = {k: sum(v.values()) for k, v in by_path.items()}

    def timing(key):
        a = alone[key]
        return {"bound_ms": a["bound_us"] / 1e3, "bound_by": a["bound_by"],
                "library_ms": a["library_ms"], "kernel_us": a["kernel_us"],
                "bound_us": a["bound_us"], "bound_share": a["bound_share"]}

    def at_vio_shape(key, col):
        """The kernel's record at the full-width VIO frame's shape: wrapper
        and plain ms, kernel-alone µs and its bound there."""
        a = alone[f"{key}_480x752"]
        return {"shape": "480x752", "path": a["path"], "ms": k34_vio[2][key],
                "plain_ms": k34_vio[2][f"{key}_plain"],
                "max_abs_err": k34_vio[col], "kernel_us": a["kernel_us"],
                "library_ms": a["library_ms"],
                "bound_us": a["bound_us"], "bound_ms": a["bound_us"] / 1e3,
                "bound_by": a["bound_by"], "bound_share": a["bound_share"]}

    kernels = [
        {"name": "knn_tail", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/knn_tail.cu",
         "replaces": "lvislam_tpu/ops/pallas_knn.py:79",
         "launches": launches["K1"], "launches_by_path": by_path["K1"],
         "max_abs_err": e1,
         "ms": m1, "plain_ms": p1, **timing("K1_pair"),
         "library": "torch.topk(d, 5, largest=False) on the masked distances: "
                    "the selection half only"},
        {"name": "gn_partials", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/gn_partials.cu",
         "replaces": "lvislam_tpu/ops/pallas_gn.py:369",
         "launches": launches["K2"], "launches_by_path": by_path["K2"],
         "max_abs_err": e2,
         "ms": m2, "plain_ms": p2, **timing("K2_pair")},
        {"name": "knn_tail_batched", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/knn_tail.cu",
         "replaces": "lvislam_tpu/ops/pallas_knn.py:112",
         "launches": md["K1"], "launches_by_path": {"multi_device_batch": md["K1"]},
         **batched["K1_batched"], **timing(f"K1_batched_S{BATCH_S}"), "sequences": BATCH_S,
         "singles_us": alone[f"K1_pair_x{BATCH_S}"]["kernel_us"],
         "library": "torch.topk(d, 5, largest=False) on the masked distances of all "
                    "sequences: the selection half only"},
        {"name": "gn_partials_batched", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/gn_partials.cu",
         "replaces": "lvislam_tpu/ops/pallas_gn.py:382",
         "launches": md["K2"], "launches_by_path": {"multi_device_batch": md["K2"]},
         **batched["K2_batched"], **timing(f"K2_batched_S{BATCH_S}"), "sequences": BATCH_S,
         "singles_us": alone[f"K2_pair_x{BATCH_S}"]["kernel_us"]},
        {"name": "tile_hist", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/clahe.cu",
         "replaces": "lvislam_tpu/ops/pallas_clahe.py:53",
         "launches": launches["K3"], "launches_by_path": by_path["K3"],
         "max_abs_err": max(r[0] for r in (*k34.values(), k34_vio)),
         "ms": k34["rendered"][2]["K3"], "plain_ms": k34["rendered"][2]["K3_plain"],
         **timing("K3"), "vio_full": at_vio_shape("K3", 0),
         "library": "torch.bincount(keys, minlength=64*256) on precomputed keys "
                    "tile * 256 + bin: the counting half only"},
        {"name": "apply_cdf", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/clahe.cu",
         "replaces": "lvislam_tpu/ops/pallas_clahe.py:98",
         "launches": launches["K4"], "launches_by_path": by_path["K4"],
         "max_abs_err": max(r[1] for r in (*k34.values(), k34_vio)),
         "ms": k34["rendered"][2]["K4"], "plain_ms": k34["rendered"][2]["K4_plain"],
         **timing("K4"), "vio_full": at_vio_shape("K4", 1),
         "library": "F.grid_sample of the (1, 1, 256, 8, 8) CDF volume at precomputed "
                    "coordinates, bilinear, border, align_corners=True: the lookup half only"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
