"""The port's benchmark record: ``bench.py``'s sections on the port, with
``bench.py``'s key names.

Usage:
  python -m lvislam_tpu_torch.scripts.bench [--device cpu] [--sections lio,imu]
      [--lio-warm 11] [--lio-segment 40] [--lio-segments 2] [--lvi-seconds 12]
      [--loop-seconds 38] [--euroc-seconds 5] [--reps 8] [--workers 4]
      [--budget 3000]

On the card (``cuda``) unless ``--device cpu`` is given; without a card it
raises. The depth options cut a section's stream or its timed repetitions
(the tests pass toy depths); every configuration stays at its full width.

Sections, in ``bench.py:1088-1123``'s order, each printed as it ends: the
whole record is re-emitted as one JSON line after every section, and the
last line of the output is the whole record.

- ``lio`` (the headline, ``bench.py:989-1043``): ``full_width_config`` (K1
  and K2 on) at ``upload_batch = 8`` over the bench's 91 scans: 11 warm, then
  the faster of two segments of 40. Keys ``metric`` = lio_real_time_factor,
  ``value``, ``unit``, ``per_scan_ms``, ``ate_rmse_m`` (aligned, over every
  scan), ``scans``, ``backend``, ``ate_cpu_ref_m``, ``ate_vs_cpu_ref_pct``.
  **K2 is on**, where ``bench.py:209`` turns ``pallas_gn`` off: there its
  polynomial ``acos`` flipped residual gates on the TPU and cost +12% ATE;
  the port's K2 is bit-equal to its plain version, and without it the
  port's GN partials run as separate torch ops without FMA contraction,
  which read +8.31% ATE.
- ``lvi``: config 5 at the parity scale with ``replay_batch = 16``
  (``lvi_parity_config``, phase 24's configuration), 2 s warm and 10 s
  timed: ``lvi_rtf_measured``, ``lvi_ate_rmse_m``, ``lvi_vio_initialized``,
  ``lvi_replay_active``, ``lvi_ate_cpu_ref_m``, ``lvi_ate_vs_cpu_ref_pct``,
  ``lvi_ate_cpu_exact_m``, ``lvi_knob_cost_pct``.
- ``imu``: ``navstate_predict`` over ``bench.py:343-360``'s 60 s x 200 Hz:
  ``imu_dead_reckon_ms_per_60s``, ``imu_dead_reckon_rtf``.
- ``vio``: ``ba.solve`` "schur" on ``synthetic.consistent_window(10, 150)``
  (``vio_ba_solve_ms``, ``vio_ba_iters_per_sec`` over the iterations the
  solve ran, ``vio_ba_vs_ref_budget`` against 10 iterations / 35 ms), one
  ``tracker_step`` at MEI 1024x576 with 150 live tracks seeded as
  ``bench.py:296-309`` (``tracker_step_ms``; K3 and K4 run in it) and
  ``register_depth`` against 12 x 4096 points (``depth_reg_ms``).
- ``euroc``: ``run_euroc_vio`` on the JAX EuRoC test's fixture (5 s,
  320x240 PNG frames by the port's writer) with
  ``tests/data/fixture_camera.yaml``: ``vio_euroc_init``,
  ``vio_euroc_failures``, ``vio_euroc_ate_m`` (the TUM rows against the
  truth at their stamps plus the first message's, which the script rebases
  to 0; null under 10 rows, where ``bench.py`` leaves the key out).
- ``full_scale``: ``lvi_full_config`` with ``replay_batch = 16`` over 7 s
  (2 s warm, 5 s timed; K1-K4): ``lvi_full_scale_rtf``,
  ``lvi_full_scale_ate_m``, ``lvi_full_scale_vio_init``,
  ``lvi_full_scale_loops``.
- ``loop``: the 38 s revisit arm (``lvi_loop_config``), then the arm
  without the LIS loop detector when the budget allows 2.5 x the first
  arm's wall: ``lvi_loop_rtf``, ``lvi_loop_ate_m``, ``lvi_loop_count``,
  ``lvi_loop_kf_ate_m``, ``lvi_noloop_kf_ate_m``,
  ``lvi_loop_kf_ate_delta_m``.

Beside every wall time the record carries the host syncs
(``core/hostsync.COUNT``) and the K1-K4 launches of the same work, under
``*_host_syncs`` and ``*_launches`` (a scan, a call, or the timed run, as
the key beside them says). Times are host clocks around work that ends in
``torch.cuda.synchronize`` or CUDA events (``utils/profiling.device_timer``),
never a readback. The ATE anchors are ``bench_anchors.json``'s clean-CPU
JAX readings; ``*_anchor`` names the one each ``*_vs_cpu_ref_pct`` uses.
``config_sha`` hashes every field of every configuration the run used and
the streams' parameters. A section that raises is recorded as
``<name>_error`` and the script exits non-zero; one that would overrun the
wall budget (``BENCH_WALL_BUDGET_S``, 3,000 s, counted once the inputs are
ready) is recorded as ``<name>_skipped`` with the reason. The streams are
raycast first, by ``--workers`` spawned processes (``inputs_s``), so no
raycast shares the host with a timed section.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..core import hostsync
from ..core.device import resolve
from ..ops import clahe
from ..ops import gn_partials as gnp
from ..ops import knn_tail as kt
from ..utils import anchors
from ..utils.metrics import ate_rmse
from ..utils.profiling import device_timer
from . import bench_inputs as bi

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SECTIONS = ("lio", "lvi", "imu", "vio", "euroc", "full_scale", "loop")
# a section's expected wall on the card, s (`bench.py:1088-1123`): it runs
# only while the budget has that much left
SECTION_S = {"lvi": 300, "imu": 60, "vio": 120, "euroc": 240, "full_scale": 420, "loop": 360}
BA_BUDGET_ITERS, BA_BUDGET_S = 10, 0.035  # the reference estimator: 10 iterations / 35 ms
WARM_S = 2.0  # the fused sections' warm span
FULL_SCALE_S = 7.0  # the shipped-scale stream (`bench.py:644`)
LVI_SCENE = (0, 3.0, 30.0)  # config 5's world seed, figure-8 scale and period
FIXTURE_CAMERA = os.path.join(ROOT, "tests", "data", "fixture_camera.yaml")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated subset of " + ",".join(SECTIONS))
    ap.add_argument("--lio-warm", type=int, default=11)
    ap.add_argument("--lio-segment", type=int, default=40)
    ap.add_argument("--lio-segments", type=int, default=2)
    ap.add_argument("--lvi-seconds", type=float, default=12.0)
    ap.add_argument("--loop-seconds", type=float, default=38.0)
    ap.add_argument("--euroc-seconds", type=float, default=5.0)
    ap.add_argument("--reps", type=int, default=8, help="timed calls a try (imu, vio)")
    ap.add_argument("--workers", type=int, default=bi.STREAM_WORKERS,
                    help="raycasting processes (0: raycast inline)")
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("BENCH_WALL_BUDGET_S", "3000")))
    args = ap.parse_args(argv)
    args.sections = [s for s in args.sections.split(",") if s]
    bad = [s for s in args.sections if s not in SECTIONS]
    if bad:
        ap.error(f"unknown sections {bad}")
    return args


# ---------------------------------------------------------------------------
# Counting and timing
# ---------------------------------------------------------------------------

def counters() -> tuple:
    """(host syncs, K1, K2, K3, K4 launches) so far."""
    return (hostsync.COUNT, kt.LAUNCHES, gnp.LAUNCHES, clahe.HIST_LAUNCHES,
            clahe.APPLY_LAUNCHES)


@contextlib.contextmanager
def counted():
    """The host syncs and K1-K4 launches of the block, into the yielded
    dict (``host_syncs``, ``launches``)."""
    box: dict = {}
    c0 = counters()
    try:
        yield box
    finally:
        d = [b - a for a, b in zip(c0, counters())]
        box.update(host_syncs=d[0], launches=dict(zip(("K1", "K2", "K3", "K4"), d[1:])))


def per(box: dict, n: int) -> tuple:
    """A `counted` box's host syncs and launches over `n` units."""
    return (round(box["host_syncs"] / n, 3),
            {k: round(v / n, 3) for k, v in box["launches"].items()})


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def call_ms(fn, dev: torch.device, reps: int, tries: int = 3) -> tuple:
    """(ms a call, the counted box of one call): one warm call, then the
    fastest of `tries` runs of `reps` calls, each timed by CUDA events on a
    card (``device_timer``) or the host clock after the calls on the CPU."""
    fn()
    with counted() as box:
        fn()
    best = float("inf")
    for _ in range(tries):
        t: dict = {}
        with device_timer("t", t, device=dev if dev.type == "cuda" else None):
            for _ in range(reps):
                fn()
        best = min(best, t["t"])
    return best / reps * 1e3, box


def anchor(key: str) -> float:
    """A clean-CPU JAX reading of ``bench_anchors.json``."""
    with open(os.path.join(ROOT, "bench_anchors.json")) as f:
        return float(json.load(f)[key])


def pct(a: float, ref: float) -> float:
    """Signed: > 0 is worse than the reference (pass iff <= +5)."""
    return round(100.0 * (a - ref) / max(ref, 1e-9), 2)


# ---------------------------------------------------------------------------
# The run: its configurations, streams and record
# ---------------------------------------------------------------------------

class Run:
    """One bench run: the arguments, the device, the configurations each
    section runs (``configs``), the streams' parameters (``streams``), the
    raycasts in flight (``inputs``) and the record (``out``)."""

    def __init__(self, args, dev: torch.device, pool=None):
        self.args, self.dev, self.t0 = args, dev, time.perf_counter()
        self.out: dict = {}
        self.configs, self.streams = run_configs(args)
        self.inputs: dict = {}
        if "lio" in args.sections:
            self.inputs["lio"] = bi.Prefetch(pool, *bi.scan_jobs(self.streams["lio"]["scans"]))
        for name in ("lvi", "full_scale", "loop"):
            if name in args.sections:
                self.inputs[name] = bi.lvi_stream(pool, **self.streams[name])
        if "euroc" in args.sections:
            self.inputs["euroc"] = bi.Prefetch(pool, *bi.euroc_jobs(args.euroc_seconds))

    def wait_inputs(self) -> None:
        """Wait for every stream, so no raycast shares the host with a
        timed section; the wall budget counts from here."""
        for p in self.inputs.values():
            p.get()
        self.out["inputs_s"] = round(time.perf_counter() - self.t0, 1)
        self.t0 = time.perf_counter()

    def remaining(self) -> float:
        return self.args.budget - (time.perf_counter() - self.t0)

    def emit(self):
        print(json.dumps(self.out), flush=True)


def run_configs(args) -> tuple[dict, dict]:
    """(configurations, stream parameters) of the sections `args` asks for:
    what ``config_sha`` hashes."""
    from ..core.config import CameraIntrinsics
    from ..models.vio import feature_tracker as ft
    from ..scripts import run_euroc_vio

    cfgs, streams = {}, {}
    s = args.sections
    if "lio" in s:
        cfgs["lio"] = dataclasses.replace(bi.full_width_config(), upload_batch=bi.UPLOAD_BATCH)
        streams["lio"] = dict(scans=args.lio_warm + args.lio_segment * args.lio_segments,
                              scene=(0, 3.0, 40.0), horizon=6000, rate=bi.RATE,
                              warm=args.lio_warm, segment=args.lio_segment,
                              segments=args.lio_segments)
    if "lvi" in s:
        cfgs["lvi"] = dataclasses.replace(bi.lvi_parity_config(), replay_batch=bi.REPLAY_BATCH)
        streams["lvi"] = dict(duration=args.lvi_seconds)
    if "imu" in s:
        streams["imu"] = dict(seconds=60.0, hz=200, scene=(3.0, 40.0), gravity=9.805)
    if "vio" in s:
        cfgs["vio_ba"] = dataclasses.replace(vio_window(torch.device("cpu"))[1], solver="schur")
        cfgs["vio_tracker"] = ft.TrackerParams(max_cnt=150, min_dist=20)
        cfgs["vio_camera"] = CameraIntrinsics()
        streams["vio"] = dict(window=10, features=150, seed=0, image="576x1024",
                              depth_cloud=12 * 4096, reps=args.reps)
    if "euroc" in s:
        cfgs["euroc"] = run_euroc_vio.build_config(FIXTURE_CAMERA)
        streams["euroc"] = dict(seconds=args.euroc_seconds, scene=bi.EUROC_SCENE)
    if "full_scale" in s:
        cfgs["full_scale"] = dataclasses.replace(bi.lvi_full_config(),
                                                 replay_batch=bi.REPLAY_BATCH)
        streams["full_scale"] = dict(duration=FULL_SCALE_S, horizon=6000,
                                     cam=CameraIntrinsics())
    if "loop" in s:
        cfgs["loop"] = bi.lvi_loop_config(True)
        cfgs["noloop"] = bi.lvi_loop_config(False)
        streams["loop"] = dict(duration=args.loop_seconds)
    return cfgs, streams


def config_sha(configs: dict, streams: dict) -> str:
    """16 hex digits of sha256 over every field of every configuration
    (``anchors.config_fields``) and the streams' parameters."""
    text = json.dumps({"configs": {k: anchors.config_fields(v) for k, v in configs.items()},
                       "streams": anchors.config_fields(streams)}, sort_keys=True, default=repr)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def truth_positions(stamps, scene=LVI_SCENE) -> np.ndarray:
    from ..utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=scene[1], period=scene[2])
    return np.stack([traj.pose(np.array([t]))[0][0] for t in stamps])


def fused_run(cfg, data: dict, dev: torch.device, end_s: float):
    """A fused system through its entry points: `feed_*` of the first
    WARM_S, `run`, then the rest up to `end_s` timed. Returns (system, wall
    s, the counted box of the timed `run`)."""
    from ..models.pipeline import LviSystem
    from ..utils import synthetic as syn

    sys_ = LviSystem(cfg, device=dev)
    syn.feed_lvi(sys_, data, 0.0, WARM_S)
    sys_.run()
    syn.feed_lvi(sys_, data, WARM_S, end_s)
    sync(dev)
    with counted() as box:
        t0 = time.perf_counter()
        sys_.run()
        sync(dev)
        wall = time.perf_counter() - t0
    return sys_, wall, box


def fused_ate(sys_) -> float:
    est = np.stack([np.asarray(x6)[3:6] for _, x6 in sys_.trajectory]).astype(np.float64)
    return float(ate_rmse(est, truth_positions([t for t, _ in sys_.trajectory]), align=True))


def trajectory_sha(rows) -> str:
    return hashlib.sha256(np.ascontiguousarray(rows).tobytes()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# The sections
# ---------------------------------------------------------------------------

def lio_section(out: dict, scans, dev: torch.device, n_warm: int = 11, seg_len: int = 40,
                n_segs: int = 2) -> dict:
    """The headline (`bench.py:_replay`, `:1022-1069`): `full_width_config`
    at `upload_batch = 8` over `scans`, `n_warm` warm, then the fastest of
    `n_segs` segments of `seg_len`, each ending in a flush and a
    synchronize. Fills `out`; returns the run's (N, 6) trajectory, its
    uploads and its K1 / K2 launches (warm included)."""
    from ..models.lio.pipeline import LioPipeline

    cfg = dataclasses.replace(bi.full_width_config(), upload_batch=bi.UPLOAD_BATCH)
    scans = scans[:n_warm + seg_len * n_segs]
    k0 = (kt.LAUNCHES, gnp.LAUNCHES)
    pipe = LioPipeline(cfg, device=dev)
    for s in scans[:n_warm]:
        pipe.process_scan(s[0], s[1], s[2], s[3])
    pipe.flush()
    sync(dev)
    seg_s = []
    with counted() as box:
        for k in range(n_segs):
            a = n_warm + k * seg_len
            t0 = time.perf_counter()
            for s in scans[a:a + seg_len]:
                pipe.process_scan(s[0], s[1], s[2], s[3])
            pipe.flush()
            sync(dev)
            seg_s.append(time.perf_counter() - t0)
    traj = pipe.trajectory_array()
    per_scan = min(seg_s) / seg_len
    rtf = (1.0 / bi.RATE) / per_scan
    gt = np.stack([s[0]["true_pos"] for s in scans])
    ate = float(ate_rmse(traj[:, 3:6].astype(np.float64), gt, align=True))
    ref = anchor("ate_cpu_ref_m")
    syncs, launches = per(box, seg_len * n_segs)
    out.update({
        "metric": "lio_real_time_factor", "value": round(rtf, 2), "unit": "x_realtime",
        "per_scan_ms": round(per_scan * 1e3, 2), "ate_rmse_m": round(ate, 4),
        "scans": seg_len * n_segs, "backend": dev.type,
        "ate_cpu_ref_m": ref, "ate_vs_cpu_ref_pct": pct(ate, ref),
        "ate_cpu_ref_anchor": "bench_anchors.json:ate_cpu_ref_m",
        "per_scan_host_syncs": syncs, "per_scan_launches": launches,
        "lio_segment_ms": [round(1e3 * t / seg_len, 3) for t in seg_s],
        "lio_uploads": pipe.uploads, "lio_trajectory_sha256": trajectory_sha(traj),
    })
    return {"trajectory": traj, "uploads": pipe.uploads,
            "launches": {"K1": kt.LAUNCHES - k0[0], "K2": gnp.LAUNCHES - k0[1]}}


def lvi_section(out: dict, data: dict, dev: torch.device, seconds: float = 12.0):
    """Config 5 measured (`bench.py:_lvi_section`): the parity scale at
    `replay_batch = 16`, 2 s warm, the rest timed."""
    cfg = dataclasses.replace(bi.lvi_parity_config(), replay_batch=bi.REPLAY_BATCH)
    sys_, wall, box = fused_run(cfg, data, dev, seconds)
    ate = fused_ate(sys_)
    ref, exact = anchor("lvi_ate_cpu_ref_m"), anchor("lvi_ate_cpu_exact_m")
    out.update({
        "lvi_rtf_measured": round((seconds - WARM_S) / wall, 4), "lvi_wall_s": round(wall, 3),
        "lvi_host_syncs": box["host_syncs"], "lvi_launches": box["launches"],
        "lvi_ate_rmse_m": round(ate, 5), "lvi_vio_initialized": bool(sys_._vio_initialized),
        "lvi_replay_active": sys_._replay_statics is not None,
        "lvi_ate_cpu_ref_m": ref, "lvi_ate_vs_cpu_ref_pct": pct(ate, ref),
        "lvi_ate_cpu_ref_anchor": "bench_anchors.json:lvi_ate_cpu_ref_m",
        "lvi_ate_cpu_exact_m": exact, "lvi_knob_cost_pct": pct(ref, exact),
        "lvi_trajectory_sha256": trajectory_sha(
            np.stack([np.r_[t, np.asarray(x6)] for t, x6 in sys_.trajectory])),
    })


def imu_section(out: dict, dev: torch.device, reps: int = 4):
    """BASELINE config 1 (`bench.py:_imu_section`): one `navstate_predict`
    over the whole 60 s buffer."""
    from ..ops import preintegration as pre

    p0, q0, v0, dts, accs, gyrs, G = (torch.as_tensor(a, device=dev) for a in bi.imu_inputs())
    z3 = torch.zeros(3, device=dev)
    nav0 = pre.NavState(pos=p0, quat=q0, vel=v0, ba=z3, bg=z3)
    ms, box = call_ms(lambda: pre.navstate_predict(nav0, dts, accs, gyrs, G), dev, reps)
    out.update({"imu_dead_reckon_ms_per_60s": round(ms, 3),
                "imu_dead_reckon_rtf": round(60.0 / (ms / 1e3), 1),
                "imu_dead_reckon_host_syncs": box["host_syncs"],
                "imu_dead_reckon_launches": box["launches"]})


def vio_window(dev: torch.device):
    """`synthetic.consistent_window` at the reference shape (`bench.py:270`)."""
    from ..utils import synthetic as syn

    return syn.consistent_window(10, 150, seed=0, device=dev)


def tracker_inputs(dev: torch.device):
    """`bench.py:293-332`'s tracker and depth inputs, in its draw order:
    (params, camera, the seeded state, the image, depth arguments)."""
    from ..core.config import CameraIntrinsics
    from ..models.vio import feature_tracker as ft

    params = ft.TrackerParams(max_cnt=150, min_dist=20)
    cam = CameraIntrinsics()  # the shipped MEI 1024x576 rig
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.random((576, 1024)), dtype=torch.float32, device=dev)
    st = ft.tracker_init(576, 1024, params, device=dev)
    # a full live track set (an empty tracker measures KLT and RANSAC on
    # degenerate points)
    pts = np.stack([rng.uniform(20, 1004, params.max_cnt),
                    rng.uniform(20, 556, params.max_cnt)], -1)
    st = ft.seed_prev_image(st, img, params)._replace(
        pts=torch.as_tensor(pts, dtype=torch.float32, device=dev),
        ids=torch.arange(params.max_cnt, dtype=torch.int32, device=dev),
        track_cnt=torch.full((params.max_cnt,), 5, dtype=torch.int32, device=dev))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    norm = f32(rng.uniform(-0.5, 0.5, (params.max_cnt, 2)))
    cloud = f32(rng.uniform(-10, 10, (12 * 4096, 3)))
    depth = (norm, torch.ones(params.max_cnt, dtype=torch.bool, device=dev), cloud,
             torch.ones(12 * 4096, dtype=torch.bool, device=dev), torch.zeros(3, device=dev),
             f32([1.0, 0.0, 0.0, 0.0]))
    return params, cam, st, img, depth


def vio_section(out: dict, dev: torch.device, reps: int = 8):
    """The VIO hot ops at reference shapes (`bench.py:_vio_section`)."""
    from ..models.vio import feature_tracker as ft
    from ..ops import ba

    _, cfg, ws, pints, table, G = vio_window(dev)
    cfg = dataclasses.replace(cfg, solver="schur")
    fv = torch.ones(cfg.window + 1, dtype=torch.bool, device=dev)
    prior, td0 = ba.empty_prior(cfg, device=dev), torch.zeros((), device=dev)
    solve = lambda: ba.solve(ws, table.inv_depth, table.obs, table.vel, table.obs_valid,
                             table.start_frame, table.ids >= 0, table.lidar_flag, pints, fv,
                             prior, G, td0, cfg)
    iters = solve().iterations
    ba_ms, ba_box = call_ms(solve, dev, reps)
    ips = iters / (ba_ms / 1e3)
    params, cam, st, img, depth = tracker_inputs(dev)
    tr_ms, tr_box = call_ms(lambda: ft.tracker_step(st, img, 1.0, params, cam), dev, reps)
    dr_ms, dr_box = call_ms(lambda: ft.register_depth(*depth), dev, reps)
    out.update({
        "vio_ba_solve_ms": round(ba_ms, 3), "vio_ba_iterations": iters,
        "vio_ba_iters_per_sec": round(ips, 2),
        "vio_ba_vs_ref_budget": round((BA_BUDGET_ITERS / BA_BUDGET_S) / ips, 3),
        "vio_ba_host_syncs": ba_box["host_syncs"], "vio_ba_launches": ba_box["launches"],
        "tracker_step_ms": round(tr_ms, 3), "tracker_step_host_syncs": tr_box["host_syncs"],
        "tracker_step_launches": tr_box["launches"],
        "depth_reg_ms": round(dr_ms, 3), "depth_reg_host_syncs": dr_box["host_syncs"],
        "depth_reg_launches": dr_box["launches"],
    })


def euroc_section(out: dict, stream, dev: torch.device, seconds: float = 5.0):
    """BASELINE configs 2 / 4 end to end (`bench.py:_euroc_child`): the
    fixture written as a EuRoC folder, `run_euroc_vio` on it with the
    fixture's camera YAML."""
    from ..core.hostsync import host_bool, host_int
    from ..scripts import run_euroc_vio
    from ..utils import bag_writer

    imu_ts, w, f, img_ts, frames = stream
    with tempfile.TemporaryDirectory() as td:
        root, tum = os.path.join(td, "mav0"), os.path.join(td, "traj.tum")
        bag_writer.write_euroc(root, bi.EUROC_T0_NS, imu_ts, w, f, img_ts, frames)
        sync(dev)
        with counted() as box:
            t0 = time.perf_counter()
            runner = run_euroc_vio.main([root, "--camera-yaml", FIXTURE_CAMERA, "--max-seconds",
                                         str(seconds), "--out", tum, "--device", str(dev)])
            sync(dev)
            wall = time.perf_counter() - t0
        out.update({"vio_euroc_init": host_bool(runner.vio.initialized),
                    "vio_euroc_failures": host_int(runner.vio.failure_count),
                    "vio_euroc_wall_s": round(wall, 3), "vio_euroc_host_syncs": box["host_syncs"],
                    "vio_euroc_launches": box["launches"]})
        rows = np.loadtxt(tum, ndmin=2) if os.path.exists(tum) else np.zeros((0, 8))
    # bench.py leaves the ATE out under 10 TUM rows (the VIO never came up);
    # the record says so with null and the row count
    out["vio_euroc_trajectory_rows"] = len(rows)
    out["vio_euroc_ate_m"] = None
    if len(rows) >= 10:
        first = min(imu_ts[0], img_ts[0])  # the script's stamps start at the first message
        out["vio_euroc_ate_m"] = round(float(ate_rmse(
            rows[:, 1:4], truth_positions(rows[:, 0] + first, bi.EUROC_SCENE),
            align=True)), 4)


def full_scale_section(out: dict, data: dict, dev: torch.device, seconds: float = FULL_SCALE_S):
    """Config 5 at the shipped scale (`bench.py:_lvi_full_scale_section`):
    `lvi_full_config` at `replay_batch = 16`, 2 s warm, the rest timed."""
    cfg = dataclasses.replace(bi.lvi_full_config(), replay_batch=bi.REPLAY_BATCH)
    sys_, wall, box = fused_run(cfg, data, dev, seconds)
    out.update({
        "lvi_full_scale_rtf": round((seconds - WARM_S) / wall, 4),
        "lvi_full_scale_wall_s": round(wall, 3),
        "lvi_full_scale_host_syncs": box["host_syncs"],
        "lvi_full_scale_launches": box["launches"],
        "lvi_full_scale_ate_m": round(fused_ate(sys_), 5),
        "lvi_full_scale_vio_init": bool(sys_._vio_initialized),
        "lvi_full_scale_loops": int(sys_.lio.state.n_loops),
    })


def loop_arm(data: dict, dev: torch.device, seconds: float, loop_on: bool) -> dict:
    """One arm of `bench.py:_lvi_loop_section`: online ATE, the keyframe
    ATE (the poses loop factors rewrite), the loop count, wall and counts."""
    sys_, wall, box = fused_run(bi.lvi_loop_config(loop_on), data, dev, seconds)
    st = sys_.lio.state
    n_kf = int(st.kf_count)
    kf_p = st.kf_trans[:n_kf].cpu().numpy().astype(np.float64)
    kf_ate = float(ate_rmse(kf_p, truth_positions(st.kf_time[:n_kf].cpu().numpy()), align=True))
    return dict(loops=int(st.n_loops), ate=fused_ate(sys_), kf_ate=kf_ate, wall=wall, box=box)


def loop_section(out: dict, data: dict, dev: torch.device, seconds: float, remaining):
    """Loop fusion in a measured replay (`bench.py:_lvi_loop_section`); the
    no-loop arm runs while `remaining()` leaves 2.5 x the first arm's wall
    (at least 180 s)."""
    arm = loop_arm(data, dev, seconds, True)
    out.update({"lvi_loop_count": arm["loops"], "lvi_loop_ate_m": round(arm["ate"], 5),
                "lvi_loop_kf_ate_m": round(arm["kf_ate"], 5),
                "lvi_loop_rtf": round((seconds - WARM_S) / arm["wall"], 4),
                "lvi_loop_wall_s": round(arm["wall"], 3),
                "lvi_loop_host_syncs": arm["box"]["host_syncs"],
                "lvi_loop_launches": arm["box"]["launches"]})
    need = max(2.5 * arm["wall"], 180.0)
    if remaining() < need:
        out["lvi_noloop_skipped"] = f"budget({int(remaining())}s<{int(need)}s)"
        return
    noloop = loop_arm(data, dev, seconds, False)
    out["lvi_noloop_kf_ate_m"] = round(noloop["kf_ate"], 5)
    out["lvi_loop_kf_ate_delta_m"] = round(noloop["kf_ate"] - arm["kf_ate"], 5)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def section(run: Run, name: str, fn) -> None:
    """Run one section unless the budget is short; record a failure as
    `<name>_error`; re-emit the record."""
    if name != "lio" and run.remaining() < SECTION_S[name]:
        run.out[name + "_skipped"] = f"budget({int(run.remaining())}s<{SECTION_S[name]}s)"
    else:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # the record names it and the exit code reports it
            import traceback

            traceback.print_exc()
            run.out[name + "_error"] = repr(e)[:200]
        run.out[name + "_section_s"] = round(time.perf_counter() - t0, 1)
    run.emit()


def execute(run: Run) -> dict:
    """Every requested section in order; returns the record."""
    a, dev, out = run.args, run.dev, run.out
    want = set(a.sections)
    steps = [
        ("lio", lambda: lio_section(out, run.inputs["lio"].get(), dev, a.lio_warm,
                                    a.lio_segment, a.lio_segments)),
        ("lvi", lambda: lvi_section(out, run.inputs["lvi"].get(), dev, a.lvi_seconds)),
        ("imu", lambda: imu_section(out, dev, reps=max(1, a.reps // 2))),
        ("vio", lambda: vio_section(out, dev, a.reps)),
        ("euroc", lambda: euroc_section(out, run.inputs["euroc"].get(), dev, a.euroc_seconds)),
        ("full_scale", lambda: full_scale_section(out, run.inputs["full_scale"].get(), dev)),
        ("loop", lambda: loop_section(out, run.inputs["loop"].get(), dev, a.loop_seconds,
                                      run.remaining)),
    ]
    for name, fn in steps:
        if name in want:
            section(run, name, fn)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve(args.device)
    if dev.type == "cuda":
        torch.use_deterministic_algorithms(True)
    pool = bi.stream_pool(args.workers) if args.workers > 0 else None
    try:
        run = Run(args, dev, pool)
        run.out.update(config_sha=config_sha(run.configs, run.streams),
                       device=(torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"))
        run.wait_inputs()
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    execute(run)
    run.emit()
    return 1 if any(k.endswith("_error") for k in run.out) else 0


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.exit(main())
