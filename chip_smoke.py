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
5. CLAHE kernels K3 (tile_hist) and K4 (apply_cdf) from
   ``lvislam_tpu_torch/csrc/clahe.cu`` against their plain versions, bit for
   bit, on a rendered MEI 576x1024 frame and a uniform-random image (the
   vector kernels) and on the frame cropped to 571x1021 (the general
   kernels), with CUDA-event timings of both.
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
   constant frame.

Then one JSON line of kernel records, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
There is no CPU path: without a GPU the script fails.

``python3 chip_smoke.py --profile N`` adds torch.profiler traces of N
steady scans and N steady tracker frames (device busy share, device time
by kernel; K1-K4's launches and device time a scan or frame) before the
result. ``--sweep`` adds to phase 8 the launch sizes beside the wrappers'
own: K3 at 1 to 8 slabs a tile, K4 at 9 to 36 rows a block, and both general
kernels.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# cuBLAS needs a fixed workspace for deterministic mode
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = os.path.dirname(os.path.abspath(__file__))

ATE_LIMIT_PCT = 5.0  # BASELINE criterion: not more than 5% worse than the anchor
N_SCANS, N_WARM, RATE = 91, 11, 10.0
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
# K2's f32 operations a point, counted by hand from csrc/gn_partials.cu
# (transform, gate, mean, scatter, eigensystem, 1 or 2 eigenvectors, plane
# or line coefficients, J row, 27 partials, the block tree)
K2_FLOPS_PER_POINT = {"corner": 450, "surf": 600}


def log(phase: str, **kw):
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


def full_width_config():
    """The bench's LIO configuration (`bench.py:_make_cfg`) with both
    kernels on."""
    from lvislam_tpu_torch.models.lio import mapping
    from lvislam_tpu_torch.models.lio.pipeline import LioConfig

    caps = mapping.LioCaps(
        max_keyframes=256, kf_corner=512, kf_surf=2048, sel_keyframes=32,
        map_corner=16384, map_surf=65536, scan_corner=512, scan_surf=2048,
        max_loops=16, max_gps=16, loop_submap=8192, icp_iters=20,
        pallas_knn=True, pallas_gn=True,
    )
    return LioConfig(
        n_scan=4, horizon=6000, point_capacity=24576, caps=caps,
        params=mapping.LioParams(nnRefreshEvery=2, mapRebuildEvery=8,
                                 gatherOncePerScan=True),
        loop_every_n_scans=10,
    )


def gen_scans():
    """The bench's 91 scans (`bench.py:_gen_scans`, `_lio_scans_data`)."""
    import numpy as np
    from scipy.spatial.transform import Rotation as Rsc

    from lvislam_tpu_torch.utils import synthetic as syn

    world = syn.default_world(seed=0)
    traj = syn.figure8_trajectory(scale=3.0, period=40.0)
    scans = []
    for i in range(N_SCANS):
        ts = i / RATE
        scan = syn.simulate_lidar_scan(world, traj, ts, n_scan=4, horizon=6000,
                                       sweep_time=1.0 / RATE)
        it = np.arange(ts - 0.005, ts + 1.0 / RATE + 0.01, 1.0 / 200.0)
        w, _ = traj.imu(it)
        _, R = traj.pose(np.array([ts]))
        rpy = Rsc.from_matrix(R[0]).as_euler("ZYX")[::-1]
        scans.append((scan, (it - ts).astype(np.float32), w.astype(np.float32),
                      np.array(rpy, np.float32)))
    return scans


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
    # and a `lio.*` range's device row spans the kernels inside it)
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and not e.key.startswith("lio.")]
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

    def report(name, us, n_bytes, n_flops, shape):
        b, by = bound_us(n_bytes, n_flops)
        rec[name] = {"kernel_us": us, "bound_us": b, "bound_by": by, "bound_share": b / us,
                     "library_ms": None}
        log("alone", kernel=name, shape=shape, kernel_us=round(us, 3), bound_us=round(b, 4),
            bound_by=by, bound_share=round(b / us, 4), MB=round(n_bytes / 1e6, 3))

    # ---- K1: the pair launch, each query set alone, and one query (the
    # launch's latency floor) ----
    k = 5

    def k1_set(cand, want, off, B):
        Q = cand.shape[0]
        outs = (torch.empty((Q, k), device=dev), torch.empty((Q, k), dtype=torch.int32, device=dev))
        n_bytes = nbytes((cand, want, off, *outs))
        return {"Q": Q, "B": B, "outs": outs, "bytes": n_bytes,
                "flops": Q * 27 * B * 8,  # 3 offset adds, 3 squares, 2 adds a candidate
                "inputs": (cand, want, off), "copies": cold_copies((cand, want, off), n_bytes)}

    def k1_launch(pair):  # (corner set, surf set), None for an empty one
        def launch(i, stream):
            args = []
            for s in pair:
                if s is None:
                    args += [None] * 5 + [0, 0]
                    continue
                c, w, o = s["copies"][i % len(s["copies"])]
                args += [c.data_ptr(), w.data_ptr(), o.data_ptr(), s["outs"][0].data_ptr(),
                         s["outs"][1].data_ptr(), s["Q"], s["B"]]
            _kernels.check(lib.lvt_knn_tail_pair(*args, k, stream), "lvt_knn_tail_pair")
        return launch

    k1 = [k1_set(*s) for s in sets]
    one = k1_set(*(t[:1] for t in sets[0][:3]), sets[0][3])
    for name, pair in (("K1_corner", (k1[0], None)), ("K1_surf", (None, k1[1])),
                       ("K1_pair", k1), ("K1_one_query", (one, None))):
        used = [s for s in pair if s is not None]
        report(name, graph_us(k1_launch(pair)), sum(s["bytes"] for s in used),
               sum(s["flops"] for s in used), ",".join(f"Q={s['Q']},B={s['B']}" for s in used))
    # the library yardstick for K1's selection half: torch.topk on the
    # precomputed masked distances (the port never calls it)
    lib_ms = 0.0
    for s in k1:
        (c, w, o), Q, B = s["inputs"], s["Q"], s["B"]
        cc, oo = c.reshape(Q, 27, 4, B), o.reshape(Q, 3, 27)
        d = sum((cc[:, :, i, :].float() + oo[:, i, :, None]) ** 2 for i in range(3))
        d = torch.where(cc[:, :, 3, :].int() == w[:, :, None], d, 1e10).reshape(Q, 27 * B)
        lib_ms += cuda_ms(lambda d=d: torch.topk(d, k, dim=1, largest=False))
    rec["K1_pair"]["library_ms"] = lib_ms

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


def clahe_alone(frame, dev, report, sweep: bool):
    """Phase 8 for K3 and K4: the raw entry points on the rendered `frame`
    as the wrappers launch them (cold in L2), on the smallest image the
    vector kernels take (8x8 in one tile: the launches' fixed cost), and K3
    on a constant frame (every lane of a warp on one shared-memory counter).
    Every timed launch's result must equal the plain version's. With
    `sweep`, also K3 at other slab counts and K4 at other rows a block
    (0: the general kernels), on the rendered frame."""
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

    def k4(imgs, tiles, rows):
        H, W = imgs[0].shape
        cdf = imops.clip_cdf(clahe.tile_hist_plain(imgs[0], tiles), (H // tiles) * (W // tiles))
        res = torch.empty_like(imgs[0])
        us = graph_us(lambda i, s: _kernels.check(lib.lvt_clahe_apply(
            imgs[i % len(imgs)].data_ptr(), cdf.data_ptr(), res.data_ptr(), H, W, tiles, 256,
            rows, s), "lvt_clahe_apply"))
        if not torch.equal(res, clahe.apply_cdf_plain(imgs[0], cdf, tiles)):
            raise AssertionError(f"K4 rows={rows} on {H}x{W}: pixels differ")
        return us, nbytes((imgs[0], cdf, res)), 12 * H * W

    img0 = torch.as_tensor(frame, device=dev)
    H, W = img0.shape
    imgs = [c[0] for c in cold_copies([img0], H * W * 4)]
    slabs = clahe.hist_slabs(H // 8, 8, n_sm)
    flat = [torch.full_like(img0, 0.5)] * 2
    tiny = [torch.rand((8, 8), device=dev)] * 2
    report("K3", *k3(imgs, 8, slabs), f"{H}x{W},slabs={slabs}")
    report("K3_constant", *k3(flat, 8, slabs), f"{H}x{W},slabs={slabs}")
    report("K3_floor", *k3(tiny, 1, clahe.hist_slabs(8, 1, n_sm)), "8x8,tiles=1")
    report("K4", *k4(imgs, 8, clahe.APPLY_ROWS), f"{H}x{W},rows={clahe.APPLY_ROWS}")
    report("K4_floor", *k4(tiny, 1, clahe.APPLY_ROWS), "8x8,tiles=1")
    if not sweep:
        return
    for n in (0, 1, 2, 4, 8):
        report(f"K3_slabs{n}", *k3(imgs, 8, n), f"{H}x{W}")
    for rows in (0, 9, 12, 16, 18, 24, 32, 36):
        report(f"K4_rows{rows}", *k4(imgs, 8, rows), f"{H}x{W}")


def tracker_frames():
    """The MEI 1024x576 rig's frames of the LIO replay's world and
    trajectory at t = 0.1 + i/10, quantized to 8 bits and back as the
    system's frame packer does (`frame_step.py:72,139`). Returns (camera,
    world, trajectory, stamps, frames as (H, W) float32 arrays)."""
    import numpy as np

    from lvislam_tpu_torch.core.config import CameraIntrinsics
    from lvislam_tpu_torch.utils import synthetic as syn

    cam = CameraIntrinsics()
    world = syn.default_world(seed=0)
    traj = syn.figure8_trajectory(scale=3.0, period=40.0)
    ts = [0.1 + i / RATE for i in range(N_FRAMES)]
    frames = []
    for t in ts:
        img = syn.render_camera_image(world, traj, t, cam=cam)
        u8 = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        frames.append(u8.astype(np.float32) * np.float32(1.0 / 255.0))
    return cam, world, traj, ts, frames


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


def check_clahe_kernels(frame, dev):
    """K3 and K4 against their plain versions, bit for bit: on a rendered
    frame and a uniform-random image at the rig's 576x1024 (the vector
    kernels), and on the rendered frame cropped to 571x1021 (the general
    kernels)."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.ops import clahe
    from lvislam_tpu_torch.ops import image as imops

    rng = np.random.default_rng(0)
    imgs = {"rendered": torch.as_tensor(frame, device=dev),
            "uniform": torch.as_tensor(rng.random(frame.shape, dtype=np.float32), device=dev),
            "cropped": torch.as_tensor(frame[:-5, :-3].copy(), device=dev)}
    res = {}
    for name, img in imgs.items():
        H, W = img.shape
        h1 = clahe.tile_hist(img)
        h0 = clahe.tile_hist_plain(img)
        cdf = imops.clip_cdf(h0, (H // 8) * (W // 8))
        o1 = clahe.apply_cdf(img, cdf)
        o0 = clahe.apply_cdf_plain(img, cdf)
        torch.cuda.synchronize()
        paths = (clahe.hist_path(H, W, 8, img.data_ptr()),
                 clahe.apply_path(H, W, 8, 256, img.data_ptr(), cdf.data_ptr()))
        if paths != (("general",) * 2 if name == "cropped" else ("vector",) * 2):
            raise AssertionError(f"K3/K4 {name}: {H}x{W} took the {paths} kernels")
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
    import numpy as np

    import lvislam_tpu_torch  # noqa: F401  (full-f32 math settings)
    from lvislam_tpu_torch.ops import _kernels
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import knn_tail as kt
    from lvislam_tpu_torch.utils.metrics import ate_rmse

    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
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
    t0 = time.perf_counter()
    scans = gen_scans()
    log("scans", n=len(scans), gen_seconds=round(time.perf_counter() - t0, 1))
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
    n_prof = int(sys.argv[sys.argv.index("--profile") + 1]) if "--profile" in sys.argv else 0
    if n_prof:
        profile_steady(cfg, scans, dev, n_prof)

    # ---- 5. CLAHE kernels at the rig's shape ----
    from lvislam_tpu_torch.ops import clahe
    from lvislam_tpu_torch.utils.anchors import TRACKER_SEQUENCE as ref

    t0 = time.perf_counter()
    cam, world, traj, ts, frames = tracker_frames()
    log("frames", n=len(frames), shape=f"{frames[0].shape[0]}x{frames[0].shape[1]}",
        model=cam.model_type, gen_seconds=round(time.perf_counter() - t0, 1))
    k34 = check_clahe_kernels(frames[0], dev)

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

    def timing(key):
        a = alone[key]
        return {"bound_ms": a["bound_us"] / 1e3, "bound_by": a["bound_by"],
                "library_ms": a["library_ms"], "kernel_us": a["kernel_us"],
                "bound_us": a["bound_us"], "bound_share": a["bound_share"]}

    kernels = [
        {"name": "knn_tail", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/knn_tail.cu",
         "replaces": "lvislam_tpu/ops/pallas_knn.py:79",
         "launches": launches["K1"], "max_abs_err": e1,
         "ms": m1, "plain_ms": p1, **timing("K1_pair"),
         "library": "torch.topk(d, 5, largest=False) on the masked distances: "
                    "the selection half only"},
        {"name": "gn_partials", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/gn_partials.cu",
         "replaces": "lvislam_tpu/ops/pallas_gn.py:369",
         "launches": launches["K2"], "max_abs_err": e2,
         "ms": m2, "plain_ms": p2, **timing("K2_pair")},
        {"name": "tile_hist", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/clahe.cu",
         "replaces": "lvislam_tpu/ops/pallas_clahe.py:53",
         "launches": launches["K3"], "max_abs_err": max(r[0] for r in k34.values()),
         "ms": k34["rendered"][2]["K3"], "plain_ms": k34["rendered"][2]["K3_plain"],
         **timing("K3")},
        {"name": "apply_cdf", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/clahe.cu",
         "replaces": "lvislam_tpu/ops/pallas_clahe.py:98",
         "launches": launches["K4"], "max_abs_err": max(r[1] for r in k34.values()),
         "ms": k34["rendered"][2]["K4"], "plain_ms": k34["rendered"][2]["K4_plain"],
         **timing("K4")},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
