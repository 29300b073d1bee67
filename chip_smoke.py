#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``lvislam_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases, one line each:

0. device: the card's name and power limit (nvidia-smi); deterministic mode.
1. build: compile kernels K1 (knn_tail) and K2 (gn_partials) from
   ``lvislam_tpu_torch/csrc`` with nvcc for sm_90a.
2. parity: each kernel against its plain PyTorch version at the LIO step's
   shapes (a voxel hash over 16384 corner + 65536 surf map points; 512
   corner and 2048 surf queries), with CUDA-event timings of both.
3. replay: the bench's 91-scan synthetic LIO sequence through
   ``LioPipeline`` at full width with both kernels on; ATE against the
   clean-CPU anchor in ``bench_anchors.json``, steady per-scan ms, host
   syncs per scan, keyframes, kernel launch counts.
4. determinism: a second replay must reproduce the trajectory bit for bit.
5. CLAHE kernels K3 (tile_hist) and K4 (apply_cdf) from
   ``lvislam_tpu_torch/csrc/clahe.cu`` against their plain versions on a
   rendered MEI 576x1024 frame and on a uniform-random image, with
   CUDA-event timings of both.
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

Then one JSON line of kernel records, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
There is no CPU path: without a GPU the script fails.

``python3 chip_smoke.py --profile N`` adds torch.profiler traces of N
steady scans and N steady tracker frames (device busy share, device time
by kernel) before the result.
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


def log(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


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


def check_knn_tail(h, q, name):
    import torch

    from lvislam_tpu_torch.ops import knn_tail as kt
    from lvislam_tpu_torch.ops import voxel_hash as vh

    B = h.rel.shape[2]
    g = vh.query_gather(h, q)
    q_s = q * (vh._QUANT / h.cell)
    off = (g.corner_s - q_s[:, None, :]).permute(0, 2, 1).reshape(q.shape[0], 81).contiguous()
    d1, p1 = kt.knn_tail(g.cand, g.want_tag, off, bucket=B, k=5)
    d0, p0 = kt.knn_tail_plain(g.cand, g.want_tag, off, bucket=B, k=5)
    torch.cuda.synchronize()
    if not torch.equal(p1, p0):
        raise AssertionError(f"K1 {name}: positions differ at "
                             f"{int((p1 != p0).sum())} of {p1.numel()}")
    torch.testing.assert_close(d1, d0, rtol=1e-6, atol=0.0)
    err = float((d1 - d0).abs().max())
    ms = cuda_ms(lambda: kt.knn_tail(g.cand, g.want_tag, off, bucket=B, k=5))
    plain_ms = cuda_ms(lambda: kt.knn_tail_plain(g.cand, g.want_tag, off, bucket=B, k=5))
    found = float((d0 < 1e9).float().mean())
    log("parity", kernel="K1", shape=f"{name}:Q={q.shape[0]},B={B}", positions="identical",
        max_abs_err=err, found_frac=round(found, 4), ms=round(ms, 4),
        plain_ms=round(plain_ms, 4))
    return err, ms, plain_ms


def check_gn_partials(h, map_pts, q_world, x6, kind):
    import torch

    from lvislam_tpu_torch.core import lie
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import scan2map
    from lvislam_tpu_torch.ops import voxel_hash as vh

    R = lie.x6_rotation(x6)
    t = x6[3:6]
    q_lidar = (q_world - t) @ R  # R^T (p - t)
    valid = torch.ones(q_lidar.shape[0], dtype=torch.bool, device=q_lidar.device)
    pw = scan2map.apply_pose(R, t, q_lidar)
    idx, _ = vh.query(h, pw, 5)
    nbrs = map_pts[torch.clamp(idx, min=0).long()]
    pts_blk = gnp.pack_pts(q_lidar, valid)
    nbr_blk = gnp.pack_nbrs(nbrs, idx >= 0)
    par = gnp.pack_pose(R, t, scan2map._euler_jac_mats(x6))
    H1, g1, n1 = gnp.gn_partials(pts_blk, nbr_blk, par, kind)
    H0, g0, n0 = gnp.gn_partials_plain(pts_blk, nbr_blk, par, kind)
    torch.cuda.synchronize()
    if int(n1) != int(n0):
        raise AssertionError(f"K2 {kind}: n_res {int(n1)} vs plain {int(n0)}")
    hs = max(float(H0.abs().max()), 1e-6)
    gs = max(float(g0.abs().max()), 1e-6)
    torch.testing.assert_close(H1, H0, atol=2e-4 * hs, rtol=2e-4)
    torch.testing.assert_close(g1, g0, atol=2e-4 * gs, rtol=2e-4)
    err = max(float((H1 - H0).abs().max()), float((g1 - g0).abs().max()))
    ms = cuda_ms(lambda: gnp.gn_partials(pts_blk, nbr_blk, par, kind))
    plain_ms = cuda_ms(lambda: gnp.gn_partials_plain(pts_blk, nbr_blk, par, kind))
    log("parity", kernel="K2", shape=f"{kind}:N={q_lidar.shape[0]}", n_res=int(n1),
        max_abs_err=err, H_scale=hs, ms=round(ms, 4), plain_ms=round(plain_ms, 4))
    return err, ms, plain_ms


def replay(cfg, scans, dev):
    """One full replay through LioPipeline; returns (trajectory (N,6),
    per-scan seconds, host syncs per scan, keyframes)."""
    import torch

    from lvislam_tpu_torch.core import hostsync
    from lvislam_tpu_torch.models.lio.pipeline import LioPipeline

    pipe = LioPipeline(cfg, device=dev)
    torch.cuda.synchronize()
    times, syncs = [], []
    for s in scans:
        hostsync.reset()
        t0 = time.perf_counter()
        pipe.process_scan(s[0], s[1], s[2], s[3])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        syncs.append(hostsync.COUNT)
    return pipe.trajectory_array(), times, syncs, int(pipe.state.kf_count)


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in scans[N_WARM:N_WARM + n_prof]:
            pipe.process_scan(s[0], s[1], s[2], s[3])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
    for name in ("knn_tail_kernel", "gn_partials_kernel"):
        us = sum(r[1] for r in rows if name in r[0])
        cnt = sum(r[2] for r in rows if name in r[0])
        log("profile", kernel=name, launches_per_scan=round(cnt / n_prof, 2),
            device_us_per_launch=round(us / max(cnt, 1), 2),
            device_ms_per_scan=round(us / n_prof / 1e3, 4))


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
    """K3 and K4 against their plain versions on a rendered frame and a
    uniform-random image at the rig's 576x1024."""
    import numpy as np
    import torch

    from lvislam_tpu_torch.ops import clahe
    from lvislam_tpu_torch.ops import image as imops

    rng = np.random.default_rng(0)
    imgs = {"rendered": torch.as_tensor(frame, device=dev),
            "uniform": torch.as_tensor(rng.random(frame.shape, dtype=np.float32), device=dev)}
    res = {}
    for name, img in imgs.items():
        H, W = img.shape
        h1 = clahe.tile_hist(img)
        h0 = clahe.tile_hist_plain(img)
        cdf = imops.clip_cdf(h0, (H // 8) * (W // 8))
        o1 = clahe.apply_cdf(img, cdf)
        o0 = clahe.apply_cdf_plain(img, cdf)
        torch.cuda.synchronize()
        if not torch.equal(h1, h0):
            raise AssertionError(f"K3 {name}: counts differ in "
                                 f"{int((h1 != h0).sum())} of {h1.numel()} bins")
        if int(h1.sum()) != (H // 8) * (W // 8) * 64:
            raise AssertionError(f"K3 {name}: {int(h1.sum())} pixels counted")
        e3 = float((h1 - h0).abs().max())
        e4 = float((o1 - o0).abs().max())
        if not e4 <= 1e-6:
            raise AssertionError(f"K4 {name}: max abs err {e4} > 1e-6")
        t = {"K3": cuda_ms(lambda: clahe.tile_hist(img)),
             "K3_plain": cuda_ms(lambda: clahe.tile_hist_plain(img)),
             "K4": cuda_ms(lambda: clahe.apply_cdf(img, cdf)),
             "K4_plain": cuda_ms(lambda: clahe.apply_cdf_plain(img, cdf))}
        log("parity", kernels="K3,K4", image=f"{name}:{H}x{W}", K3_counts="identical",
            K4_max_abs_err=e4, **{f"{k}_ms": round(v, 4) for k, v in t.items()})
        res[name] = (e3, e4, t)
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
    e1c, m1c, p1c = check_knn_tail(h_c, q_c, "corner")
    e1s, m1s, p1s = check_knn_tail(h_s, q_s, "surf")
    e2c, m2c, p2c = check_gn_partials(h_c, corner, q_c, x6, "corner")
    e2s, m2s, p2s = check_gn_partials(h_s, surf, q_s, x6, "surf")

    # ---- 3. full-width replay through the port's entry point ----
    t0 = time.perf_counter()
    scans = gen_scans()
    log("scans", n=len(scans), gen_seconds=round(time.perf_counter() - t0, 1))
    gt = np.stack([s[0]["true_pos"] for s in scans])
    cfg = full_width_config()
    kt.LAUNCHES = 0
    gnp.LAUNCHES = 0
    traj1, times, syncs, n_kf = replay(cfg, scans, dev)
    launches = {"K1": kt.LAUNCHES, "K2": gnp.LAUNCHES}
    if traj1.shape != (N_SCANS, 6) or not np.isfinite(traj1).all():
        raise AssertionError(f"replay: bad trajectory {traj1.shape}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"replay: a kernel was never launched {launches}")
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
        host_syncs_max=max(syncs), keyframes=n_kf,
        launches_K1=launches["K1"], launches_K2=launches["K2"])
    if pct > ATE_LIMIT_PCT:
        raise AssertionError(f"replay: ATE {ate:.4f} m is {pct:+.2f}% vs the "
                             f"anchor {ate_ref} m (limit +{ATE_LIMIT_PCT}%)")

    # ---- 4. determinism ----
    traj2, _, _, _ = replay(cfg, scans, dev)
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
        launches_K3=launches["K3"], launches_K4=launches["K4"])
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

    kernels = [
        {"name": "knn_tail", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/knn_tail.cu",
         "replaces": "lvislam_tpu/ops/pallas_knn.py:79",
         "launches": launches["K1"], "max_abs_err": max(e1c, e1s),
         "ms": m1c + m1s, "plain_ms": p1c + p1s},
        {"name": "gn_partials", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/gn_partials.cu",
         "replaces": "lvislam_tpu/ops/pallas_gn.py:369",
         "launches": launches["K2"], "max_abs_err": max(e2c, e2s),
         "ms": m2c + m2s, "plain_ms": p2c + p2s},
        {"name": "tile_hist", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/clahe.cu",
         "replaces": "lvislam_tpu/ops/pallas_clahe.py:53",
         "launches": launches["K3"], "max_abs_err": max(r[0] for r in k34.values()),
         "ms": k34["rendered"][2]["K3"], "plain_ms": k34["rendered"][2]["K3_plain"]},
        {"name": "apply_cdf", "route": "cuda",
         "source": "lvislam_tpu_torch/csrc/clahe.cu",
         "replaces": "lvislam_tpu/ops/pallas_clahe.py:98",
         "launches": launches["K4"], "max_abs_err": max(r[1] for r in k34.values()),
         "ms": k34["rendered"][2]["K4"], "plain_ms": k34["rendered"][2]["K4_plain"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
