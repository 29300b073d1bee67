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

Then one JSON line of kernel records, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
There is no CPU path: without a GPU the script fails.

``python3 chip_smoke.py --profile N`` adds a torch.profiler trace of N
steady scans (device busy share, device time by kernel) before the result.
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
    if "--profile" in sys.argv:
        profile_steady(cfg, scans, dev, int(sys.argv[sys.argv.index("--profile") + 1]))

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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
