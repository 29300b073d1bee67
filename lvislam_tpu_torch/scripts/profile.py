"""Profiling of the port's hot paths: the port of ``scripts/profile.py``,
with ``scripts/frame_breakdown.py`` folded into ``replay``.

Usage:
  python -m lvislam_tpu_torch.scripts.profile stages [--warm 12] [--reps 5]
  python -m lvislam_tpu_torch.scripts.profile replay [--seconds 4] [--batch 4] [--reps 2]
  python -m lvislam_tpu_torch.scripts.profile transport [--scans 75] [--warm 11]
  python -m lvislam_tpu_torch.scripts.profile query [--queries 2048] [--points 65536]

each with ``--device cpu`` to run on the CPU (the card otherwise; without
one it raises). Every subcommand prints one JSON line an item and a summary
line last.

- ``stages``: the warm LIO step at the bench's 4 x 6000 (``full_width_config``,
  the stream of ``bench_inputs.scan_jobs``, `--warm` scans in): the whole
  step at a non-keyframe stamp, at a keyframe stamp with the incremental map
  update and with the full rebuild, and its stages alone on the same
  inputs: unpack, project, features, downsample, GN
  (``scan_to_map_hashed``) and ``map_step`` of the three kinds. The summary
  holds unpack + project + features + ``map_step`` (non-keyframe) against
  the whole step.
- ``replay``: ``replay_batch_step`` of a batch of no-op, scan, frame and
  mixed rows staged by ``LviSystem`` at the parity configuration with
  ``replay_batch`` = `--batch` (fed `--seconds`, the replay active), the
  batch's upload and the outputs' readback; then the frame branch's parts
  alone at that configuration (``frame_breakdown.py``): tracker, depth
  registration, BA ("schur"), triangulation, marginalization and
  ``process_imu``. A scan event launches ~31k kernels and a frame event
  more, so the default batch is 4 (the bench's 16 gives the same numbers an
  event) and the profiler traces one call of each.
- ``transport``: the LIO replay at ``upload_batch = 8`` over `--scans`:
  host ms a scan of ``pack_scan``, the batch upload and the batch's steps
  (dispatch), against the wall and the device time a scan.
- ``query``: K1's wrapper (``knn_tail``), its plain version and
  ``torch.topk`` on the same masked distances, over a voxel hash of
  `--points` random map points and `--queries` queries (T = 2^16, B = 16):
  each one's time and whether the three select the same neighbours. (The
  fused gather + score form of the JAX script's variants has no kernel.)

An item's ``ms`` is the time a call by CUDA events on the card (the host
clock on the CPU); ``device_ms`` and ``kernels`` are torch.profiler's sum of
device kernel time and its kernel count a call (``null`` on the CPU: no
device time is measured there); ``host_syncs`` counts
``core/hostsync`` reads a call.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..core import hostsync
from ..core.device import resolve
from ..utils.profiling import device_timer
from . import bench_inputs as bi


# the port's `record_function` ranges (the fused system's spans): their
# device rows span kernels
RANGES = ("lio.", "lvi.", "vio.", "loop.", "host.")


def kernel_rows(prof) -> list:
    """torch.profiler's device rows of kernels (and copies) with time: the
    rows of the port's ranges are left out, since each spans the kernels
    inside it, gaps included."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith(RANGES)]


def measure(fn, dev: torch.device, reps: int, prof_reps: int | None = None) -> dict:
    """One warm call, then `reps` calls timed (CUDA events on a card, the
    host clock on the CPU) and, on a card, `prof_reps` (default `reps`)
    more under torch.profiler for the device kernel time and count.
    Returns the per-call numbers."""
    prof_reps = reps if prof_reps is None else prof_reps
    fn()
    cuda = dev.type == "cuda"
    h0 = hostsync.COUNT
    t: dict = {}
    with device_timer("t", t, device=dev if cuda else None):
        for _ in range(reps):
            fn()
    rec = {"ms": t["t"] * 1e3 / reps, "host_syncs": (hostsync.COUNT - h0) / reps,
           "device_ms": None, "kernels": None}
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(prof_reps):
                fn()
            torch.cuda.synchronize(dev)
        rows = kernel_rows(prof)
        rec["device_ms"] = sum(e.self_device_time_total for e in rows) / prof_reps / 1e3
        rec["kernels"] = sum(e.count for e in rows) / prof_reps
    return rec


def emit(cmd: str, item: str, rec: dict) -> dict:
    line = {"cmd": cmd, "item": item,
            **{k: (round(v, 4) if isinstance(v, float) else v) for k, v in rec.items()}}
    print(json.dumps(line), flush=True)
    return line


def _sum(recs, key):
    vals = [r[key] for r in recs]
    return None if any(v is None for v in vals) else sum(vals)


def _ratio(a, b):
    return None if a is None or b is None else a / b


# ---------------------------------------------------------------- stages

def cmd_stages(args, dev: torch.device, scans=None) -> list:
    """The warm LIO step and its stages (module docstring). `scans`: the
    bench's scans already raycast (at least `warm` + 1)."""
    from ..models.lio import frontend, mapping
    from ..models.lio.pipeline import (POS_SCALE, TIME_SCALE, LioPipeline, lio_full_step,
                                       pack_scan, scan_features)
    from ..ops import pointcloud as pc
    from ..ops import scan2map

    cfg = bi.full_width_config()
    if scans is None:
        scans = bi.Prefetch(None, *bi.scan_jobs(args.warm + 1)).get()
    pipe = LioPipeline(cfg, device=dev)
    for s in scans[:args.warm]:
        pipe.process_scan(s[0], s[1], s[2], s[3])
    state, kw = pipe.state, pipe._kw
    front = {k: v for k, v in kw.items() if k != "params"}
    caps, params = cfg.caps, cfg.params
    P, M = cfg.point_capacity, cfg.imu_capacity

    s = scans[args.warm]
    buf = pack_scan(cfg, s[0], s[1], s[2], s[3])
    buf_kf = buf.copy()
    buf_kf[P * 6 + M * 8:].view(np.float32)[5] += 2.0  # past the 1 s livox keyframe gate
    packed, packed_kf = (torch.from_numpy(b).to(dev) for b in (buf, buf_kf))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    st_incr = state._replace(kf_since_rebuild=i32(0))
    st_full = state._replace(kf_since_rebuild=i32(params.mapRebuildEvery - 1))
    info, feats = scan_features(packed, **front)
    info_kf, _ = scan_features(packed_kf, **front)

    def unpack():
        pts = packed[: P * 6].reshape(6, P)
        imu = packed[P * 6: P * 6 + M * 8].view(torch.float32).reshape(M, 4)
        misc = packed[P * 6 + M * 8:].view(torch.float32)
        ring_valid = pts[4].to(torch.int32)
        return (pts[0:3].to(torch.float32).T * POS_SCALE, pts[3].to(torch.float32),
                ring_valid % 256, pts[5].to(torch.float32) * TIME_SCALE, ring_valid >= 256,
                imu[:, 0], imu[:, 1:4], misc[0].to(torch.int32), misc[1:4], misc[4] > 0.5)

    proj_args = unpack()
    proj_kw = dict(n_scan=cfg.n_scan, horizon=cfg.horizon, min_range=cfg.min_range,
                   max_range=cfg.max_range)
    proj = frontend.project_scan(*proj_args, **proj_kw)
    feat_kw = dict(edge_threshold=cfg.edge_threshold, surf_threshold=cfg.surf_threshold,
                   surf_leaf=cfg.odometry_surf_leaf, max_corner=caps.scan_corner,
                   max_surf=caps.scan_surf, exact_selection=cfg.exact_loam_selection)

    def downsample():
        return (pc.voxel_downsample(feats.corner_xyz, feats.corner_valid,
                                    params.mappingCornerLeafSize, caps.scan_corner),
                pc.voxel_downsample(feats.surf_xyz, feats.surf_valid,
                                    params.mappingSurfLeafSize, caps.scan_surf))

    (c_xyz, c_val, _), (s_xyz, s_val, _) = downsample()

    def gn():
        return scan2map.scan_to_map_hashed(
            state.x6, c_xyz, c_val, s_xyz, s_val, state.map_corner, state.map_surf,
            state.corner_hash, state.surf_hash, max_iters=20,
            eigen_thresh=params.degeneracyEigenThreshold,
            nn_refresh_every=params.nnRefreshEvery, use_pallas=caps.pallas_knn,
            gather_once=params.gatherOncePerScan and caps.pallas_knn,
            use_pallas_gn=caps.pallas_gn)

    items = [
        ("step_nonkf", lambda: lio_full_step(state, packed, **kw)),
        ("step_kf_incremental", lambda: lio_full_step(st_incr, packed_kf, **kw)),
        ("step_kf_rebuild", lambda: lio_full_step(st_full, packed_kf, **kw)),
        ("unpack", unpack),
        ("project", lambda: frontend.project_scan(*proj_args, **proj_kw)),
        ("features", lambda: frontend.extract_features(proj, **feat_kw)),
        ("downsample", downsample),
        ("gn", gn),
        ("map_nonkf", lambda: mapping.map_step(state, info, feats, caps, params)),
        ("map_kf_incremental", lambda: mapping.map_step(st_incr, info_kf, feats, caps, params)),
        ("map_kf_rebuild", lambda: mapping.map_step(st_full, info_kf, feats, caps, params)),
    ]
    recs = {name: measure(fn, dev, args.reps) for name, fn in items}
    out = [emit("stages", name, rec) for name, rec in recs.items()]
    parts = [recs[k] for k in ("unpack", "project", "features", "map_nonkf")]
    whole = recs["step_nonkf"]
    summary = {"stages_ms": _sum(parts, "ms"), "whole_ms": whole["ms"],
               "sum_over_whole": _ratio(_sum(parts, "ms"), whole["ms"]),
               "stages_device_ms": _sum(parts, "device_ms"), "whole_device_ms": whole["device_ms"],
               "device_sum_over_whole": _ratio(_sum(parts, "device_ms"), whole["device_ms"]),
               "keyframes_warm": int(state.kf_count), "scans_warm": args.warm}
    out.append(emit("stages", "summary", summary))
    return out


# ---------------------------------------------------------------- replay

def cmd_replay(args, dev: torch.device, data=None) -> list:
    """The batched fused replay's rows and the frame branch's parts
    (module docstring). `data`: the parity stream already raycast (at least
    `seconds`)."""
    from ..models import replay as rp
    from ..models.pipeline import LviSystem
    from ..models.vio import estimator as est
    from ..models.vio import feature_manager as fm
    from ..models.vio import feature_tracker as ft
    from ..ops import ba
    from ..utils import synthetic as syn

    cfg = dataclasses.replace(bi.lvi_parity_config(), replay_batch=args.batch)
    if data is None:
        data = syn.lvi_sequence(duration=args.seconds + 0.1)
    sys_ = LviSystem(cfg, device=dev)
    syn.feed_lvi(sys_, data, 0.0, args.seconds)
    sys_.run()
    if not sys_._replay_active:
        raise RuntimeError(f"replay: not active after {args.seconds} s (VIO not up)")
    st, carry = sys_._replay_statics, sys_._carry
    # a scan and a frame row staged as the handlers stage them (the last fed
    # scan and frame at later stamps, as the JAX script restages them)
    t_s, scan = [x for x in data["scans"] if x[0] < args.seconds][-1]
    t_i, img = [x for x in data["imgs"] if x[0] < args.seconds][-1]
    sys_._stage_scan(t_s + 0.1, scan)
    sys_._stage_frame(max(t_i, t_s) + 0.15, dict(image=img))
    scan_row, frame_row = sys_._ev_rows[-2:]
    sys_._ev_rows, sys_._ev_meta = [], []
    noop_row = rp.pack_noop_event(st)
    K = args.batch
    out = []

    def batch(name, rows_np):
        rows = torch.from_numpy(rows_np).to(dev)
        rec = measure(lambda: rp.replay_batch_step(carry, rows, st, host_rows=rows_np,
                                                   sampler=sys_.sampler), dev, args.reps, 1)
        rec.update(per_event_ms=rec["ms"] / K,
                   per_event_device_ms=None if rec["device_ms"] is None else rec["device_ms"] / K)
        out.append(emit("replay", name, rec))
        return rec

    noop = batch("batch_noop", np.stack([noop_row] * K))
    scans = batch("batch_scan", np.stack([scan_row] * K))
    frames = batch("batch_frame", np.stack([frame_row] * K))
    mixed = np.stack([scan_row if i % 2 == 0 else frame_row for i in range(K)])
    batch("batch_mixed", mixed)

    def upload():
        host = torch.from_numpy(mixed)
        if dev.type == "cuda":
            host = host.pin_memory()
        return host.to(dev, non_blocking=True)

    out.append(emit("replay", "upload", dict(measure(upload, dev, args.reps * 4),
                                             MB=mixed.nbytes / 1e6)))
    outs = rp.replay_batch_step(carry, upload(), st, host_rows=mixed, sampler=sys_.sampler)[1]
    out.append(emit("replay", "readback", dict(measure(lambda: outs.cpu(), dev, args.reps * 4),
                                               KB=outs.numel() * 4 / 1e3)))

    # the frame branch's parts alone (scripts/frame_breakdown.py)
    rng = np.random.default_rng(0)
    H, W = cfg.image_height, cfg.image_width
    tp = cfg.tracker
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    im = f32(rng.random((H, W)))
    tst = ft.seed_prev_image(ft.tracker_init(H, W, tp, device=dev), im, tp)._replace(
        pts=f32(np.stack([rng.uniform(20, W - 20, tp.max_cnt),
                          rng.uniform(20, H - 20, tp.max_cnt)], -1)),
        ids=torch.arange(tp.max_cnt, dtype=torch.int32, device=dev),
        track_cnt=torch.full((tp.max_cnt,), 5, dtype=torch.int32, device=dev))
    S, P = cfg.depth_cloud_slots, min(cfg.depth_cloud_points, cfg.lio.caps.kf_surf)
    depth = (f32(rng.uniform(-0.5, 0.5, (tp.max_cnt, 2))),
             torch.ones(tp.max_cnt, dtype=torch.bool, device=dev),
             f32(rng.uniform(-10, 10, (S * P, 3))), torch.ones(S * P, dtype=torch.bool, device=dev),
             torch.zeros(3, device=dev), f32([1.0, 0.0, 0.0, 0.0]))
    caps, bcfg, ws, pints, table, G = syn.consistent_window(
        cfg.vio_caps.window, cfg.vio_caps.max_features, seed=0, device=dev)
    bcfg = dataclasses.replace(bcfg, solver="schur", iterations=cfg.ba.iterations)
    fv = torch.ones(bcfg.window + 1, dtype=torch.bool, device=dev)
    window = (ws, table.inv_depth, table.obs, table.vel, table.obs_valid, table.start_frame,
              table.ids >= 0, table.lidar_flag, pints, fv, ba.empty_prior(bcfg, device=dev), G,
              torch.zeros((), device=dev), bcfg)
    no_depth = table._replace(inv_depth=torch.full_like(table.inv_depth, -1.0))
    vio = est.vio_init(cfg.vio_caps, cfg.vio_params, device=dev)
    Mb = cfg.vio_caps.imu_buf
    imu = (torch.full((Mb,), 0.005, device=dev), f32(rng.normal(0, 1, (Mb, 3)) + [0, 0, 9.8]),
           f32(rng.normal(0, 0.1, (Mb, 3))))
    parts = [
        ("tracker", lambda: ft.tracker_step(tst, im, 1.0, tp, cfg.camera)),
        ("depth", lambda: ft.register_depth(*depth)),
        ("ba", lambda: ba.solve(*window)),
        ("triangulation", lambda: fm.triangulate_all(no_depth, ws.Ps, ws.Qs, ws.tic, ws.qic,
                                                     caps)),
        ("marginalization", lambda: ba.marginalize_old(*window)),
        ("process_imu", lambda: est.process_imu(vio, *imu, cfg.vio_caps, cfg.vio_params,
                                                frame_count=0)),
    ]
    for name, fn in parts:
        out.append(emit("replay", "frame_" + name, measure(fn, dev, args.reps, 1)))
    cycle = _ratio(_sum([scans, frames], "device_ms"), K)
    cycle_ms = (scans["ms"] + frames["ms"]) / K
    out.append(emit("replay", "summary", {
        "batch": K, "noop_ms_per_event": noop["ms"] / K, "cycle_ms": cycle_ms,
        "cycle_device_ms": cycle, "rtf_bound_from_cycle": 100.0 / cycle_ms,
        "rtf_bound_from_device": None if not cycle else 100.0 / cycle,
        "frames_fed": sys_.vio_frames}))
    return out


# ---------------------------------------------------------------- transport

def cmd_transport(args, dev: torch.device, scans=None) -> list:
    """The LIO batched upload's host costs a scan against device time
    (module docstring)."""
    from ..models.lio import pipeline as lp

    cfg = dataclasses.replace(bi.full_width_config(), upload_batch=bi.UPLOAD_BATCH)
    if scans is None:
        scans = bi.Prefetch(None, *bi.scan_jobs(args.scans)).get()
    scans = scans[:args.scans]
    n = len(scans) - args.warm
    cost = {"pack": [], "upload": [], "dispatch": [], "process_scan": []}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            cost[key].append(time.perf_counter() - t0)
            return r
        return run

    def replay(profiled: bool):
        pipe = lp.LioPipeline(cfg, device=dev)
        pipe._upload = timed("upload", pipe._upload)
        for s in scans[:args.warm]:
            pipe.process_scan(s[0], s[1], s[2], s[3])
        pipe.flush()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        for v in cost.values():
            v.clear()
        h0 = hostsync.COUNT
        prof = None
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        for s in scans[args.warm:]:
            t1 = time.perf_counter()
            pipe.process_scan(s[0], s[1], s[2], s[3])
            cost["process_scan"].append(time.perf_counter() - t1)
        pipe.flush()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            return sum(e.self_device_time_total for e in kernel_rows(prof)) / n / 1e3
        return wall, (hostsync.COUNT - h0) / n, pipe.uploads

    saved = (lp.pack_scan, lp.lio_batch_step)
    lp.pack_scan, lp.lio_batch_step = timed("pack", lp.pack_scan), timed("dispatch",
                                                                         lp.lio_batch_step)
    try:
        wall, syncs, uploads = replay(False)
        stats = {k: (1e3 * sum(v) / n, 1e3 * float(np.median(v)) if v else 0.0, len(v))
                 for k, v in cost.items()}
        dev_ms = replay(True) if dev.type == "cuda" else None
    finally:
        lp.pack_scan, lp.lio_batch_step = saved
    out = [emit("transport", k, {"ms_per_scan": a, "p50_ms_a_call": b, "calls": c})
           for k, (a, b, c) in stats.items()]
    out.append(emit("transport", "summary", {
        "upload_batch": cfg.upload_batch, "scans_timed": n, "wall_ms_per_scan": 1e3 * wall / n,
        "device_ms_per_scan": dev_ms, "host_syncs_per_scan": syncs, "uploads": uploads}))
    return out


# ---------------------------------------------------------------- query

def masked_distances(cand, want_tag, corner_off, B: int) -> torch.Tensor:
    """(Q, 27 B) the distances K1 selects from: `knn_tail_plain`'s first
    half, computed once (the library call's input)."""
    Q = cand.shape[0]
    c, off = cand.reshape(Q, 27, 4, B), corner_off.reshape(Q, 3, 27)
    d = sum((c[:, :, i, :].to(torch.float32) + off[:, i, :, None]) ** 2 for i in range(3))
    occ = c[:, :, 3, :].to(torch.int32) == want_tag[:, :, None]
    return torch.where(occ, d, torch.full_like(d, 1e10)).reshape(Q, 27 * B)


def cmd_query(args, dev: torch.device) -> list:
    """K1's wrapper against its plain version and `torch.topk` (module
    docstring)."""
    from ..ops import knn_tail as kt
    from ..ops import voxel_hash as vh

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ms = f32(rng.uniform(-20, 20, (args.points, 3)))
    h = vh.build(ms, torch.ones(args.points, dtype=torch.bool, device=dev), 1.0, 1 << 16, 16)
    q = f32(rng.uniform(-12, 12, (args.queries, 3)))
    qs = vh._query_set(h, vh.query_gather(h, q), q)
    d = masked_distances(*qs)
    runs = {"wrapper": lambda: kt.knn_tail(*qs, k=5),
            "plain": lambda: kt.knn_tail_plain(*qs, k=5),
            "topk": lambda: torch.topk(d, 5, dim=1, largest=False)}
    got = {name: fn() for name, fn in runs.items()}
    (dw, pw), (dp, pp), (dt, pt) = got["wrapper"], got["plain"], got["topk"]
    found = dp < 1e9
    # positions of a found neighbour as a set a query (topk orders equal
    # distances by its own rule)
    pos_set = lambda p: torch.sort(torch.where(found, p.to(torch.int64), -1), dim=1).values
    same = {"wrapper_vs_plain": bool(torch.equal(pw, pp) and torch.equal(dw, dp)),
            "topk_vs_plain": bool(torch.equal(dt, dp) and torch.equal(pos_set(pt), pos_set(pp)))}
    out = [emit("query", name, measure(fn, dev, args.reps * 10)) for name, fn in runs.items()]
    out.append(emit("query", "summary", {
        "queries": args.queries, "points": args.points, "bucket": 16, "k": 5,
        "found_share": float(found.float().mean()), **same,
        "selections_equal": all(same.values()), "device": str(dev)}))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("stages", help="the warm LIO step and its stages")
    p.add_argument("--warm", type=int, default=12)
    p.add_argument("--reps", type=int, default=5)
    p = sub.add_parser("replay", help="the batched fused replay and the frame branch's parts")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--reps", type=int, default=2)
    p = sub.add_parser("transport", help="the LIO batched upload's host costs")
    p.add_argument("--scans", type=int, default=75)
    p.add_argument("--warm", type=int, default=11)
    p = sub.add_parser("query", help="K1 against its plain version and torch.topk")
    p.add_argument("--queries", type=int, default=2048)
    p.add_argument("--points", type=int, default=65536)
    p.add_argument("--reps", type=int, default=5)
    for p in sub.choices.values():
        p.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    dev = resolve(args.device)
    return {"stages": cmd_stages, "replay": cmd_replay, "transport": cmd_transport,
            "query": cmd_query}[args.cmd](args, dev)


if __name__ == "__main__":
    main()
