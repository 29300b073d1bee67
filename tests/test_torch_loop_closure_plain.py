"""The LIO step's loop closure held against the benchmark's plain reference
(``benchmark/plain_loop.py``, float64 torch, nothing of the program): the
pose-graph solve on seeded graphs with more loop factors than the old cap
of 16, the ICP on seeded clouds, ``_loop_icp`` filling loop slots past 16
when ``max_loops`` = ``max_keyframes``, the new spans nested under
``lio.step`` in a traced run of the replay cell's configuration that
closes loops, and the readers of the LIO cell's per-layer metrics."""

from __future__ import annotations

import ast
import dataclasses
import json
import math
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import loop_compare as LC
from benchmark import plain_loop as P
from benchmark import run, spec
from benchmark import system as S
from benchmark.metrics import _spans
from benchmark.trace import Trace
from lvislam_tpu_torch.models.lio import mapping
from lvislam_tpu_torch.ops import icp as icp_ops
from lvislam_tpu_torch.ops import posegraph as pg

CELL = "lio_mid360_replay"
SEED = 2**31 + 19  # a large seed, past what 32 signed bits hold


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The pose graph
# ---------------------------------------------------------------------------

def _t(a, dt=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dt)


def loop_graph(seed: int, K: int = 24, L: int = 40, drift: float = 0.05) -> pg.PoseGraph:
    """Two turns of a circle of K keyframes, odometry factors with noise,
    L loop factors from the second turn back, one GPS factor, and the poses
    started from a drifting guess."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 4 * np.pi, K, endpoint=False)
    tt = np.stack([5 * np.cos(ang), 5 * np.sin(ang), 0.1 * np.sin(3 * ang)], 1)
    yaw = ang + np.pi / 2
    Rt = P.quat_to_matrix(torch.tensor(np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw,
                                                 np.sin(yaw / 2)], 1))).numpy()
    F = K + L
    bf_i, bf_j = np.zeros(F, np.int32), np.zeros(F, np.int32)
    bt, bq = np.zeros((F, 3)), np.tile([1.0, 0, 0, 0], (F, 1))
    bw, bv = np.zeros((F, 6)), np.zeros(F, bool)

    def put(f, i, j, t_noise, sqrtw):
        bf_i[f], bf_j[f] = i, j
        bt[f] = Rt[i].T @ (tt[j] - tt[i]) + rng.normal(0, t_noise, 3)
        bq[f] = P.matrix_to_quat(torch.tensor(Rt[i].T @ Rt[j])).numpy()
        bw[f], bv[f] = sqrtw, True

    for f in range(K - 1):
        put(f, f, f + 1, 0.01, pg.ODOM_SQRTW)
    for n in range(L):
        i = int(rng.integers(K // 2, K))
        put(K + n, i, int(rng.integers(0, i - 2)), 0.05, 1 / math.sqrt(rng.uniform(0.02, 0.3)))
    t0 = tt + rng.normal(0, drift, tt.shape) * np.arange(K)[:, None] / K
    y0 = yaw + rng.normal(0, 0.01, K) * np.arange(K) / K
    q0 = np.stack([np.cos(y0 / 2), 0 * y0, 0 * y0, np.sin(y0 / 2)], 1)
    G = 4
    up_k, up_pos = np.zeros(G, np.int32), np.zeros((G, 3))
    up_w, up_v = np.zeros((G, 3)), np.zeros(G, bool)
    up_k[0], up_pos[0], up_w[0], up_v[0] = K // 2, tt[K // 2], 1.0, True
    return pg.PoseGraph(
        trans=_t(t0), quat=_t(q0), node_valid=torch.ones(K, dtype=torch.bool),
        bf_i=_t(bf_i, torch.int32), bf_j=_t(bf_j, torch.int32), bf_trans=_t(bt),
        bf_quat=_t(bq), bf_sqrtw=_t(bw), bf_valid=_t(bv, torch.bool),
        up_k=_t(up_k, torch.int32), up_pos=_t(up_pos), up_sqrtw=_t(up_w),
        up_valid=_t(up_v, torch.bool), prior_trans=_t(t0[0]), prior_quat=_t(q0[0]),
        prior_sqrtw=_t(pg.PRIOR_SQRTW))


def _gaps(g, out, plain) -> dict:
    R = P.quat_to_matrix(out.quat.double())
    return LC._diffs(g, plain["nodes"], out.trans, R, plain)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_posegraph_optimize_matches_the_plain_solve(seed):
    """The step's solve (6 GN x 96 PCG, float32) against dense float64 GN to
    convergence, within ``loop_compare.TOL``; 8 PCG iterations stop
    short of them."""
    g = loop_graph(seed)
    plain = P.pose_graph_solve(g)
    assert plain["step_norm"] < 1e-10 and plain["total_error"] < 0.5 * plain["total_error_before"]
    got = _gaps(g, pg.optimize(g, gn_iters=6, pcg_iters=96), plain)
    assert got["within"], got
    short = _gaps(g, pg.optimize(g, gn_iters=6, pcg_iters=8), plain)
    assert not short["within"], short


def test_plain_jacobians_match_finite_differences():
    g = loop_graph(3)
    G = P._Graph(g)
    R, t = P.quat_to_matrix(P._d(g.quat)), P._d(g.trans)
    r, Ji, Jj, ur, pr, pJ = G.linearize(R, t)
    eps = 1e-7
    for f in (5, 30, 50):
        for node, J in ((int(G.bi[f]), Ji), (int(G.bj[f]), Jj)):
            for k in range(6):
                d = torch.zeros(6, dtype=torch.float64)
                d[k] = eps
                R2, t2 = R.clone(), t.clone()
                R2[node] = R[node] @ P.so3_exp(d[:3])
                t2[node] = t[node] + d[3:]
                num = (G.linearize(R2, t2)[0][f] - r[f]) / eps
                torch.testing.assert_close(num, J[f][:, k], atol=2e-4 * float(G.bw[f].max()),
                                           rtol=0)


def test_plain_total_error_is_the_programs():
    g = loop_graph(4)
    e = P._Graph(g).error(P.quat_to_matrix(P._d(g.quat)), P._d(g.trans))
    assert e == pytest.approx(float(pg.total_error(g)), rel=1e-5)


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_icp_matches_the_plain_icp(seed):
    rng = np.random.default_rng(seed)
    dst = rng.uniform(-6, 6, (3000, 3)).astype(np.float32)
    dst[:, 2] *= 0.3
    ang = rng.uniform(0.03, 0.1)
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    src = ((dst[:1200] - rng.uniform(-0.3, 0.3, 3)) @ Rz).astype(np.float32)
    sv, dv = np.ones(1200, bool), np.ones(3000, bool)
    sv[::7] = False
    dv[2500:] = False
    args = (_t(src), _t(sv, torch.bool), _t(dst), _t(dv, torch.bool), torch.zeros(3),
            torch.tensor([1.0, 0, 0, 0]))
    kw = dict(max_corr_dist=30.0, iters=20)
    res = icp_ops.icp_point2point(*args, **kw)
    d = LC.compare_icp(args, kw, res)
    assert d["step"]["within"], d
    assert d["step"]["num_corr"] == d["plain_num_corr"] == int(sv.sum())


def test_plain_loop_imports_neither_jax_nor_the_program():
    tree = ast.parse(open(P.__file__).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "torch"}, tops


# ---------------------------------------------------------------------------
# _loop_icp past the old cap
# ---------------------------------------------------------------------------

def test_loop_icp_fills_slots_past_the_old_cap():
    """With max_loops = max_keyframes, each verified pair goes to slot
    K + n: the 17th, 33rd and last included; once full, no factor."""
    K = 40
    caps = mapping.LioCaps(max_keyframes=K, max_loops=K, kf_corner=16, kf_surf=64,
                           loop_submap=1024, icp_iters=3, max_gps=4)
    params = mapping.LioParams(historyKeyframeSearchNum=2)
    st = mapping.lio_init(caps, device="cpu")
    rng = np.random.default_rng(0)
    corner = _t(rng.uniform(-4, 4, (16, 3)))
    surf = _t(rng.uniform(-4, 4, (64, 3)))
    st = st._replace(  # every keyframe at the origin with the same clouds
        kf_count=torch.tensor(K, dtype=torch.int32),
        kf_corner=corner.expand(K, 16, 3).clone(), kf_surf=surf.expand(K, 64, 3).clone(),
        kf_corner_valid=torch.ones(K, 16, dtype=torch.bool),
        kf_surf_valid=torch.ones(K, 64, dtype=torch.bool),
        graph=st.graph._replace(node_valid=torch.ones(K, dtype=torch.bool)))
    checks0, added0 = mapping.LOOP_CHECKS, mapping.LOOPS_ADDED
    pairs = [(K - 1 - n % 10, n % 20) for n in range(K + 1)]
    for n, (cur, cand) in enumerate(pairs):
        st, res = mapping._loop_icp(st, torch.tensor(cur), torch.tensor(cand), caps, params)
        assert bool(res.found)
        assert int(st.n_loops) == min(n + 1, K)
    g = st.graph
    for n in (16, 32, K - 1):  # the 17th, the 33rd and the last factor
        f = K + n
        assert bool(g.bf_valid[f]) and (int(g.bf_i[f]), int(g.bf_j[f])) == pairs[n]
        assert float(g.bf_sqrtw[f, 0]) > 0
    assert int(g.bf_valid[K:].sum()) == K
    assert mapping.LOOP_CHECKS - checks0 == K + 1 and mapping.LOOPS_ADDED - added0 == K


# ---------------------------------------------------------------------------
# Spans in a traced run that closes loops
# ---------------------------------------------------------------------------

NEW_SPANS = {  # span: the span it opens inside
    "lio.frontend": "lio.step",
    "lio.loop_closure": "lio.step",
    "lio.loop_icp": "lio.loop_closure",
    "lio.loop_factor": "lio.loop_closure",
    "lio.posegraph": "lio.keyframe",
    "lio.map_rebuild": "lio.keyframe",
}
READERS = ["lio.step_ms", "lio.loop_closure_ms", "lio.loops_closed_share", "lio.posegraph_ms",
           "lio.posegraph_launches_per_solve", "lio.map_rebuild_ms"]
SHORT_TIME_DIFF = 1.5  # s: a revisit after 1.5 s, so a 6 s run closes loops
SCANS = 60  # 6 s of the lap, 30 mapped sweeps


@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    """The replay cell's configuration and traffic on the CPU, with loop
    candidates after 1.5 s rather than 30 s: 6 s of the lap through the
    throttle and the step (8 mapped sweeps an upload), profiled. Returns
    the trace, the loop counters' increments and the last graph solve's
    input."""
    torch.set_num_threads(1)
    cell = spec.cell(CELL)
    lap = run.make_lap(cell, SEED, torch.device("cpu"), limit=SCANS + 1)
    cfg = S.program_config(cell.config, cell.traffic)
    cfg = dataclasses.replace(cfg, params=dataclasses.replace(
        cfg.params, historyKeyframeSearchTimeDiff=SHORT_TIME_DIFF))
    pipe = S.LioPipeline(cfg, device="cpu")
    thr = S.Throttle(cell.config["mapping_process_interval"])
    solves, real = [], mapping._optimize_graph

    def opt(state, k):
        solves[:] = [(state, k)]
        return real(state, k)

    c0, a0 = mapping.LOOP_CHECKS, mapping.LOOPS_ADDED
    with mock.patch.object(mapping, "_optimize_graph", opt), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(SCANS):
            stamp, args = S.scan_inputs(lap, i)
            if thr.take(stamp):
                pipe.process_scan(*args)
        pipe.flush()
    path = tmp_path_factory.mktemp("lio_spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return (Trace(events, SCANS / 10), mapping.LOOP_CHECKS - c0, mapping.LOOPS_ADDED - a0,
            solves[0] if solves else None, pipe)


def inside(span, outer) -> bool:
    return any(a <= span[0] and span[1] <= b for a, b in outer)


@pytest.mark.parametrize("name", list(NEW_SPANS))
def test_each_lio_span_nests_under_lio_step(loop_run, name):
    s = _spans.Spans(loop_run[0])
    got = s.named(name)
    assert got, f"no {name} span in the traced run"
    assert all(inside(sp, s.named("lio.step")) for sp in got)
    assert all(inside(sp, s.named(NEW_SPANS[name])) for sp in got)


def test_counters_count_the_spans(loop_run):
    s = _spans.Spans(loop_run[0])
    tr, checks, added, _, pipe = loop_run
    assert s.count("lio.step") == pipe.trajectory_array().shape[0] == SCANS // 2
    assert s.count("lio.loop_icp") == checks > 0
    assert s.count("lio.loop_factor") == added == int(pipe.state.n_loops) > 0


def test_the_runs_last_solve_holds_the_plain_reference(loop_run):
    state, k = loop_run[3]
    res = LC.compare_posegraph(state, k)
    assert res["loops"] > 0 and res["step"]["within"], res
    assert not res["float16_graph"]["within"], res


@pytest.mark.parametrize("name", READERS)
def test_each_lio_reader_reads_the_cpu_trace(loop_run, name):
    entry = [m for m in spec.cell(CELL).per_layer if m["name"] == name]
    assert [m["source"] for m in entry] == ["program_span"]
    read = spec.reader(name)
    v = read({"trace": loop_run[0]})
    assert v is not None and math.isfinite(v)
    assert v == 0 if "launches" in name else v > 0
    assert read({"trace": None}) is None


def _ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _lio_trace(root: bool = True) -> Trace:
    """Three mapped sweeps of 100 µs; two loop checks, the first adding a
    factor; two solves of 30 and 20 µs holding 2 and 1 launches; one
    rebuild of 20 µs."""
    ev = [_ev("lio.loop_closure", 80, 15), _ev("lio.loop_icp", 81, 8),
          _ev("lio.loop_factor", 90, 3), _ev("lio.loop_closure", 480, 10),
          _ev("lio.loop_icp", 481, 8), _ev("lio.posegraph", 210, 30),
          _ev("lio.posegraph", 410, 20), _ev("lio.map_rebuild", 245, 20),
          _ev("cudaLaunchKernel", 215, 1, "cuda_runtime"),
          _ev("cuLaunchKernel", 220, 1, "cuda_driver"),
          _ev("cudaLaunchKernel", 415, 1, "cuda_runtime"),
          _ev("cudaLaunchKernel", 50, 1, "cuda_runtime")]
    if root:
        ev += [_ev("lio.step", 0, 100), _ev("lio.step", 200, 100), _ev("lio.step", 400, 100)]
    else:  # the fused system's root, as in a trace of the parent's fused cell
        ev += [_ev("lvi.lidar", 0, 500)]
    return Trace(ev, 1.0)


@pytest.mark.parametrize("name,want", [
    ("lio.step_ms", 0.1), ("lio.loop_closure_ms", 0.025 / 3), ("lio.loops_closed_share", 50.0),
    ("lio.posegraph_ms", 0.025), ("lio.posegraph_launches_per_solve", 1.5),
    ("lio.map_rebuild_ms", 0.02 / 3)])
def test_each_lio_reader_on_a_synthetic_trace(name, want):
    """The number on a LIO stretch; None without a ``lio.step`` root (a
    program that opens none), whatever other root the stretch has."""
    read = spec.reader(name)
    assert read({"trace": _lio_trace()}) == pytest.approx(want)
    assert read({"trace": _lio_trace(root=False)}) is None
