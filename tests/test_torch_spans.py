"""The fused system's spans on the CPU: the parity system (loop detector on)
fed 1.05 s of the parity sequence, then traced by ``torch.profiler`` over
the next 0.4 s, which hold the VIO's initialization, four frames with BA,
marginalisation and the window slide, two loop detections and two mapped
sweeps. Every span nests inside its handler's ``lvi.*`` span, the
iteration spans count the iterations the solvers report, ``host.sync``
counts the host reads, and the benchmark's span readers read the exported
trace (``benchmark/metrics/_spans.py``)."""

from __future__ import annotations

import dataclasses
import json
import math
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spec
from benchmark.metrics import _spans
from benchmark.trace import Trace
from lvislam_tpu_torch.core import hostsync
from lvislam_tpu_torch.models.lio import mapping
from lvislam_tpu_torch.models.pipeline import LviSystem
from lvislam_tpu_torch.ops import ba
from lvislam_tpu_torch.scripts.bench_inputs import lvi_parity_config
from lvislam_tpu_torch.utils import synthetic as tsyn

WARM_T, END_T = 1.05, 1.45  # the VIO initializes on the frame at 1.1 s

# each span: (its handler's root, the span it opens inside)
SPANS = {
    "lvi.pack": ("lvi.image", "lvi.image"),
    "vio.tracker": ("lvi.image", "lvi.image"),
    "vio.depth": ("lvi.image", "lvi.image"),
    "vio.preint": ("lvi.image", "lvi.image"),
    "vio.estimator": ("lvi.image", "lvi.image"),
    "vio.init": ("lvi.image", "vio.estimator"),
    "vio.triangulate": ("lvi.image", "vio.estimator"),
    "vio.ba": ("lvi.image", "vio.estimator"),
    "vio.ba_iter": ("lvi.image", "vio.ba"),
    "vio.marg": ("lvi.image", "vio.estimator"),
    "vio.slide": ("lvi.image", "vio.estimator"),
    "loop.detect": ("lvi.image", "lvi.image"),
    "lio.guess": ("lvi.lidar", "lvi.lidar"),
    "lio.pack": ("lvi.lidar", "lvi.lidar"),
    "lio.step": ("lvi.lidar", "lvi.lidar"),
    "lio.frontend": ("lvi.lidar", "lvi.lidar"),
    "lio.scan_to_map": ("lvi.lidar", "lvi.lidar"),
    "lio.gn_iter": ("lvi.lidar", "lio.scan_to_map"),
    "lio.keyframe": ("lvi.lidar", "lvi.lidar"),
    "lio.fusion": ("lvi.lidar", "lvi.lidar"),
    "lvi.imu_rate_odom": ("lvi.lidar", "lvi.lidar"),
    "lio.depth_cloud": ("lvi.lidar", "lvi.lidar"),
    "host.sync": (None, None),  # in both handlers
}
READERS = ["vio.tracker_ms", "vio.preint_ms", "vio.ba_ms", "vio.marg_ms",
           "vio.ba_iters_per_frame", "vio.ba_launches_per_frame", "loop.detect_ms",
           "lio.fusion_ms", "lio.fusion_launches_per_scan", "lio.gn_iters_per_scan",
           "lvi.sync_wait_ms", "lvi.span_coverage"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(the exported trace's events, the stretch's wall seconds, the GN `it`
    of each scan-to-map call, the iterations of each BA solve, the host
    reads counted, the handlers' ``StageTimer`` rows) of the traced 0.4 s."""
    torch.set_num_threads(1)
    data = tsyn.lvi_sequence(duration=END_T + 0.05)
    cfg = dataclasses.replace(lvi_parity_config(kernels=False), use_loop_detector=True)
    s = LviSystem(cfg, device="cpu")
    tsyn.feed_lvi(s, data, 0.0, WARM_T)
    s.run()
    gn_its, ba_its = [], []
    real_gn, real_solve = mapping.map_gn, ba.solve

    def map_gn(*a, **k):
        st = real_gn(*a, **k)
        gn_its.append(int(st.it))
        return st

    def solve(*a, **k):
        res = real_solve(*a, **k)
        ba_its.append(res.iterations)
        return res

    with mock.patch.object(mapping, "map_gn", map_gn), mock.patch.object(ba, "solve", solve):
        h0, r0 = hostsync.COUNT, len(s.metrics.records)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t = WARM_T
            while t < END_T - 1e-9:  # event by event, as the benchmark feeds them
                tsyn.feed_lvi(s, data, t, t + 0.1)
                s.run()
                t += 0.1
        syncs = hostsync.COUNT - h0
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    rows = [r["stage"] for r in s.metrics.records[r0:]]
    return events, END_T - WARM_T, gn_its, ba_its, syncs, rows


@pytest.fixture(scope="module")
def traces(traced):
    """The stretch's `Trace`, and the same without the ``record_function``
    ranges: what the benchmark reads of a program that opens none."""
    bench_only = [e for e in traced[0] if e.get("cat") != "user_annotation"]
    return Trace(traced[0], traced[1]), Trace(bench_only, traced[1])


@pytest.fixture(scope="module")
def spans(traces):
    return _spans.Spans(traces[0])


def inside(span, outer) -> bool:
    return any(a <= span[0] <= b for a, b in outer)


@pytest.mark.parametrize("name", list(SPANS))
def test_each_span_occurs_nested_in_its_handler(spans, name):
    root, parent = SPANS[name]
    got = spans.named(name)
    assert got, f"no {name} span in the traced stretch"
    roots = spans.named(root) if root else spans.named(*_spans.ROOTS)
    assert all(inside(sp, roots) for sp in got)
    if parent:
        assert all(inside(sp, spans.named(parent)) for sp in got)


def nested_counts(spans, outer: str, inner: str) -> list:
    return [sum(a <= c <= b for c, _ in spans.named(inner)) for a, b in spans.named(outer)]


def test_gn_iter_spans_count_each_scans_iterations(traced, spans):
    assert nested_counts(spans, "lio.scan_to_map", "lio.gn_iter") == traced[2]
    assert len(traced[2]) == 2 and min(traced[2]) > 0


def test_ba_iter_spans_count_each_solves_iterations(traced, spans):
    assert nested_counts(spans, "vio.ba", "vio.ba_iter") == traced[3]
    assert len(traced[3]) == 4


def test_host_sync_spans_count_the_host_reads(traced, spans):
    assert spans.count("host.sync") == traced[4] > 0


def test_each_handler_row_is_one_root_span(traced, spans):
    rows = traced[5]
    assert rows.count("image") == spans.count("lvi.image") == 4
    assert rows.count("lidar") == spans.count("lvi.lidar") == 4


@pytest.mark.parametrize("name", READERS)
def test_each_span_reader_reads_the_cpu_trace(traces, name):
    entry = spec.cell("lvi_mid360_imx219_stream").per_layer
    assert [m["source"] for m in entry if m["name"] == name] == ["program_span"]
    read = spec.reader(name)
    v = read({"trace": traces[0]})
    assert v is not None and math.isfinite(v)
    if "launches" in name:
        assert v == 0  # no CUDA launch on the CPU
    else:
        assert v > 0
    assert read({"trace": traces[1]}) is None
    assert read({"trace": None}) is None


def _ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_coverage_and_launches_by_containment():
    """A root of 100 µs with spans over 10-50 (two overlapping), 60-70 and
    90-120 (clipped at the root's end) is 60% covered; a second root with
    nothing inside it is not; launches count where they start."""
    ev = [_ev("lvi.image", 0, 100), _ev("vio.ba", 10, 20), _ev("host.sync", 20, 30),
          _ev("vio.marg", 60, 10), _ev("loop.detect", 90, 30), _ev("lvi.lidar", 200, 100),
          _ev("bench.image", -5, 400),
          _ev("cudaLaunchKernel", 15, 1, "cuda_runtime"),
          _ev("cuLaunchKernel", 29, 1, "cuda_driver"),
          _ev("cudaMemcpyAsync", 16, 1, "cuda_runtime"),
          _ev("cudaLaunchKernel", 31, 1, "cuda_runtime"),
          _ev("aten::mul", 12, 1, "cpu_op")]
    s = _spans.Spans(Trace(ev, 1.0))
    assert s.coverage_pct() == pytest.approx(100.0 * 60 / 200)
    assert s.launches_in("vio.ba") == 2 and s.launches_in("lvi.image") == 3
    assert s.count(*_spans.ROOTS) == 2 and s.ms("vio.ba", "vio.marg") == pytest.approx(0.03)


def _graph_trace(replays: bool, root: bool = True) -> Trace:
    """A frame whose two LM iterations and marginalization each hold a
    ``vio.ba_graph`` span (or none), under an ``lvi.image`` root (or
    none); the prologue's replay sits outside the iterations."""
    ev = [_ev("vio.ba", 10, 60), _ev("vio.ba_iter", 20, 20), _ev("vio.ba_iter", 45, 20),
          _ev("vio.marg", 75, 10)]
    if root:
        ev.append(_ev("lvi.image", 0, 100))
    if replays:
        ev += [_ev("vio.ba_graph", 12, 3), _ev("vio.ba_graph", 22, 5),
               _ev("vio.ba_graph", 47, 5), _ev("vio.ba_graph", 76, 4)]
    return Trace(ev, 1.0)


@pytest.mark.parametrize("case,want", [("replays", 100.0), ("eager", 0.0), ("no_root", None),
                                       ("parent", None)])
def test_graph_share_reads_the_spans_holding_a_replay(monkeypatch, case, want):
    """100 where every iteration and marginalization replays a graph, 0
    where none does, None without a root or from a program that replays
    no graphs (no ``ops.ba.CAPTURES``, as before graphs)."""
    if case == "parent":
        monkeypatch.delattr(ba, "CAPTURES")
    tr = _graph_trace(replays=case in ("replays", "parent"), root=case != "no_root")
    got = spec.reader("vio.ba_graph_share")({"trace": tr})
    assert got == want


def test_graph_share_counts_each_span_once():
    """One iteration of two without a replay reads 2 of 3 spans."""
    ev = [_ev("lvi.image", 0, 100), _ev("vio.ba_iter", 20, 20), _ev("vio.ba_iter", 45, 20),
          _ev("vio.marg", 75, 10), _ev("vio.ba_graph", 22, 5), _ev("vio.ba_graph", 24, 5),
          _ev("vio.ba_graph", 76, 4)]
    got = spec.reader("vio.ba_graph_share")({"trace": Trace(ev, 1.0)})
    assert got == pytest.approx(100.0 * 2 / 3)
