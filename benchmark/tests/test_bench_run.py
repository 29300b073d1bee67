"""A run of the harness on the CPU at a test's size: the last line's keys,
no result without a card, the module guard by whole top-level names, and
``correct`` coming out false under the control and under each fault a LIO
cell can have, with the timed path broken underneath."""

import io
import json
import sys
import types
from contextlib import redirect_stderr, redirect_stdout
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import run, spec

SEED = 2**31 + 101  # a large seed, past what 32 signed bits hold
LAP = 400  # sweeps made for a run here, the replay's whole lap (the window stops short of it)
LIO_WARM_S = 1.2  # the LIO cells' warm span here: 6 mapped sweeps, not a lap
REAL_CELL = spec.cell
REPLAY = "lio_mid360_replay"


def replay_cell() -> spec.Cell:
    """The LIO replay cell from its files: out of ``BENCHMARK.json`` while the
    program loses its track on some seeds (PERF.md §7), kept with its
    configuration, traffic and checks, which these tests drive."""
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    return spec.Cell(
        name=REPLAY, chips=1, config=spec.load_json(spec.HERE / "configs" / "lio_mid360.json"),
        traffic=spec.load_json(spec.HERE / "traffic" / "lio_replay_b8.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if m["name"] in ("host_cpu_per_sensor_s", "setup_s")],
        per_layer=[], checks=spec.load_json(spec.HERE / "checks" / f"{REPLAY}.json"))


def small_cell(name, root=spec.ROOT):
    """The cell as it runs here: the LIO replay warms 6 mapped sweeps."""
    if name != REPLAY:
        return REAL_CELL(name, root)
    c = replay_cell()
    c.traffic = dict(c.traffic, warm_s=LIO_WARM_S)
    return c


def cpu_run(cell="lio_mid360_replay", seconds=6.0, control=None, lap=LAP, seed=SEED):
    """A run here; the LIO cells' window lasts long enough for answers 5 s
    of sensor time apart (the replay's heading check compares over 5 s)."""
    with mock.patch.object(spec, "cell", small_cell):
        out = run.run_cell(cell, seed, seconds, False, device="cpu", control=control,
                           lap_limit=lap)
    tr = small_cell(cell).traffic
    if tr["system"] == "lio":  # every other sweep mapped
        scans = tr["warm_s"] * tr["lidar"]["rate_hz"] + 2 * out["attempted"]
    else:  # events: a scan and a frame every period
        scans = tr["warm_s"] * tr["lidar"]["rate_hz"] + out["attempted"] / 2
    assert lap is None or scans < lap  # the window never wrapped the lap
    return out


def test_last_line_has_exactly_the_contracts_keys(monkeypatch):
    monkeypatch.setattr(run, "card", lambda chips: torch.device("cpu"))
    monkeypatch.setattr(spec, "cell", small_cell)
    real = run.make_lap
    monkeypatch.setattr(run, "make_lap", lambda *a, **k: real(*a, **dict(k, limit=LAP)))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "lio_mid360_replay", "--seed", str(SEED),
                       "--seconds", "1", "--trace", "0"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"host_cpu_per_sensor_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(replay_cell().checks["numbers"])
    tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_without_a_card_it_prints_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "lvi_mid360_imx219_stream", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and out.getvalue() == "" and "no CUDA device" in err.getvalue()
    with pytest.raises(run.NoCard):  # the measuring path never falls back to the CPU
        run.run_cell("lvi_mid360_imx219_stream", 1, 1.0, False)


def test_the_module_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("jax_free_helper", "lvislam_tpu_torch.fake", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = run.forbidden_modules()
    assert not {"jax_free_helper", "lvislam_tpu_torch.fake", "flaxen"} & set(found)
    monkeypatch.setitem(sys.modules, "lvislam_tpu.core", types.ModuleType("lvislam_tpu.core"))
    assert "lvislam_tpu.core" in run.forbidden_modules()


def test_a_sound_run_is_correct():
    out = cpu_run()
    assert out["correct"] and out["failed"] == 0, out["checks"]


def _unchanged(real):
    def step(state, packed, odom_override=None, **kw):
        _, out = real(state, packed, odom_override, **kw)
        return state, out._replace(x6=state.x6)
    return step


FIRST_IN_WINDOW = int(LIO_WARM_S * 10 / 2) + 1  # the 7th mapped sweep


def _altered(real, at, delta=(0, 0, 0.2, 0, 0, 0.0)):
    calls = []

    def step(state, packed, odom_override=None, **kw):
        state, out = real(state, packed, odom_override, **kw)
        calls.append(1)
        if len(calls) == at:  # an answer altered where it is made
            out = out._replace(x6=out.x6 + torch.tensor(delta, dtype=out.x6.dtype))
        return state, out
    return step


def _drifting(real, start=FIRST_IN_WINDOW, rate=0.02):
    """Every answer from the window's first on altered where it is made:
    its heading off by `rate` rad more with each mapped sweep."""
    calls = []

    def step(state, packed, odom_override=None, **kw):
        state, out = real(state, packed, odom_override, **kw)
        calls.append(1)
        k = len(calls) - start + 1
        if k > 0:
            out = out._replace(x6=out.x6 + torch.tensor([0, 0, rate * k, 0, 0, 0],
                                                        dtype=out.x6.dtype))
        return state, out
    return step


def _half_batch(real_batch):
    def batch(state, arr, **kw):
        return real_batch(state, arr[: arr.shape[0] // 2], **kw)
    return batch


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answers"])
def test_each_fault_makes_correct_false(monkeypatch, fault):
    from lvislam_tpu_torch.models.lio import pipeline

    if fault == "half_batch":
        monkeypatch.setattr(pipeline, "lio_batch_step", _half_batch(pipeline.lio_batch_step))
    else:  # the replay's check is a median: a fault that runs through the window
        wrap = _unchanged if fault == "unchanged_state" else _drifting
        monkeypatch.setattr(pipeline, "lio_full_step", wrap(pipeline.lio_full_step))
    out = cpu_run()
    assert not out["correct"], out["checks"]


def test_the_control_makes_correct_false():
    """Deskew off (every point at its sweep's start time) across the
    figure-8's first turn: the median change of heading over 5 s passes its
    limit."""
    out = cpu_run(seconds=9.0, control="deskew_off", lap=None)
    c = out["checks"]["lio_rel_yaw_median_err_rad"]
    assert not out["correct"] and np.isfinite(c["value"]) and c["value"] > c["limit"], c


def _vio_unchanged(real):
    """The VIO's frame step returning its state and frame count unchanged."""
    def step(tracker, vio, *a, frame_count, **kw):
        tr, _, tout, depth, summary, _ = real(tracker, vio, *a, frame_count=frame_count, **kw)
        return tr, vio, tout, depth, summary, frame_count
    return step


def _frame_lost(real):
    """The frame handler failing on every second frame, before any answer."""
    calls = []

    def step(*a, **kw):
        calls.append(1)
        if len(calls) % 2 == 0:
            raise RuntimeError("frame lost")
        return real(*a, **kw)
    return step


@pytest.mark.parametrize("fault", ["unchanged_state", "altered_answer", "vio_unchanged_state",
                                   "frame_lost"])
def test_each_fault_makes_the_fused_cell_incorrect(monkeypatch, fault):
    """The fused cell with its timed path broken underneath the system: the
    LIO step (the scan handler takes its pose; 10 mapped sweeps, one in two
    by the 0.15 s throttle, precede the altered 11th), or the VIO's frame
    step (its state never advancing, so no frame of the window has an
    estimate; or every second frame lost unanswered)."""
    from lvislam_tpu_torch.models.lio import pipeline
    from lvislam_tpu_torch.models.vio import frame_step as fs

    if fault in ("unchanged_state", "altered_answer"):
        real = pipeline.lio_full_step
        step = _unchanged(real) if fault == "unchanged_state" else _altered(real, at=11)
        monkeypatch.setattr(pipeline, "lio_full_step", step)
    else:
        wrap = _vio_unchanged if fault == "vio_unchanged_state" else _frame_lost
        monkeypatch.setattr(fs, "frame_step", wrap(fs.frame_step))
    out = cpu_run("lvi_mid360_imx219_stream", seconds=3.0, lap=40)
    assert not out["correct"], out["checks"]
