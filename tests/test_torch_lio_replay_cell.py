"""The LIO replay cell as ``BENCHMARK.json`` declares it, run through the
harness on the CPU at a test's size (its warm span cut to 6 mapped sweeps,
as ``benchmark/tests/test_bench_run.py`` cuts it): the cell drives the
configuration with a loop slot a keyframe, a sound run is correct, and the
``deskew_off`` control is not."""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from benchmark import run, spec

CELL = "lio_mid360_replay"
SEED = 2**31 + 101  # a large seed, past what 32 signed bits hold
LAP = 400  # the replay's whole lap; the window stops short of it
LIO_WARM_S = 1.2  # 6 mapped sweeps, not the cell's two laps
REAL_CELL = spec.cell


def small_cell(name, root=spec.ROOT):
    c = REAL_CELL(name, root)
    if name == CELL:
        c.traffic = dict(c.traffic, warm_s=LIO_WARM_S)
    return c


def cpu_run(seconds=6.0, control=None, lap=LAP):
    torch.set_num_threads(1)
    with mock.patch.object(spec, "cell", small_cell):
        out = run.run_cell(CELL, SEED, seconds, False, device="cpu", control=control,
                           lap_limit=lap)
    scans = LIO_WARM_S * 10 + 2 * out["attempted"]  # every other sweep mapped
    assert lap is None or scans < lap  # the window never wrapped the lap
    return out


def test_the_cell_drives_a_loop_slot_a_keyframe():
    c = spec.cell(CELL)
    caps = c.config["program"]["caps"]
    assert c.config["name"] == "lio_mid360_every_loop"
    assert caps["max_loops"] == caps["max_keyframes"] == 512
    assert c.traffic["transport"]["upload_batch"] == 8 and c.chips == 1
    assert {m["name"] for m in c.end_to_end} == {"host_cpu_per_sensor_s", "setup_s"}
    assert {m["name"] for m in c.per_layer} >= {"lio.step_ms", "lio.posegraph_ms", "k1_roofline"}


def test_a_sound_run_of_the_cell_is_correct():
    out = cpu_run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]
    assert set(out["metrics"]) == {"host_cpu_per_sensor_s", "setup_s"}


def test_the_control_makes_the_cell_incorrect():
    """Deskew off across the figure-8's first turn: the median change of
    heading over 5 s passes its limit. The window is long enough for pairs
    5 s of sensor time apart on a loaded host."""
    out = cpu_run(seconds=15.0, control="deskew_off", lap=None)
    c = out["checks"]["lio_rel_yaw_median_err_rad"]
    assert not out["correct"] and np.isfinite(c["value"]) and c["value"] > c["limit"], c
