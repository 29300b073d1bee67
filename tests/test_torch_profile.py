"""The port's profiling tool (``lvislam_tpu_torch.scripts.profile``): each
subcommand at a toy size on the CPU, through its command line, and without
a card it raises."""

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lvislam_tpu_torch.scripts import profile  # noqa: E402

torch.set_num_threads(1)


def run(capsys, *argv) -> dict:
    """The subcommand on the CPU: its JSON lines by item, checked against
    the records it returns."""
    recs = profile.main([*argv, "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
             if x.startswith("{")]
    assert lines == recs and recs[-1]["item"] == "summary"
    assert all(r["cmd"] == argv[0] for r in recs)
    return {r["item"]: r for r in recs}


def test_stages(capsys):
    """`stages` after 2 warm scans: the whole step of the three kinds and
    every stage timed; no device time on the CPU; the stages' sum against
    the whole step in the summary."""
    got = run(capsys, "stages", "--warm", "2", "--reps", "1")
    items = ("step_nonkf", "step_kf_incremental", "step_kf_rebuild", "unpack", "project",
             "features", "downsample", "gn", "map_nonkf", "map_kf_incremental", "map_kf_rebuild")
    assert all(got[k]["ms"] > 0 and got[k]["device_ms"] is None for k in items)
    assert got["gn"]["host_syncs"] >= 1 and got["unpack"]["host_syncs"] == 0
    s = got["summary"]
    assert s["scans_warm"] == 2 and s["keyframes_warm"] >= 1
    assert s["stages_ms"] == pytest.approx(sum(got[k]["ms"] for k in
                                               ("unpack", "project", "features", "map_nonkf")),
                                           abs=1e-3)
    assert s["sum_over_whole"] > 0 and s["device_sum_over_whole"] is None


def test_replay(capsys):
    """`replay` at the parity configuration fed 1.7 s (the replay active)
    with batches of 4: the four batch kinds, the upload and readback, and
    the frame branch's six parts."""
    got = run(capsys, "replay", "--seconds", "1.7", "--batch", "4", "--reps", "1")
    for k in ("batch_noop", "batch_scan", "batch_frame", "batch_mixed"):
        assert got[k]["per_event_ms"] == pytest.approx(got[k]["ms"] / 4, abs=1e-3)
    assert got["batch_frame"]["ms"] > got["batch_noop"]["ms"]
    assert got["upload"]["MB"] > 0 and got["readback"]["KB"] > 0
    for k in ("tracker", "depth", "ba", "triangulation", "marginalization", "process_imu"):
        assert got["frame_" + k]["ms"] > 0
    assert got["summary"]["batch"] == 4 and got["summary"]["cycle_device_ms"] is None


def test_transport(capsys):
    """`transport` over 10 timed scans at upload_batch 8: one full batch
    dispatched and the partial one flushed (two uploads after the warm
    one), a pack a scan."""
    got = run(capsys, "transport", "--scans", "12", "--warm", "2")
    assert got["pack"]["calls"] == 10 and got["upload"]["calls"] == 2
    assert got["dispatch"]["calls"] == 1 and got["process_scan"]["calls"] == 10
    s = got["summary"]
    assert s["scans_timed"] == 10 and s["uploads"] == 3 and s["upload_batch"] == 8
    assert s["wall_ms_per_scan"] > 0 and s["device_ms_per_scan"] is None


def test_query(capsys):
    """`query` at 4096 map points and 256 queries: K1's wrapper (its plain
    version on the CPU), the plain version and `torch.topk` select the same
    neighbours."""
    got = run(capsys, "query", "--queries", "256", "--points", "4096", "--reps", "1")
    assert all(got[k]["ms"] > 0 for k in ("wrapper", "plain", "topk"))
    s = got["summary"]
    assert s["selections_equal"] and s["wrapper_vs_plain"] and s["topk_vs_plain"]
    assert 0.0 < s["found_share"] <= 1.0


def test_without_a_card_it_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.main(["query", "--queries", "8", "--points", "64"])
