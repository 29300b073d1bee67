"""The kernels' work from their shapes: the port's kernel-table counts at
the main path's shapes, and the shapes the configurations give are those
the LIO step really launches K1 and K2 with."""

import json

import numpy as np
import pytest

from benchmark import roofline, spec


def config(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["program"]


def test_counts_at_the_main_paths_shapes():
    """``chip_smoke.py`` phase 8's bytes (PERF.md: K1 11.8 MB, K2 0.33 MB,
    K3 2.4 MB, K4 4.8 MB) and bounds."""
    lvi = config("lvi_mid360_imx219")
    k1, k2, k3, k4 = (roofline.launch_work(k, lvi) for k in ("K1", "K2", "K3", "K4"))
    assert k1 == (11_825_152, (512 * 32 + 2048 * 16) * 27 * 8)
    assert k2 == (328_008, 512 * 450 + 2048 * 600)
    assert k3 == (2_424_832, 3 * 576 * 1024)
    assert k4 == (4_784_128, 12 * 576 * 1024)
    assert roofline.launch_work("K1", config("lio_mid360")) == k1
    assert roofline.bound_us(*k1) == pytest.approx(3.530, abs=1e-3)
    assert roofline.bound_us(*k2) == pytest.approx(0.098, abs=1e-3)
    assert roofline.bound_us(*k3) == pytest.approx(0.724, abs=1e-3)
    assert roofline.bound_us(*k4) == pytest.approx(1.428, abs=1e-3)


def test_share_reads_nothing_without_launches():
    assert roofline.share_pct("K1", config("lio_mid360"), []) is None
    assert roofline.share_pct("K1", config("lio_mid360"), [3.530, 3.530]) == pytest.approx(
        100.0, rel=1e-3)


def test_the_lio_step_launches_the_configured_shapes(monkeypatch):
    """One LIO step on the CPU with K1's and K2's entry points recorded:
    their inputs' shapes and bytes are those ``roofline`` counts."""
    from benchmark import system
    from benchmark.gen import stream
    from lvislam_tpu_torch.models.lio.pipeline import LioPipeline
    from lvislam_tpu_torch.ops import gn_partials as gnp
    from lvislam_tpu_torch.ops import knn_tail as kt

    seen = {"K1": [], "K2": []}
    k1, k2 = kt.knn_tail_batched, gnp.gn_partials_pair_batched

    def rec_k1(sets, S, k=5):
        seen["K1"].append([(s[0].shape[0], s[3], sum(t.numel() * t.element_size()
                                                      for t in s[:3])) for s in sets])
        return k1(sets, S, k=k)

    def rec_k2(c_pts, c_nbr, s_pts, s_nbr, par):
        seen["K2"].append((c_pts.shape[-1], s_pts.shape[-1],
                           sum(t.numel() * t.element_size() for t in (c_pts, c_nbr, s_pts,
                                                                      s_nbr))))
        return k2(c_pts, c_nbr, s_pts, s_nbr, par)

    monkeypatch.setattr(kt, "knn_tail_batched", rec_k1)
    monkeypatch.setattr(gnp, "gn_partials_pair_batched", rec_k2)
    prog = config("lio_mid360")
    conf = json.loads((spec.HERE / "configs" / "lio_mid360.json").read_text())
    traffic = json.loads((spec.HERE / "traffic" / "lio_replay_b8.json").read_text())
    pipe = LioPipeline(system.program_config(conf, {"transport": {}}), device="cpu")
    lap = stream.lio_lap(0, traffic["motion"], dict(traffic["lidar"], n_scan=4, horizon=6000),
                         "cpu", limit=3)
    for i in range(3):
        pipe.process_scan(*system.scan_inputs(lap, i)[1])
    assert seen["K1"] and seen["K2"]
    caps = prog["caps"]
    want = [(caps["scan_corner"], caps["hash_bucket"]), (caps["scan_surf"],
                                                         caps["surf_hash_bucket"])]
    for launch in seen["K1"]:
        assert [(q, b) for q, b, _ in launch] == want
        ins = sum(n for _, _, n in launch)
        assert ins + sum(q * roofline.K_NEIGHBOURS * 8 for q, _ in want) == (
            roofline.launch_work("K1", prog)[0])
    for nc, ns, n in seen["K2"]:
        assert (nc, ns) == (caps["scan_corner"], caps["scan_surf"])
        assert n + (roofline.K2_POSE_FLOATS + roofline.K2_OUT_FLOATS) * 4 == (
            roofline.launch_work("K2", prog)[0])
    assert np.isfinite(pipe.trajectory_array()).all()
