"""The port's benchmark (``lvislam_tpu_torch.scripts.bench`` and its
``bench_inputs``) against ``bench.py``: the configurations field for field,
the LIO section's first scans byte for byte, the ``imu`` section's inputs,
and the script's own behaviour on the CPU (the headline record, a section
that raises, no card, ``config_sha``)."""

import copy
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import bench as jbench  # noqa: E402
from lvislam_tpu_torch.scripts import bench  # noqa: E402
from lvislam_tpu_torch.scripts import bench_inputs as bi  # noqa: E402
from lvislam_tpu_torch.utils import anchors, convert  # noqa: E402

torch.set_num_threads(1)

HEADLINE = ("metric", "value", "unit", "per_scan_ms", "ate_rmse_m", "scans", "backend",
            "ate_cpu_ref_m", "ate_vs_cpu_ref_pct")
TOY_LIO = ["--lio-warm", "2", "--lio-segment", "2", "--lio-segments", "1"]


def test_lio_config_equals_bench_make_cfg():
    """The headline's configuration (`full_width_config` at upload_batch 8)
    equals `bench._make_cfg(mapping, pallas=True)` through `utils/convert`,
    field for field, apart from `pallas_gn`: on in the port (its K2 is
    bit-equal to the plain path), off in `bench.py:209`."""
    from lvislam_tpu.models.lio import mapping

    jcfg = convert.config_from_jax(jbench._make_cfg(mapping, pallas=True))
    cfg = bench.run_configs(bench.parse_args(["--sections", "lio"]))[0]["lio"]
    assert jcfg.caps.pallas_gn is False and cfg.caps.pallas_gn is True
    want = dataclasses.replace(jcfg, caps=dataclasses.replace(jcfg.caps, pallas_gn=True))
    assert anchors.config_fields(cfg) == anchors.config_fields(want)
    assert cfg.upload_batch == 8


def test_first_scans_byte_equal_to_bench():
    """The LIO section's first 3 inputs (`bench_inputs.scan_jobs`, the
    port's raycaster) are `bench._gen_scans`'s on the JAX package's
    synthetic world, byte for byte."""
    from lvislam_tpu.utils import synthetic as jsyn

    ref = jbench._gen_scans(3, bi.RATE, jsyn.default_world(seed=0),
                            jsyn.figure8_trajectory(scale=3.0, period=40.0))
    got = bi.Prefetch(None, *bi.scan_jobs(3)).get()
    assert len(got) == len(ref) == 3
    for (scan, it, w, rpy), (jscan, jit, jw, jrpy) in zip(got, ref):
        assert scan.keys() == jscan.keys()
        for k in scan:
            a, b = np.asarray(scan[k]), np.asarray(jscan[k])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
        for a, b in ((it, jit), (w, jw), (rpy, jrpy)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_lvi_parity_config_equals_bench_system():
    """The `lvi` section's configuration is `bench.py:_lvi_build_system`'s:
    `make_system(pallas=True)` with `replay_batch = 16` and
    `apply_perf_knobs(pallas=True)`, field for field."""
    from test_lvi_system import make_system

    s = make_system(pallas=True)
    s.cfg.replay_batch = 16
    jbench.apply_perf_knobs(s, pallas=True)
    cfg = bench.run_configs(bench.parse_args(["--sections", "lvi"]))[0]["lvi"]
    assert anchors.config_fields(cfg) == anchors.config_fields(s.cfg)


def jax_full_scale_config():
    """`bench.py:692-733`'s configuration on an accelerator (its section
    builds it inline): the JAX package's `LviConfig`."""
    from scipy.spatial.transform import Rotation as Rsc

    from lvislam_tpu.core.config import CameraIntrinsics
    from lvislam_tpu.models import pipeline as lvi
    from lvislam_tpu.models.lio import mapping
    from lvislam_tpu.models.loop import loop_detector as ld
    from lvislam_tpu.models.vio import estimator as est
    from lvislam_tpu.models.vio import feature_manager as fm
    from lvislam_tpu.models.vio import feature_tracker as ft
    from lvislam_tpu.ops import ba
    from lvislam_tpu.utils import synthetic as syn

    cam = CameraIntrinsics()
    R_BC = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]).T
    qic = np.roll(Rsc.from_matrix(R_BC).as_quat(), 1)
    lio_cfg = jbench._make_cfg(mapping, pallas=True)
    lio_cfg.caps = dataclasses.replace(lio_cfg.caps, pallas_gn=True)
    lio_cfg.loop_every_n_scans = 10
    lio_cfg.upload_batch = 1
    cfg = lvi.LviConfig(
        lio=lio_cfg,
        vio_caps=fm.VioCaps(window=10, max_features=150, imu_buf=32, frame_features=150),
        vio_params=est.VioParams(g_norm=syn.GRAVITY),
        ba=ba.BAConfig(window=10, max_features=150, iterations=4, solver="schur",
                       estimate_td=False, estimate_extrinsic=False),
        tracker=ft.TrackerParams(), camera=cam,
        loop_caps=ld.LoopCaps(max_keyframes=128, window_points=150, extra_points=256,
                              recent_exclude=10, min_loop_matches=25),
        image_height=cam.image_height, image_width=cam.image_width,
        use_lidar_depth=True, lidar_skip=3, use_loop_detector=True,
        mapping_process_interval=0.15, qic=tuple(qic.tolist()))
    cfg.replay_batch = 16
    return cfg


def test_full_scale_config_equals_bench():
    """The `full_scale` section's configuration (`lvi_full_config` at
    `replay_batch = 16`) is `bench.py:692-733`'s, field for field."""
    cfg = bench.run_configs(bench.parse_args(["--sections", "full_scale"]))[0]["full_scale"]
    assert anchors.config_fields(cfg) == anchors.config_fields(jax_full_scale_config())


def test_loop_configs_equal_bench():
    """The `loop` section's two arms are `bench.py:828-836`'s: the `lvi`
    configuration with 192 keyframes and 16 loop slots, the second arm with
    the LIS loop detector off."""
    from test_lvi_system import make_system

    cfgs = bench.run_configs(bench.parse_args(["--sections", "loop"]))[0]
    for loop_on, name in ((True, "loop"), (False, "noloop")):
        s = make_system(pallas=True)
        s.cfg.replay_batch = 16
        jbench.apply_perf_knobs(s, pallas=True)
        s.cfg.lio.caps = dataclasses.replace(s.cfg.lio.caps, max_keyframes=192, max_loops=16)
        if not loop_on:
            s.cfg.lio.loop_closure_enabled = False
        assert anchors.config_fields(cfgs[name]) == anchors.config_fields(s.cfg), name


def test_imu_inputs_equal_bench():
    """The `imu` section's start state and inputs are `bench.py:343-360`'s
    (forward-difference velocity, scipy's quaternion, gravity 9.805) bit for
    bit."""
    from lvislam_tpu.utils import synthetic as jsyn

    dur, hz = 60.0, 200
    traj = jsyn.figure8_trajectory(scale=3.0, period=40.0)
    ts = (np.arange(int(dur * hz)) + 1) / hz
    gyrs, accs = traj.imu(ts)
    p0, R0 = traj.pose(ts[:1])
    v0 = (traj.pose(ts[:1] + 1e-4)[0] - p0) / 1e-4
    want = (np.asarray(p0[0], np.float32), np.asarray(jbench.lie_mat_to_quat(R0[0]), np.float32),
            np.asarray(v0[0], np.float32), np.full(len(ts), np.float32(1.0 / hz)),
            np.asarray(accs, np.float32), np.asarray(gyrs, np.float32),
            np.array([0.0, 0.0, -9.805], np.float32))
    got = bi.imu_inputs(dur, hz)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def last_record(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_cpu_run_prints_the_headline(capsys):
    """A CPU run of the headline at a toy depth (2 warm scans, one segment
    of 2) ends in one JSON line that holds `bench.py`'s headline keys, the
    configuration hash, and the host syncs and launches beside the wall
    time; exit 0."""
    rc = bench.main(["--device", "cpu", "--sections", "lio", "--workers", "0", *TOY_LIO])
    out = last_record(capsys.readouterr().out)
    assert rc == 0
    assert all(k in out for k in HEADLINE), [k for k in HEADLINE if k not in out]
    assert out["metric"] == "lio_real_time_factor" and out["backend"] == "cpu"
    assert out["scans"] == 2 and out["lio_uploads"] == 2
    assert np.isfinite(out["ate_rmse_m"]) and out["value"] > 0
    assert out["ate_cpu_ref_anchor"] == "bench_anchors.json:ate_cpu_ref_m"
    assert out["per_scan_host_syncs"] > 0 and out["per_scan_launches"]["K1"] == 0
    assert len(out["config_sha"]) == 16 and out["device"] == "cpu"


def test_section_error_recorded_and_exit_nonzero(capsys, monkeypatch):
    """A section that raises is recorded as `<name>_error` (the next one
    still runs) and the script exits non-zero."""
    def boom(*a, **kw):
        raise FloatingPointError("injected")

    monkeypatch.setattr(bench, "imu_section", boom)
    rc = bench.main(["--device", "cpu", "--sections", "imu,vio", "--workers", "0",
                     "--reps", "1"])
    out = last_record(capsys.readouterr().out)
    assert rc != 0
    assert "injected" in out["imu_error"] and "imu_dead_reckon_rtf" not in out
    assert "vio_ba_solve_ms" in out and "vio_error" not in out


def test_budget_skips_a_section(capsys):
    """A section the wall budget cannot hold is recorded as
    `<name>_skipped` with the reason, and the run exits 0."""
    rc = bench.main(["--device", "cpu", "--sections", "imu", "--workers", "0", "--budget", "1"])
    out = last_record(capsys.readouterr().out)
    assert rc == 0 and out["imu_skipped"].startswith("budget(")


def test_without_a_card_it_raises():
    """Without `--device cpu` the bench runs on the card, and without one
    it raises before anything runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--sections", "imu", "--workers", "0"])


def _leaves(x, path=()):
    """Every leaf field of a dataclass tree (or a stream's dict) as a path."""
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), path + (f.name,))
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, x


def _changed(v):
    if isinstance(v, bool):
        return not v
    if isinstance(v, (int, float)):
        return v * 2 + 1
    if isinstance(v, str):
        return v + "_"
    if isinstance(v, tuple):
        return v + (0,)
    return 1 if v is None else None


def _set(root, path, value):
    obj = root
    for name in path[:-1]:
        obj = obj[name] if isinstance(obj, dict) else getattr(obj, name)
    if isinstance(obj, dict):
        obj[path[-1]] = value
    else:
        object.__setattr__(obj, path[-1], value)


@pytest.mark.parametrize("name", ["lio", "lvi", "vio_ba", "vio_tracker", "vio_camera", "euroc",
                                  "full_scale", "loop", "noloop", "streams"])
def test_config_sha_changes_with_every_field(name):
    """`config_sha` hashes every field of every configuration the run uses
    and the streams' parameters: changing any one leaf of the named one
    changes it (`bench.py:442` hashed none of its knobs)."""
    configs, streams = bench.run_configs(bench.parse_args([]))
    base = bench.config_sha(configs, streams)
    target = streams if name == "streams" else configs[name]
    paths = list(_leaves(target))
    assert len(paths) >= 5
    for path, v in paths:
        c2, s2 = copy.deepcopy(configs), copy.deepcopy(streams)
        _set(s2 if name == "streams" else c2[name], path, _changed(v))
        assert bench.config_sha(c2, s2) != base, (name, path)


def test_fused_sections_at_a_toy_depth(capsys):
    """`lvi`, `euroc` and `loop` on the CPU at toy depths (2.4 s of the
    fused streams: the VIO comes up by 1.15 s, so the replay runs; 1.5 s of
    the EuRoC fixture), raycast by two workers: every `bench.py` key of the
    three sections (`vio_euroc_ate_m` null: no 10 TUM rows at this depth),
    exit 0."""
    rc = bench.main(["--device", "cpu", "--sections", "lvi,euroc,loop", "--workers", "2",
                     "--lvi-seconds", "2.4", "--euroc-seconds", "1.5", "--loop-seconds", "2.4"])
    out = last_record(capsys.readouterr().out)
    keys = ("lvi_rtf_measured", "lvi_ate_rmse_m", "lvi_vio_initialized", "lvi_replay_active",
            "lvi_ate_cpu_ref_m", "lvi_ate_vs_cpu_ref_pct", "lvi_ate_cpu_exact_m",
            "lvi_knob_cost_pct", "vio_euroc_init", "vio_euroc_failures", "vio_euroc_ate_m",
            "lvi_loop_rtf",
            "lvi_loop_ate_m", "lvi_loop_count", "lvi_loop_kf_ate_m", "lvi_noloop_kf_ate_m",
            "lvi_loop_kf_ate_delta_m")
    assert rc == 0 and not [k for k in out if k.endswith(("_error", "_skipped"))]
    assert [k for k in keys if k not in out] == []
    assert out["lvi_vio_initialized"] and out["lvi_replay_active"]
    assert out["lvi_host_syncs"] > 0 and out["lvi_launches"]["K1"] == 0
    assert out["inputs_s"] >= 0
