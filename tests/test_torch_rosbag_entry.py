"""The port's bag-replay entry point (``python -m
lvislam_tpu_torch.scripts.run_rosbag_lvi``) against the JAX package's
``scripts/run_rosbag_lvi.py`` on the committed fixture bag: the
configuration both build from the fixture YAMLs, the first second of the
replay on the CPU against the JAX run's stored poses, the TUM and map
outputs, and (slow) the JAX script's own reference values over the whole
bag (``utils/anchors.ROSBAG_FIXTURE``)."""

import os
import sqlite3
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lvislam_tpu_torch.utils import anchors, convert  # noqa: E402

torch.set_num_threads(1)

DATA = ROOT / "tests" / "data"
BAG = str(DATA / "fixture_mid360.db3")
LIDAR_YAML = str(DATA / "fixture_lidar.yaml")
CAMERA_YAML = str(DATA / "fixture_camera.yaml")
YAML_ARGS = ["--lidar-yaml", LIDAR_YAML, "--camera-yaml", CAMERA_YAML]


def bag_t0() -> float:
    """The stamp (s) of the bag's first message: both scripts feed t - t0."""
    conn = sqlite3.connect(BAG)
    try:
        return conn.execute("SELECT MIN(timestamp) FROM messages").fetchone()[0] * 1e-9
    finally:
        conn.close()


def fixture_truth_positions(stamps, t0):
    """The fixture's ground truth (`scripts/make_fixture_bag.py`: world seed 0,
    figure-8 scale 3 m, period 30 s) at bag-relative stamps."""
    from lvislam_tpu_torch.utils import synthetic as syn

    traj = syn.figure8_trajectory(scale=3.0, period=30.0)
    return np.stack([traj.pose(np.array([t + t0]))[0][0] for t in stamps])


def load_script(name: str):
    """A module of `scripts/` loaded from its file (putting `scripts/` on
    sys.path would shadow standard modules: it holds a `profile.py`)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture_jax_systems(monkeypatch, stop: bool):
    """Patch the JAX `LviSystem` so the JAX script's system is recorded
    (with `stop`, its configuration is recorded and the script stopped
    before the system is built). Returns the list it records into."""
    import lvislam_tpu.models.pipeline as jp

    made = []

    class Captured(jp.LviSystem):
        def __init__(self, cfg, *a, **kw):
            if stop:
                made.append(cfg)
                raise _Stop
            super().__init__(cfg, *a, **kw)
            made.append(self)

    monkeypatch.setattr(jp, "LviSystem", Captured)
    return made


class _Stop(Exception):
    pass


def run_jax_script(argv, monkeypatch, config_only: bool = False):
    """`scripts/run_rosbag_lvi.py`'s main with `argv`; returns the JAX
    `LviSystem` it ran, or with `config_only` the `LviConfig` it built."""
    jscript = load_script("run_rosbag_lvi")
    made = _capture_jax_systems(monkeypatch, stop=config_only)
    monkeypatch.setattr(sys, "argv", ["run_rosbag_lvi.py", *argv])
    monkeypatch.chdir(ROOT)
    try:
        jscript.main()
    except _Stop:
        pass
    return made[0]


CONFIGS = {"fixture": YAML_ARGS,
           "shipped": ["--lidar-yaml", str(ROOT / "configs" / "params_lidar.yaml"),
                       "--camera-yaml", str(ROOT / "configs" / "params_camera.yaml")],
           "fixture_no_camera": [*YAML_ARGS, "--no-camera"],
           "defaults": []}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_script_config_equals_jax(name, monkeypatch):
    """The `LviConfig` the port's script builds from the YAML files is the
    JAX script's, converted, field for field; the fixture's is the stored
    one (`anchors.ROSBAG_FIXTURE`, which phase 16 of chip_smoke.py holds the
    card's run to)."""
    from lvislam_tpu_torch.core.config import load_yaml
    from lvislam_tpu_torch.scripts import run_rosbag_lvi as tscript

    argv = [BAG, *CONFIGS[name]]
    jcfg = run_jax_script(argv, monkeypatch, config_only=True)
    args = tscript.parse_args(argv)
    cfg = tscript.lvi_config(load_yaml(args.lidar_yaml, args.camera_yaml), args.no_camera)
    assert cfg == convert.lvi_config_from_jax(jcfg)
    assert anchors.config_fields(cfg) == anchors.config_fields(jcfg)
    assert not (cfg.lio.caps.pallas_knn or cfg.lio.caps.pallas_gn)  # K1, K2 off, as in JAX
    if name == "fixture":
        assert anchors.config_fields(cfg) == anchors.ROSBAG_FIXTURE["config"]
        assert anchors.config_sha256(cfg) == anchors.ROSBAG_FIXTURE["config_sha256"]


def test_script_first_second_on_cpu_against_jax(tmp_path):
    """`--max-seconds 1 --device cpu` over the fixture bag: the TUM file and
    the saved map, the messages fed, and the poses against the JAX script's
    run of the same second (`anchors.ROSBAG_FIXTURE["prefix"]`) within the
    slice-1 LIO bounds: 25 mm a position, 2 mrad an angle (the VIO has not
    initialized yet: these are LIO poses)."""
    from lvislam_tpu_torch.scripts import run_rosbag_lvi as tscript

    ref = anchors.ROSBAG_FIXTURE
    out, map_dir = str(tmp_path / "traj.tum"), str(tmp_path / "map")
    r = tscript.main([BAG, *YAML_ARGS, "--max-seconds", str(ref["prefix_seconds"]),
                      "--device", "cpu", "--out", out, "--save-map", map_dir])
    sys_ = r["system"]
    assert sys_.device.type == "cpu"
    assert r["messages"] == {"imu": 201, "livox": 10, "image": 10}
    assert r["skipped"] == 0 and r["t0"] == ref["t0"] == bag_t0()
    tum = np.loadtxt(out)
    assert tum.ndim == 2 and tum.shape == (len(sys_.trajectory), 8)
    assert tum.shape[0] >= 3 and np.isfinite(tum).all()
    assert (np.diff(tum[:, 0]) > 0).all()
    assert any(f.endswith(".pcd") for f in os.listdir(map_dir))
    assert r["map"]["n_keyframes"] == int(sys_.lio.state.kf_count) >= 1
    got = np.array([[t, *x6] for t, x6 in sys_.trajectory], np.float64)
    want = np.array(ref["prefix"], np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[:, 4:7], want[:, 4:7], rtol=0, atol=25e-3)
    np.testing.assert_allclose(got[:, 1:4], want[:, 1:4], rtol=0, atol=2e-3)
    # the TUM rows are the trajectory's positions and the rotation of x6
    np.testing.assert_allclose(tum[:, 1:4], got[:, 4:7], rtol=0, atol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present: the script would use it")
def test_script_runs_on_the_card_unless_told():
    """No `--device`: the card, and without one it raises (no CPU fallback)."""
    from lvislam_tpu_torch.scripts import run_rosbag_lvi as tscript

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscript.main([BAG, *YAML_ARGS, "--max-seconds", "0.1"])


def test_module_entry_point(tmp_path):
    """`python -m lvislam_tpu_torch.scripts.run_rosbag_lvi`: its help names
    `--device`; with no card and no `--device` it exits non-zero."""
    import subprocess

    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PYTHONPATH"] = str(ROOT)
    cmd = [sys.executable, "-m", "lvislam_tpu_torch.scripts.run_rosbag_lvi"]
    r = subprocess.run([*cmd, "--help"], cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "--device" in r.stdout and "--save-map" in r.stdout
    if not torch.cuda.is_available():
        r = subprocess.run([*cmd, BAG, *YAML_ARGS, "--out", str(tmp_path / "t.tum")],
                           cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        assert not (tmp_path / "t.tum").exists()


# One-ulp changes of the bag's inputs as the JAX script reads them: the IMU's
# gyro or accelerometer (float32, as the system takes them) or every scan
# point, one float32 step up or down. They measure the JAX run's own spread.
def _nudge(x, up: bool):
    x32 = np.asarray(x, np.float32)
    return np.nextafter(x32, np.float32(np.inf if up else -np.inf)).astype(np.asarray(x).dtype)


ONE_ULP = {"gyro_up": ("imu", "gyro", True), "acc_up": ("imu", "acc", True),
           "xyz_up": ("livox", "xyz", True), "xyz_down": ("livox", "xyz", False)}


def jax_fixture_ate(tmp_path, monkeypatch, nudge=None):
    """The JAX script over the whole fixture bag (inputs nudged by one
    `ONE_ULP` entry, or not): (system, aligned ATE of its TUM file)."""
    from lvislam_tpu.utils import bag as jbag
    from lvislam_tpu_torch.utils.metrics import ate_rmse

    if nudge is not None:
        kind, key, up = ONE_ULP[nudge]
        for typ, (k, fn) in list(jbag._PARSERS.items()):
            if k == kind:
                def parse(buf, fn=fn):
                    msg = fn(buf)
                    msg[key] = _nudge(msg[key], up)
                    return msg
                monkeypatch.setitem(jbag._PARSERS, typ, (k, parse))
    out = str(tmp_path / f"full_{nudge}.tum")
    jsys = run_jax_script([BAG, *YAML_ARGS, "--out", out], monkeypatch)
    monkeypatch.undo()
    tum = np.loadtxt(out)
    gt = fixture_truth_positions(tum[:, 0], bag_t0())
    return jsys, float(ate_rmse(tum[:, 1:4].astype(np.float64), gt, align=True))


@pytest.mark.slow
def test_jax_script_fixture_anchor(tmp_path, monkeypatch):
    """The JAX script over the whole fixture bag and over its first second on
    the CPU: message counts, the frames' sha256 (PIL), the configuration's
    fields and sha256, the aligned ATE against the ground truth, the same
    with each `ONE_ULP` input change, and the first second's poses; equal to
    ``anchors.ROSBAG_FIXTURE`` (``-s`` prints them)."""
    import hashlib
    import pprint

    from lvislam_tpu.utils.bag import Rosbag2Reader

    counts, h = {}, hashlib.sha256()
    reader = Rosbag2Reader(BAG)
    for _, _, kind, msg in reader:
        counts[kind] = counts.get(kind, 0) + 1
        if kind == "image":
            h.update(np.ascontiguousarray(msg["image"]).tobytes())
    jsys, ate = jax_fixture_ate(tmp_path, monkeypatch)
    spread = {name: jax_fixture_ate(tmp_path, monkeypatch, name)[1] for name in ONE_ULP}
    pre = run_jax_script([BAG, *YAML_ARGS, "--out", str(tmp_path / "pre.tum"),
                          "--max-seconds", "1"], monkeypatch)
    got = {
        "messages": counts, "skipped": reader.skipped, "t0": bag_t0(),
        "frames_sha256": h.hexdigest()[:16],
        "config_sha256": anchors.config_sha256(jsys.cfg),
        "config": anchors.config_fields(jsys.cfg),
        "ate_m": ate, "ate_one_ulp_m": spread, "trajectory_points": len(jsys.trajectory),
        "keyframes": int(jsys.lio.state.kf_count),
        "vio_frames": int(jsys.vio_frames), "vio_initialized": bool(jsys._vio_initialized),
        "failure_count": int(jsys.vio.failure_count),
        "prefix_seconds": 1.0,
        "prefix": [[float(t), *map(float, np.asarray(x6))] for t, x6 in pre.trajectory],
    }
    pprint.pprint({k: v for k, v in got.items() if k != "config"}, width=100, sort_dicts=False)
    assert got == anchors.ROSBAG_FIXTURE
