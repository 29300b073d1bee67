"""The port's ``run_euroc_vio`` script against the JAX script: both
configuration paths field for field, the EuRoC folder writer and reader
against the JAX test's writer and the JAX reader, a short call on the CPU,
and (slow) the JAX script's own run of ``chip_smoke.py`` phase 20's folder,
stored in ``lvislam_tpu_torch/utils/anchors.EUROC_VIO``."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
from lvislam_tpu.utils import bag as jbag  # noqa: E402
from lvislam_tpu_torch.scripts import run_euroc_vio as tscript  # noqa: E402
from lvislam_tpu_torch.utils import anchors, bag_writer  # noqa: E402
from lvislam_tpu_torch.utils import bag as tbag  # noqa: E402
from lvislam_tpu_torch.utils import synthetic as tsyn  # noqa: E402
from test_torch_rosbag_entry import load_script  # noqa: E402

torch.set_num_threads(1)

FIXTURE_YAML = str(ROOT / "tests" / "data" / "fixture_camera.yaml")


def small_stream(duration):
    """The VIO phases' stream (world seed 0, figure-8 1.5 m / 8 s) at the
    fixture's 320x240 pinhole."""
    return tsyn.vio_stream(duration, world_seed=0, scale=1.5, period=8.0)


def write_folder(out, stream):
    """`stream` as phase 20 writes its folder (`chip_smoke.write_euroc_inputs`)
    into `out/mav0`; returns that path."""
    return chip_smoke.write_euroc_inputs(stream, str(out))[0]


@pytest.mark.parametrize("yaml", [None, "fixture_camera", "params_camera", "phase20"])
def test_build_config_equals_jax(yaml, tmp_path):
    """`build_config` of the public EuRoC default and of three camera YAMLs
    (the fixture's, the shipped one, phase 20's): the port's fields equal
    the JAX script's, and hash alike."""
    path = {None: None, "fixture_camera": FIXTURE_YAML,
            "params_camera": str(ROOT / "configs" / "params_camera.yaml")}.get(yaml)
    if yaml == "phase20":
        path = chip_smoke.write_euroc_camera_yaml(str(tmp_path / "cam.yaml"))
    jcfg = load_script("run_euroc_vio").build_config(path)
    tcfg = tscript.build_config(path)
    assert anchors.config_fields(tcfg) == anchors.config_fields(jcfg)
    assert anchors.config_sha256(tcfg) == anchors.config_sha256(jcfg)


def test_write_euroc_equals_the_e2e_writer(tmp_path):
    """`bag_writer.write_euroc` writes the CSVs of
    `tests/test_euroc_e2e.py:_write_euroc_fixture` byte for byte and PNG
    frames that PIL decodes to the same pixels as the test's PIL-written
    ones."""
    from PIL import Image

    from lvislam_tpu.utils import synthetic as jsyn
    from test_euroc_e2e import _T0_NS, _write_euroc_fixture

    world = jsyn.default_world(seed=0)
    traj = jsyn.figure8_trajectory(scale=1.5, period=8.0)
    ref = tmp_path / "ref"
    img_ts = _write_euroc_fixture(str(ref), world, traj, duration=0.4)
    ts = (np.arange(int(0.4 * 200)) + 1) / 200.0
    w, f = traj.imu(ts)
    frames = [(np.asarray(jsyn.render_camera_image(world, traj, t, width=320, height=240,
                                                   f=200.0)) * 255).astype(np.uint8)
              for t in img_ts]
    mine = tmp_path / "mine"
    bag_writer.write_euroc(str(mine), _T0_NS, ts, w, f, img_ts, frames)
    for name in ("imu0/data.csv", "cam0/data.csv"):
        assert (mine / name).read_bytes() == (ref / name).read_bytes(), name
    for png in sorted(os.listdir(ref / "cam0" / "data")):
        a = np.asarray(Image.open(ref / "cam0" / "data" / png))
        b = np.asarray(Image.open(mine / "cam0" / "data" / png))
        np.testing.assert_array_equal(a, b)


def test_euroc_reader_rows_equal_jax(tmp_path):
    """The port's reader (its own PNG decoder) and the JAX reader (PIL) give
    the same rows on one written folder: stamps, kinds, IMU vectors and
    frames bit for bit, and the frames are the stream's."""
    stream = small_stream(0.6)
    root = write_folder(tmp_path, stream)
    jm = list(jbag.euroc_reader(root))
    tm = list(tbag.euroc_reader(root))
    assert [m[:3] for m in tm] == [m[:3] for m in jm]
    imgs = [m[3]["image"] for m in tm if m[2] == "image"]
    assert len(imgs) == 5 and len(tm) == 5 + 120
    for a, b in zip(jm, tm):
        assert a[3].keys() == b[3].keys()
        for k in a[3]:
            assert np.asarray(a[3][k]).dtype == np.asarray(b[3][k]).dtype
            np.testing.assert_array_equal(np.asarray(a[3][k]), np.asarray(b[3][k]))
    for got, want in zip(imgs, stream[3]):
        np.testing.assert_array_equal(got, want)


def test_short_call_on_the_cpu(tmp_path):
    """1.5 s of the fixture-size stream through the port's script on the
    CPU with the fixture's camera YAML: every frame consumed, stamps rebased
    to the first message, the TUM rows the runner's trajectory."""
    root = write_folder(tmp_path, small_stream(1.5))
    out = tmp_path / "traj.tum"
    runner = tscript.main([root, "--camera-yaml", FIXTURE_YAML,
                           "--max-seconds", "1.5", "--out", str(out), "--device", "cpu"])
    assert runner.device.type == "cpu"
    assert runner.last_img == pytest.approx(1.4 - 0.005, abs=1e-6)
    assert int(runner.vio.frame_count) >= 10
    if runner.trajectory:
        rows = np.loadtxt(out, ndmin=2)
        ts = np.array([x[0] for x in runner.trajectory])
        pos = np.stack([x[1] for x in runner.trajectory])
        assert rows.shape == (len(ts), 8) and np.isfinite(rows).all()
        np.testing.assert_allclose(rows[:, 0], ts, atol=5e-7)
        np.testing.assert_allclose(rows[:, 1:4], pos, atol=5e-7)
    else:
        assert not out.exists()


def jax_phase20_run(tmp_path):
    """The JAX script on `chip_smoke.py` phase 20's folder (phase 11's 5 s
    stream at 752x480, the phase's camera YAML): (runner, frames sha256,
    status and ATE as the phase computes them)."""
    import hashlib

    stream = chip_smoke.vio_inputs(True)
    root, yaml = chip_smoke.write_euroc_inputs(stream[1:], str(tmp_path))
    h = hashlib.sha256()
    for _, _, kind, msg in jbag.euroc_reader(root):
        if kind == "image":
            h.update(np.ascontiguousarray(msg["image"]).tobytes())
    runner = load_script("run_euroc_vio").main(
        [root, "--camera-yaml", yaml, "--max-seconds", "5", "--out", str(tmp_path / "j.tum")])
    first = min(t for t, _, _ in stream[1])
    shifted = chip_smoke.ShiftedTrajectory(stream[0], first)
    live = bool(np.asarray(runner.vio.initialized)) and len(runner.trajectory) >= 3
    fails, fc = int(runner.vio.failure_count), int(runner.vio.frame_count)
    ate = chip_smoke.vio_summary(runner.trajectory, shifted)[0] if live else None
    return runner, h.hexdigest()[:16], chip_smoke.vio_status(live, fails, fc, ate), ate


@pytest.mark.slow
def test_jax_euroc_anchor(tmp_path):
    """The JAX script over phase 20's folder on the CPU: frames' sha256,
    status, ATE, trajectory points; equal to ``anchors.EUROC_VIO`` (``-s``
    prints them)."""
    import pprint

    runner, sha, status, ate = jax_phase20_run(tmp_path)
    got = {"frames_sha256": sha, "status": status, "ate_m": ate,
           "trajectory_points": len(runner.trajectory),
           "failure_count": int(runner.vio.failure_count),
           "frame_count": int(runner.vio.frame_count)}
    pprint.pprint(got, width=100, sort_dicts=False)
    assert got == anchors.EUROC_VIO
