"""The port's ``run_synthetic_lvi`` script against the JAX script: the same
configuration (fields and hash), a short call on the CPU with every output
written and read back, and (slow) the JAX script's own readings of the 6 s
default run and of runs with one input a float32 step off, stored in
``lvislam_tpu_torch/utils/anchors.SYNTHETIC_LVI`` for ``chip_smoke.py``
phase 21."""

import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from lvislam_tpu_torch.scripts import run_synthetic_lvi as tscript  # noqa: E402
from lvislam_tpu_torch.utils import anchors  # noqa: E402

torch.set_num_threads(1)

# One-ulp changes of the JAX script's inputs: the IMU's gyro or
# accelerometer (float32, as the system takes them) or every scan point, one
# float32 step up or down. They measure the JAX run's own spread.
ONE_ULP = {"gyro_up": ("imu", "gyro", True), "acc_up": ("imu", "acc", True),
           "xyz_up": ("lidar", "xyz", True), "xyz_down": ("lidar", "xyz", False)}


def _nudge(x, up: bool):
    x32 = np.asarray(x, np.float32)
    return np.nextafter(x32, np.float32(np.inf if up else -np.inf))


class _Nudged:
    """A JAX `LviSystem` whose feeds pass one `ONE_ULP` input change."""

    def __init__(self, system, nudge):
        self.system, (self.kind, self.key, self.up) = system, ONE_ULP[nudge]

    def feed_imu(self, t, gyro, acc, rpy=None):
        if self.kind == "imu":
            gyro = _nudge(gyro, self.up) if self.key == "gyro" else gyro
            acc = _nudge(acc, self.up) if self.key == "acc" else acc
        self.system.feed_imu(t, gyro, acc, rpy=rpy)

    def feed_lidar(self, t, scan):
        if self.kind == "lidar":
            scan = dict(scan, xyz=_nudge(scan["xyz"], self.up))
        self.system.feed_lidar(t, scan)

    def feed_image(self, t, img):
        self.system.feed_image(t, img)


def jax_synthetic_run(duration: float, nudge=None):
    """The JAX script's run (`scripts/run_synthetic_lvi.py:main`) on the CPU,
    inputs nudged by one `ONE_ULP` entry or not: (system, ATE as the script
    computes it)."""
    from test_lvi_system import make_system
    from lvislam_tpu.utils.metrics import ate_rmse

    jsys = make_system()
    tscript.feed_world(jsys if nudge is None else _Nudged(jsys, nudge), duration)
    jsys.run()
    traj = tscript_traj()
    est_pos = np.stack([np.asarray(x6)[3:6] for _, x6 in jsys.trajectory])
    gt = np.stack([traj.pose(np.array([t]))[0][0] for t, _ in jsys.trajectory])
    return jsys, float(ate_rmse(est_pos, gt))


def tscript_traj():
    from lvislam_tpu_torch.utils import synthetic as tsyn

    return tsyn.figure8_trajectory(scale=3.0, period=30.0)


def test_system_config_equals_make_system():
    """`system_config()` is `make_system()`'s configuration, field for field
    and by hash."""
    from test_lvi_system import make_system

    jcfg = make_system().cfg
    tcfg = tscript.system_config()
    assert anchors.config_fields(tcfg) == anchors.config_fields(jcfg)
    assert anchors.config_sha256(tcfg) == anchors.config_sha256(jcfg)


def test_feed_world_matches_the_jax_script():
    """The streams `feed_world` publishes are the JAX script's, bit for bit:
    the same IMU rows, scans and frames in the same order (recorded from
    both modules' feeds)."""
    from lvislam_tpu.utils import synthetic as jsyn

    class Rec:
        def __init__(self):
            self.rows = []

        def feed_imu(self, t, g, a, rpy=None):
            self.rows.append(("imu", t, np.asarray(g), np.asarray(a), np.asarray(rpy)))

        def feed_lidar(self, t, scan):
            self.rows.append(("lidar", t, *(np.asarray(scan[k]) for k in sorted(scan))))

        def feed_image(self, t, img):
            self.rows.append(("image", t, np.asarray(img)))

    mine, ref = Rec(), Rec()
    tscript.feed_world(mine, 0.3)
    tscript.feed_world(ref, 0.3, world=jsyn.default_world(seed=0),
                       traj=jsyn.figure8_trajectory(scale=3.0, period=30.0))
    assert len(mine.rows) == len(ref.rows) == 60 + 2 + 2
    for a, b in zip(mine.rows, ref.rows):
        assert a[:2] == b[:2]
        for x, y in zip(a[2:], b[2:]):
            np.testing.assert_array_equal(x, y)


def test_short_call_writes_every_output(tmp_path):
    """A 1.2 s call on the CPU with `--save-map`, `--checkpoint` and
    `--html`: poses finite, every file written, the viewer's trajectory the
    script's, the checkpoint reloaded equal to the state."""
    from lvislam_tpu_torch.utils import checkpoint

    out = tscript.main(["1.2", "--device", "cpu", "--save-map", str(tmp_path / "map"),
                        "--checkpoint", str(tmp_path / "lio.pt"),
                        "--html", str(tmp_path / "v.html")])
    sys_ = out["system"]
    assert len(sys_.trajectory) == 11 and np.isfinite(out["est"]).all()
    assert np.isfinite(out["ate_m"])
    for name in ("CornerMap.pcd", "SurfMap.pcd", "GlobalMap.pcd", "trajectory.pcd",
                 "transformations.txt", "GlobalMap_topdown.ppm", "viewer.html"):
        assert (tmp_path / "map" / name).stat().st_size > 0, name
    import json

    html = (tmp_path / "v.html").read_text()
    data = json.loads(re.search(r"const DATA = (\{.*?\});\n", html).group(1))
    np.testing.assert_allclose(data["traj"], out["est"].astype(np.float32).round(3),
                               atol=1e-6)
    assert len(data["gt"]) == len(data["traj"]) and len(data["map"]) > 0
    back = checkpoint.load_state(str(tmp_path / "lio.pt"), sys_.lio.state, device="cpu")
    for a, b in zip(checkpoint._flatten(back).values(),
                    checkpoint._flatten(sys_.lio.state).values()):
        assert torch.equal(a, b)


@pytest.mark.slow
def test_jax_synthetic_anchor():
    """The JAX script's 6 s default run on the CPU and the same run with
    each `ONE_ULP` input change: ATE, poses, VIO outcome; equal to
    ``anchors.SYNTHETIC_LVI`` (``-s`` prints them)."""
    import pprint

    jsys, ate = jax_synthetic_run(6.0)
    spread = {name: jax_synthetic_run(6.0, name)[1] for name in ONE_ULP}
    got = {
        "duration_s": 6.0,
        "config_sha256": anchors.config_sha256(jsys.cfg),
        "ate_m": ate, "ate_one_ulp_m": spread,
        "trajectory_points": len(jsys.trajectory),
        "keyframes": int(jsys.lio.state.kf_count),
        "vio_initialized": bool(np.asarray(jsys.vio.initialized)),
        "failure_count": int(jsys.vio.failure_count),
    }
    pprint.pprint(got, width=100, sort_dicts=False)
    assert got == anchors.SYNTHETIC_LVI
