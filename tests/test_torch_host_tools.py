"""The port's host tools against the JAX package's: the message contracts
(``core/messages``), the profiling helpers on the CPU, the native host
library (``utils/native``: the C library against the JAX package's and
against the NumPy path) and the debug images (``utils/debugviz``: PPM,
PGM and HTML byte-equal to JAX's)."""

import dataclasses
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from lvislam_tpu.core import messages as jmsg  # noqa: E402
from lvislam_tpu.utils import debugviz as jdv  # noqa: E402
from lvislam_tpu.utils import native as jnative  # noqa: E402
from lvislam_tpu_torch.core import messages as tmsg  # noqa: E402
from lvislam_tpu_torch.utils import convert, profiling  # noqa: E402
from lvislam_tpu_torch.utils import debugviz as tdv  # noqa: E402
from lvislam_tpu_torch.utils import native as tnative  # noqa: E402
from lvislam_tpu_torch.utils import synthetic as tsyn  # noqa: E402
from test_native import make_blob  # noqa: E402

torch.set_num_threads(1)

# ----------------------------------------------------------------- messages


def jax_messages(rng):
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32))  # noqa: E731
    b = lambda *s: jnp.asarray(rng.random(s) > 0.5)  # noqa: E731
    i = lambda *s: jnp.asarray(rng.integers(-1, 9, s).astype(np.int32))  # noqa: E731
    return [
        jmsg.ImuSample(stamp=f(4), acc=f(4, 3), gyro=f(4, 3), quat=f(4, 4)),
        jmsg.LidarScan(stamp=f(), xyz=f(9, 3), intensity=f(9), ring=i(9), time=f(9), valid=b(9)),
        jmsg.CloudInfo(stamp=f(), start_ring_index=i(4), end_ring_index=i(4),
                       point_col_ind=i(9), point_range=f(9), imu_available=b(),
                       odom_available=b(), imu_rpy_init=f(3), initial_guess_trans=f(3),
                       initial_guess_quat=f(4), odom_reset_id=i(), xyz=f(9, 3),
                       intensity=f(9), valid=b(9), num_valid=i(), corner_xyz=f(5, 3),
                       corner_valid=b(5)),
        jmsg.Odometry(stamp=f(), trans=f(3), quat=f(4), vel=f(3), ang_vel=f(3), aux=f(8),
                      degenerate=b()),
        jmsg.FeatureFrame(stamp=f(), ids=i(6), xy_norm=f(6, 2), uv=f(6, 2), vel=f(6, 2),
                          depth=f(6), valid=b(6)),
        jmsg.CameraImage(stamp=f(), image=jnp.asarray(rng.integers(0, 255, (5, 7), np.uint8))),
    ]


def test_messages_carry_from_jax_field_for_field():
    """Each JAX message class has its port class with the same fields in the
    same order and defaults; `message_from_jax` carries every array bit for
    bit (None stays None); `replace` copies with fields changed."""
    for jm in jax_messages(np.random.default_rng(0)):
        cls = getattr(tmsg, type(jm).__name__)
        jf, tf = dataclasses.fields(type(jm)), dataclasses.fields(cls)
        assert [f.name for f in jf] == [f.name for f in tf]
        assert [f.default for f in jf] == [f.default for f in tf]
        tm = convert.message_from_jax(jm, device="cpu")
        assert type(tm) is cls
        for f in jf:
            a, b = getattr(jm, f.name), getattr(tm, f.name)
            if a is None:
                assert b is None
                continue
            assert b.dtype == torch.from_numpy(np.asarray(a)).dtype
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert tmsg.tree_stamp(tm.replace(stamp=torch.tensor(2.5))) == 2.5
        assert tmsg.tree_stamp(tm if tm.stamp.dim() == 0 else tm.replace(stamp=tm.stamp[0])) == \
            jmsg.tree_stamp(jm if jm.stamp.ndim == 0 else jm.replace(stamp=jm.stamp[0]))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_, np.uint8])
@pytest.mark.parametrize("capacity, axis", [(5, 0), (9, 0), (3, 0), (6, 1), (2, 1), (4, -1)])
def test_pad_to_and_validity_mask_equal_jax(dtype, capacity, axis):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(5, 4)) * 5).astype(dtype)
    fill = 7 if dtype is not np.bool_ else True
    want = np.asarray(jmsg.pad_to(jnp.asarray(x), capacity, axis, fill))
    got = tmsg.pad_to(torch.from_numpy(x), capacity, axis, fill)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmsg.validity_mask(3, capacity, device="cpu").numpy(),
                                  np.asarray(jmsg.validity_mask(3, capacity)))


# ---------------------------------------------------------------- profiling


def test_profiling_on_the_cpu(tmp_path):
    """`device_timer` times a block by perf_counter on the CPU (the drained
    output given as "out"); `hard_sync` is a no-op on CPU tensors; `trace`
    writes a Chrome trace naming the ops run inside."""
    box = {}
    with profiling.device_timer("mm", box) as h:
        h["out"] = {"a": torch.ones(64, 64) @ torch.ones(64, 64)}
    assert 0.0 < box["mm"] < 5.0
    with profiling.device_timer("cpu", box, device="cpu"):
        pass
    assert box["cpu"] >= 0.0
    profiling.hard_sync((torch.zeros(3), [torch.ones(2)], {"k": torch.ones(1)}))
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(32, 32) @ torch.ones(32, 32)
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "traceEvents" in text and "aten::mm" in text


# ------------------------------------------------------------------- native


def _numpy_path(fn, *args, **kw):
    """Call a `utils.native` function on its NumPy path."""
    lib, tried = tnative._lib, tnative._tried
    tnative._lib, tnative._tried = None, True
    try:
        return fn(*args, **kw)
    finally:
        tnative._lib, tnative._tried = lib, tried


def test_native_builds_into_the_package():
    assert tnative.available()
    so = [p for p in os.listdir(tnative.BUILD_DIR) if p.startswith("liblvislam_native_")]
    assert so and tnative.SOURCE.exists()


def shipped_scan():
    world = tsyn.default_world(seed=0)
    traj = tsyn.figure8_trajectory(scale=3.0, period=30.0)
    return tsyn.simulate_lidar_scan(world, traj, 1.05, n_scan=4, horizon=6000, sweep_time=0.1)


def pack_scan(scan):
    """The scan as a PointCloud2 blob: x y z intensity f32, ring u16, time f32
    (22 bytes a point)."""
    n = len(scan["xyz"])
    raw = np.zeros((n, 22), np.uint8)
    raw[:, 0:12] = np.asarray(scan["xyz"], np.float32).view(np.uint8).reshape(n, 12)
    raw[:, 12:16] = np.asarray(scan["intensity"], np.float32)[:, None].view(np.uint8)
    raw[:, 16:18] = np.asarray(scan["ring"], np.uint16)[:, None].view(np.uint8)
    raw[:, 18:22] = np.asarray(scan["time"], np.float32)[:, None].view(np.uint8)
    return raw.tobytes(), n


@pytest.mark.parametrize("which", ["test_native_blob", "shipped_scan"])
def test_native_equals_jax_and_the_numpy_path(which):
    """decode_pointcloud2, imu_window and voxel_prefilter: the port's C
    library, the JAX package's and the NumPy path give the same arrays on
    `tests/test_native.py`'s blob and on a 4 x 6000 scan."""
    if which == "test_native_blob":
        blob, *_ = make_blob(seed=3)
        n, step, offs = 100, 20, dict(x=0, y=4, z=8, intensity=12, ring=16, time=-1)
        xyz = np.random.default_rng(0).uniform(-2, 2, (500, 3)).astype(np.float32)
    else:
        scan = shipped_scan()
        blob, n = pack_scan(scan)
        step, offs = 22, dict(x=0, y=4, z=8, intensity=12, ring=16, time=18)
        xyz = np.asarray(scan["xyz"], np.float32)
    valid = np.ones(len(xyz), np.uint8)
    valid[::7] = 0
    stamps = np.arange(400) * 0.005 + 0.0012
    gyro = np.random.default_rng(2).normal(size=(400, 3)).astype(np.float32)
    acc = gyro * 3 + 9.8
    calls = [
        ("decode_pointcloud2", (blob, n, step, offs), dict(capacity=n + 28)),
        ("imu_window", (stamps, gyro, acc, 0.3, 0.51, 64), {}),
        ("imu_window", (stamps, gyro, acc, 1.2, 1.5, 32), {}),
        ("imu_window", (stamps, gyro, acc, 5.0, 6.0, 8), {}),
        ("voxel_prefilter", (xyz, valid, 0.2, len(xyz)), {}),
        ("voxel_prefilter", (xyz, valid, 0.5, 64), {}),
    ]
    for name, args, kw in calls:
        mine = getattr(tnative, name)(*args, **kw)
        ref = getattr(jnative, name)(*args, **kw)
        plain = _numpy_path(getattr(tnative, name), *args, **kw)
        for a, b, c in zip(mine, ref, plain):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c), err_msg=name)


def test_pointcloud2_to_scan_takes_the_native_path(monkeypatch):
    """The all-float layout goes through `native.decode_pointcloud2` and
    gives the scan's own arrays back."""
    from lvislam_tpu_torch.utils import bag as tbag

    scan = shipped_scan()
    blob, n = pack_scan(scan)
    msg = dict(fields={"x": (0, 7, 1), "y": (4, 7, 1), "z": (8, 7, 1),
                       "intensity": (12, 7, 1), "ring": (16, 4, 1), "time": (18, 7, 1)},
               data=blob, point_step=22)
    calls = []
    orig = tnative.decode_pointcloud2
    monkeypatch.setattr(tnative, "decode_pointcloud2",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    fast = tbag.pointcloud2_to_scan(msg)
    assert calls == [1]
    for key, dt in (("xyz", np.float32), ("intensity", np.float32), ("ring", np.int32),
                    ("time", np.float32)):
        assert fast[key].dtype == dt
        np.testing.assert_array_equal(fast[key], np.asarray(scan[key]).astype(dt), err_msg=key)


# ----------------------------------------------------------------- debugviz


def _same_file(tmp_path, name, write):
    pj, pt = tmp_path / f"j_{name}", tmp_path / f"t_{name}"
    write(jdv, str(pj))
    write(tdv, str(pt))
    assert pj.read_bytes() == pt.read_bytes(), name
    return pt


def test_debugviz_files_byte_equal_to_jax(tmp_path):
    """PGM, PPM and every overlay, the top-down map (with NaN points, empty)
    and the HTML viewer (with and without decimation) as the JAX module
    writes them, byte for byte."""
    rng = np.random.default_rng(1)
    gray = rng.random((32, 48)).astype(np.float32)
    img = rng.random((60, 80)).astype(np.float32)
    u8 = (img * 255).astype(np.uint8)
    uv = rng.uniform(-3, 82, (12, 2)).astype(np.float32)
    valid = rng.random(12) > 0.2
    pts = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    pts[:50] = np.nan
    traj = np.stack([np.linspace(-4, 4, 30), np.sin(np.linspace(0, 3, 30)), np.zeros(30)], -1)
    cases = {
        "g.pgm": lambda m, p: m.save_ppm(p, gray),
        "u8.pgm": lambda m, p: m.save_ppm(p, u8),
        "c.ppm": lambda m, p: m.save_ppm(p, rng_rgb),
        "tracks.ppm": lambda m, p: m.save_ppm(p, m.draw_tracks(
            img, uv, valid, track_cnt=np.arange(12) * 3, uv_prev=uv - 2.0)),
        "tracks_u8.ppm": lambda m, p: m.save_ppm(p, m.draw_tracks(u8, uv, valid)),
        "matches.ppm": lambda m, p: m.save_ppm(p, m.draw_matches(img, gray, uv, uv + 1.5, valid)),
        "depth.ppm": lambda m, p: m.save_ppm(p, m.draw_depth_overlay(
            img, uv, np.linspace(-1, 25, 12), valid)),
        "map.ppm": lambda m, p: m.save_ppm(p, m.draw_map_topdown(pts, None, traj, size=256)),
        "map_empty.ppm": lambda m, p: m.save_ppm(p, m.draw_map_topdown(np.zeros((0, 3)))),
        "v.html": lambda m, p: m.export_html_viewer(p, traj, map_xyz=pts, gt=traj + 0.01,
                                                    loop_pairs=np.array([[0, 7]])),
        "v2.html": lambda m, p: m.export_html_viewer(p, traj, map_xyz=pts, max_points=100),
    }
    rng_rgb = rng.random((16, 20, 3)).astype(np.float32)
    for name, write in cases.items():
        _same_file(tmp_path, name, write)
    html = (tmp_path / "t_v.html").read_text()
    data = json.loads(re.search(r"const DATA = (\{.*?\});\n", html).group(1))
    assert len(data["traj"]) == 30 and len(data["map"]) == 1950 and data["loops"] == [[0, 7]]
