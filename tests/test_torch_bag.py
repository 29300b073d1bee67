"""The port's dataset readers (``lvislam_tpu_torch.utils.bag``), its JPEG
decoder (``utils/jpeg.py``) and its bag writer (``utils/bag_writer.py``)
against the JAX package's ``lvislam_tpu.utils.bag`` and PIL.

Tolerances: none where the port decodes what JAX decodes (CDR fields, point
layouts, grayscale JPEG frames: equal arrays, ``torch.equal`` images). A
three-component JPEG's Y plane (4:4:4 and 4:2:0) equals PIL's
``convert("L")`` where no decoded RGB channel clamps, and is held within
``COLOUR_MAX_DIFF`` grey levels (mean ``COLOUR_MEAN_DIFF``) where channels
clamp at 0 or 255: PIL's L is computed from the clamped RGB."""

import io
import os
import sqlite3
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from lvislam_tpu.utils import bag as jbag  # noqa: E402
from lvislam_tpu_torch.utils import bag as tbag  # noqa: E402
from lvislam_tpu_torch.utils import bag_writer as bw  # noqa: E402
from lvislam_tpu_torch.utils import jpeg  # noqa: E402

torch.set_num_threads(1)

BAG = str(ROOT / "tests" / "data" / "fixture_mid360.db3")
COLOUR_MAX_DIFF, COLOUR_MEAN_DIFF = 8, 0.01


def assert_msg_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def fixture_bag_both():
    return list(jbag.Rosbag2Reader(BAG)), list(tbag.Rosbag2Reader(BAG))


@pytest.mark.parametrize("kind", ["imu", "livox", "image"])
def test_reader_equals_jax_on_the_fixture_bag(fixture_bag_both, kind):
    """The whole committed bag: the same (t, topic, kind) sequence, and for
    each message of `kind` equal arrays; every JPEG frame torch.equal to
    PIL's decode."""
    jm, tm = fixture_bag_both
    assert [m[:3] for m in tm] == [m[:3] for m in jm]
    n = 0
    for (_, _, k, a), (_, _, _, b) in zip(jm, tm):
        if k != kind:
            continue
        assert_msg_equal(a, b)
        if kind == "image":
            assert torch.equal(torch.from_numpy(b["image"]), torch.from_numpy(a["image"]))
        n += 1
    assert n == {"imu": 1200, "livox": 59, "image": 59}[kind]


def gray_frame(h, w, seed=0):
    """A textured 8-bit frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 128 + 50 * np.sin(xx / 6.0) + 40 * np.cos(yy / 4.0) + rng.normal(0, 12, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_jpeg(img, mode="L", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def pil_gray(blob: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(blob)).convert("L"))


JPEG_CASES = {f"q{q}_{h}x{w}": ((h, w), dict(quality=q))
              for q in (50, 85, 95) for h, w in ((240, 320), (37, 53), (9, 17))}
JPEG_CASES.update({
    "optimized_huffman_240x320": ((240, 320), dict(quality=85, optimize=True)),
    "optimized_huffman_61x83": ((61, 83), dict(quality=85, optimize=True)),
    "restart_interval_240x320": ((240, 320), dict(quality=85, restart_marker_blocks=5)),
    "restart_rows_45x70": ((45, 70), dict(quality=90, restart_marker_rows=1)),
})


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_grayscale_bit_equal_to_pil(case):
    (h, w), kw = JPEG_CASES[case]
    blob = pil_jpeg(gray_frame(h, w, seed=len(case)), **kw)
    got = jpeg.decode_gray(blob)
    assert got.dtype == np.uint8 and got.shape == (h, w)
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(pil_gray(blob).copy()))


COLOUR_BOUNDS = {"in_gamut": (30, 225, 0, 0.0), "clamped": (0, 255, COLOUR_MAX_DIFF, COLOUR_MEAN_DIFF)}


@pytest.mark.parametrize("gamut", sorted(COLOUR_BOUNDS))
@pytest.mark.parametrize("subsampling", [0, 2], ids=["444", "420"])
def test_jpeg_colour_luma_against_pil(subsampling, gamut):
    """Y against PIL's RGB -> L: equal where no RGB channel clamps; within
    the stated bound where the decoded colours clamp at 0 or 255."""
    lo, hi, max_diff, mean_diff = COLOUR_BOUNDS[gamut]
    g = lo + gray_frame(61, 83, seed=5).astype(np.int32) * (hi - lo) // 255
    rgb = np.stack([g, np.clip(g + 20, 0, 255), np.clip(g - 25, 0, 255)], -1).astype(np.uint8)
    blob = pil_jpeg(rgb, "RGB", quality=90, subsampling=subsampling)
    got = jpeg.decode_gray(blob).astype(np.int32)
    want = pil_gray(blob).astype(np.int32)
    assert got.shape == want.shape == (61, 83)
    diff = np.abs(got - want)
    assert diff.max() <= max_diff and diff.mean() <= mean_diff, (diff.max(), diff.mean())


def test_jpeg_progressive_raises():
    blob = pil_jpeg(gray_frame(40, 48), quality=85, progressive=True)
    with pytest.raises(NotImplementedError, match="progressive"):
        jpeg.decode_gray(blob)


@pytest.mark.parametrize("cut", [0.5, 0.9])
def test_jpeg_truncated_raises(cut):
    blob = pil_jpeg(gray_frame(64, 80), quality=85)
    with pytest.raises(ValueError):
        jpeg.decode_gray(blob[: int(len(blob) * cut)])
    with pytest.raises(ValueError):
        jpeg.decode_gray(b"\x00\x01" + blob[2:])


def test_idct_islow_dc_only_block():
    """A DC-only block is flat at clamp(128 + DC * q / 8) (jidctint.c's
    all-zero-AC shortcut gives the same integers)."""
    coef = torch.zeros(3, 64, dtype=torch.int64)
    coef[:, 0] = torch.tensor([0, 40, -200])
    q = torch.ones(64, dtype=torch.int64)
    out = jpeg.idct_islow(coef, q)
    assert out.dtype == torch.uint8
    assert out[0].unique().tolist() == [128]
    assert out[1].unique().tolist() == [133]
    assert out[2].unique().tolist() == [103]


def compressed(stamp, data: bytes, fmt="jpeg"):
    w = bw.CdrWriter()
    w.header(stamp, "camera")
    w.string(fmt)
    w.bytes_seq(data)
    return w.bytes()


def test_reader_skips_a_truncated_jpeg_as_jax_does(tmp_path):
    good = pil_jpeg(gray_frame(48, 64), quality=85)
    png = io.BytesIO()
    Image.fromarray(gray_frame(24, 32, seed=3), "L").save(png, format="PNG")
    path = str(tmp_path / "img.db3")
    bw.write_bag(path, [("/camera/image", "sensor_msgs/msg/CompressedImage")], [
        (100_000_000, 0, compressed(0.1, good)),
        (200_000_000, 0, compressed(0.2, good[: len(good) // 2])),
        (300_000_000, 0, compressed(0.3, png.getvalue(), "png")),
    ])
    jr, tr = jbag.Rosbag2Reader(path), tbag.Rosbag2Reader(path)
    jm, tm = list(jr), list(tr)
    assert jr.skipped == tr.skipped == 1
    assert [m[:3] for m in tm] == [m[:3] for m in jm]
    for a, b in zip(jm, tm):
        assert_msg_equal(a[3], b[3])


def encode_odometry(stamp, pos, quat_xyzw, cov):
    w = bw.CdrWriter()
    w.header(stamp, "map")
    w.string("base_link")
    for v in (*pos, *quat_xyzw, *cov):
        w.f64(v)
    for _ in range(6 + 36):  # twist
        w.f64(0.0)
    return w.bytes()


def encode_navsatfix(stamp, status, lat, lon, alt, cov):
    w = bw.CdrWriter()
    w.header(stamp, "gps")
    w._prim("b", 1, status)
    w._prim("H", 2, 1)  # service
    for v in (lat, lon, alt, *cov):
        w.f64(v)
    w.u8(2)  # covariance type
    return w.bytes()


def test_odometry_navsatfix_and_enu_equal_jax():
    rng = np.random.default_rng(7)
    cov36 = rng.random(36)
    odo = encode_odometry(12.25, [1.5, -2.0, 0.25], [0.1, 0.2, 0.3, 0.927], cov36)
    assert_msg_equal(tbag.parse_odometry(odo), jbag.parse_odometry(odo))
    fix = encode_navsatfix(3.5, -1, 47.3977, 8.5456, 488.2, rng.random(9))
    assert_msg_equal(tbag.parse_navsatfix(fix), jbag.parse_navsatfix(fix))
    assert tbag.parse_navsatfix(fix)["status"] == -1
    args = (47.3981, 8.5462, 490.0, 47.3977, 8.5456, 488.2)
    np.testing.assert_array_equal(tbag.navsat_to_enu(*args), jbag.navsat_to_enu(*args))


def pc2_layouts():
    """The PointCloud2 layouts of `tests/test_bag.py` (native fast path,
    Ouster-style generic path) and `tests/test_rosbag_script.py`
    (Velodyne record, optional fields dropped)."""
    from test_bag import encode_pointcloud2
    from test_rosbag_script import make_pc2

    n, step = 4, 24
    blob = bytearray(step * n)
    xyz = np.array([[1, 2, 3], [np.nan, 0, 0], [4, 5, 6], [7, 8, 9]], np.float32)
    for i in range(n):
        struct.pack_into("<ffff", blob, i * step, *xyz[i], float(i) * 10)
        struct.pack_into("<H", blob, i * step + 16, i % 3)
        struct.pack_into("<f", blob, i * step + 18, i * 1e-3)
    fast = encode_pointcloud2(2.0, [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1),
                                    ("intensity", 12, 7, 1), ("ring", 16, 4, 1),
                                    ("time", 18, 7, 1)], bytes(blob), step, n)
    n, step = 3, 18
    blob = bytearray(step * n)
    for i in range(n):
        struct.pack_into("<fff", blob, i * step, *xyz[[0, 2, 3]][i])
        struct.pack_into("<I", blob, i * step + 12, i * 1000)
        blob[i * step + 16] = i
    ouster = encode_pointcloud2(2.0, [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1),
                                      ("t", 12, 6, 1), ("line", 16, 2, 1)], bytes(blob), step, n)
    n, step = 3, 20
    blob = bytearray(step * n)
    for i in range(n):
        struct.pack_into("<fffd", blob, i * step, *xyz[[0, 2, 3]][i], 100.0 + i * 0.01)
    stamped = encode_pointcloud2(2.0, [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1),
                                       ("timestamp", 12, 8, 1)], bytes(blob), step, n)
    velo = make_pc2(np.array([[1, 2, 3], [4, 5, 6], [-1, 0, 2]], np.float32),
                    np.array([10, 20, 30], np.float32), np.array([0, 7, 15], np.uint16),
                    np.array([0.0, 0.05, 0.099], np.float32))
    bare = dict(velo, fields={k: v for k, v in velo["fields"].items() if k in ("x", "y", "z")})
    return {"fast_layout": fast, "ouster_t_line": ouster, "f64_timestamp": stamped,
            "velodyne": velo, "xyz_only": bare}


@pytest.mark.parametrize("layout", ["fast_layout", "ouster_t_line", "f64_timestamp",
                                    "velodyne", "xyz_only"])
def test_pointcloud2_to_scan_equals_jax(layout):
    src = pc2_layouts()[layout]
    if isinstance(src, bytes):
        a, b = jbag.parse_pointcloud2(src), tbag.parse_pointcloud2(src)
        assert_msg_equal(a, b)
    else:
        a = b = src
    assert_msg_equal(jbag.pointcloud2_to_scan(a), tbag.pointcloud2_to_scan(b))


def euroc_dir(root):
    os.makedirs(root / "imu0")
    os.makedirs(root / "cam0" / "data")
    with open(root / "imu0" / "data.csv", "w") as f:
        f.write("#ts,gx,gy,gz,ax,ay,az\n")
        for k in range(5):
            f.write(f"{1000000000 + k * 5000000},0.1,0.2,{0.3 + k},1,2,9.8\n")
    with open(root / "cam0" / "data.csv", "w") as f:
        f.write("#ts,filename\n")
        for k in range(3):
            ts = 1002000000 + k * 6000000
            Image.fromarray(gray_frame(24, 32, seed=k)).save(root / "cam0" / "data" / f"{ts}.png")
            f.write(f"{ts},{ts}.png\n")
    return str(root)


def test_euroc_reader_equals_jax(tmp_path):
    root = euroc_dir(tmp_path / "mav0")
    jm, tm = list(jbag.euroc_reader(root)), list(tbag.euroc_reader(root))
    assert [m[:3] for m in tm] == [m[:3] for m in jm]
    assert [m[2] for m in tm].count("image") == 3
    for a, b in zip(jm, tm):
        assert_msg_equal(a[3], b[3])
    assert [m[:3] for m in tbag.euroc_reader(root, max_items=4)] == \
        [m[:3] for m in jbag.euroc_reader(root, max_items=4)]


def test_euroc_reader_without_pil_raises(tmp_path, monkeypatch):
    """Where PIL is missing the port no longer raises: its own PNG decoder
    (`utils/png.py`) yields every frame, equal to the frames the JAX reader
    decodes with PIL; the JAX reader without PIL drops every frame and
    yields the IMU alone."""
    root = euroc_dir(tmp_path / "mav0")
    with_pil = list(jbag.euroc_reader(root))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
    tm = list(tbag.euroc_reader(root))
    assert [m[:3] for m in tm] == [m[:3] for m in with_pil]
    assert [m[2] for m in tm].count("image") == 3
    for a, b in zip(with_pil, tm):
        assert_msg_equal(a[3], b[3])
    assert [m[2] for m in jbag.euroc_reader(root)] == ["imu"] * 5


def test_fixture_writer_bytes_equal_make_fixture_bag():
    """`encode_imu` and the vectorized `encode_livox` write the bytes of
    `scripts/make_fixture_bag.py`'s per-point writer."""
    from test_torch_rosbag_entry import load_script

    mfb = load_script("make_fixture_bag")
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(37, 3)).astype(np.float32) * 10
    rt = np.sort(rng.random(37)).astype(np.float32) * 0.1
    ring = rng.integers(0, 4, 37).astype(np.int32)
    inten = np.clip(rng.uniform(20, 180, 37), 0, 255)
    assert bw.encode_livox(1.25, xyz, rt, ring, inten) == mfb.encode_livox(1.25, xyz, rt, ring, inten)
    q = (0.9, 0.1, -0.3, 0.2)
    assert bw.encode_imu(0.005, [0.1, 0.2, 0.3], [0.0, 0.1, 9.8], q) == \
        mfb.encode_imu(0.005, [0.1, 0.2, 0.3], [0.0, 0.1, 9.8], quat_wxyz=q)


def test_writer_round_trips_through_both_readers(tmp_path):
    rng = np.random.default_rng(9)
    img = gray_frame(30, 40)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    rt = np.linspace(0, 0.099, 50).astype(np.float32)
    path = str(tmp_path / "rt.db3")
    topics = [("/livox/imu", "sensor_msgs/msg/Imu"),
              ("/livox/lidar", "livox_ros_driver2/msg/CustomMsg"),
              ("/camera/image", "sensor_msgs/msg/Image")]
    n = bw.write_bag(path, topics, [
        (int(0.1e9), 2, bw.encode_image(0.1, img)),
        (int(0.05e9), 1, bw.encode_livox(0.05, xyz, rt, np.arange(50) % 4, np.full(50, 90.0))),
        (int(0.005e9), 0, bw.encode_imu(0.005, [0.0, 0.1, 0.2], [0.0, 0.0, 9.81])),
    ])
    assert n == 3
    jm, tm = list(jbag.Rosbag2Reader(path)), list(tbag.Rosbag2Reader(path))
    assert [m[1:3] for m in tm] == [m[1:3] for m in jm] == [
        ("/livox/imu", "imu"), ("/livox/lidar", "livox"), ("/camera/image", "image")]
    for a, b in zip(jm, tm):
        assert a[0] == b[0]
        assert_msg_equal(a[3], b[3])
    np.testing.assert_array_equal(tm[1][3]["xyz"], xyz)
    np.testing.assert_array_equal(tm[2][3]["image"], img.astype(np.float32) / 255.0)
    conn = sqlite3.connect(path)
    assert conn.execute("SELECT COUNT(*) FROM topics").fetchone()[0] == 3
    conn.close()
