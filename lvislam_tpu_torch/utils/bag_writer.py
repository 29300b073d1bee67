"""A rosbag2 (sqlite3 + CDR) writer for the message types `utils/bag.py`
reads — the port's copy of ``scripts/make_fixture_bag.py``'s writer
(``CdrWriter``, ``encode_imu``, ``encode_livox`` and the sqlite schema),
with a raw ``sensor_msgs/Image`` mono8 encoder in place of the JPEG one
(JPEG encoding needs PIL). ``encode_livox`` packs the points in one numpy
pass; its bytes are the per-point writer's.

Use: ``write_bag(path, topics, messages)`` with `topics` a list of (name,
type) and `messages` (stamp ns, topic index, CDR bytes) in any order.

``write_euroc`` writes an EuRoC ASL ``mav0`` folder instead (imu0 CSV with
nanosecond stamps, cam0 CSV and 8-bit PNG frames by `utils/png.py`), in
the layout and number format of ``tests/test_euroc_e2e.py``'s writer.
"""

from __future__ import annotations

import sqlite3
import struct

import numpy as np

from . import png
from .bag import _LIVOX_POINT


class CdrWriter:
    """XCDR1 little-endian writer (inverse of ``utils.bag.Cdr``)."""

    def __init__(self):
        self.out = bytearray(b"\x00\x01\x00\x00")

    def _align(self, n):
        rem = (len(self.out) - 4) % n
        if rem:
            self.out.extend(b"\x00" * (n - rem))

    def u8(self, v):
        self.out.append(v & 0xFF)

    def _prim(self, fmt, size, v):
        self._align(size)
        self.out.extend(struct.pack("<" + fmt, v))

    def u32(self, v):
        self._prim("I", 4, v)

    def i32(self, v):
        self._prim("i", 4, v)

    def u64(self, v):
        self._prim("Q", 8, v)

    def f32(self, v):
        self._prim("f", 4, float(v))

    def f64(self, v):
        self._prim("d", 8, float(v))

    def string(self, s):
        b = s.encode() + b"\x00"
        self.u32(len(b))
        self.out.extend(b)

    def bytes_seq(self, b):
        self.u32(len(b))
        self.out.extend(b)

    def header(self, stamp, frame):
        self.i32(int(stamp))
        self.u32(int(round((stamp % 1.0) * 1e9)))
        self.string(frame)

    def bytes(self):
        return bytes(self.out)


def encode_imu(stamp, gyro, acc, quat_wxyz=None):
    """sensor_msgs/Imu: orientation (x y z w on the wire), angular velocity,
    linear acceleration, zero covariances."""
    w = CdrWriter()
    w.header(stamp, "livox_frame")
    q = quat_wxyz if quat_wxyz is not None else (1.0, 0.0, 0.0, 0.0)
    for v in (q[1], q[2], q[3], q[0]):
        w.f64(v)
    for vec in (None, gyro, None, acc, None):
        for v in (vec if vec is not None else [0.0] * 9):
            w.f64(v)
    return w.bytes()


def encode_livox(stamp, xyz, rel_time_s, ring, intensity):
    """livox_ros_driver2/CustomMsg: CustomPoint = {offset_time u32 (ns),
    x/y/z f32, reflectivity u8, tag u8, line u8}, each 4-aligned (20 bytes;
    the last one without its pad byte, as a per-point writer leaves it)."""
    w = CdrWriter()
    w.header(stamp, "livox_frame")
    w.u64(int(stamp * 1e9))  # timebase
    n = len(xyz)
    w.u32(n)
    for _ in range(4):
        w.u8(0)  # lidar_id, rsvd[3]
    w.u32(n)  # points sequence length
    pts = np.zeros(n, _LIVOX_POINT)
    # the per-point writer's int(np.float32 * 1e9): an f32 product, truncated
    pts["off"] = (np.asarray(rel_time_s, np.float32) * np.float32(1e9)).astype(np.int64)
    xyz = np.asarray(xyz, np.float32)
    pts["x"], pts["y"], pts["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    pts["refl"] = np.asarray(intensity).astype(np.int64) & 0xFF
    pts["line"] = np.asarray(ring).astype(np.int64) & 0xFF
    blob = pts.tobytes()
    w.out.extend(blob[:-1] if n else blob)
    return w.bytes()


def encode_image(stamp, img_u8):
    """sensor_msgs/Image, encoding mono8, step = width (the layout
    ``utils.bag.parse_image`` reads)."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    h, wd = img.shape
    w = CdrWriter()
    w.header(stamp, "camera")
    w.u32(h)
    w.u32(wd)
    w.string("mono8")
    w.u8(0)  # is_bigendian
    w.u32(wd)
    w.bytes_seq(img.tobytes())
    return w.bytes()


def write_bag(path: str, topics, messages) -> int:
    """A rosbag2 sqlite file at `path` (replaced): `topics` [(name, type)],
    numbered from 1 in that order; `messages` [(stamp ns, topic index from
    0, CDR bytes)], stored in stamp order. Returns the message count."""
    msgs = sorted(messages, key=lambda m: m[0])
    conn = sqlite3.connect(path)
    try:
        conn.execute("DROP TABLE IF EXISTS topics")
        conn.execute("DROP TABLE IF EXISTS messages")
        conn.execute(
            "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT, "
            "serialization_format TEXT, offered_qos_profiles TEXT)")
        conn.execute(
            "CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER, "
            "timestamp INTEGER, data BLOB)")
        for k, (name, typ) in enumerate(topics):
            conn.execute("INSERT INTO topics VALUES (?, ?, ?, 'cdr', '')", (k + 1, name, typ))
        conn.executemany("INSERT INTO messages VALUES (?, ?, ?, ?)",
                         ((i + 1, tid + 1, ts, blob) for i, (ts, tid, blob) in enumerate(msgs)))
        conn.commit()
    finally:
        conn.close()
    return len(msgs)


def write_euroc(root: str, t0_ns: int, imu_ts, gyro, acc, img_ts, frames_u8) -> list:
    """An EuRoC ``mav0`` folder at `root`: ``imu0/data.csv`` (stamp ns =
    t0_ns + round(t * 1e9), w_RS_S, a_RS_S as Python prints float64) and
    ``cam0/data.csv`` with one PNG a frame named by its stamp. Returns the
    frame stamps in ns."""
    import os

    os.makedirs(os.path.join(root, "imu0"), exist_ok=True)
    os.makedirs(os.path.join(root, "cam0", "data"), exist_ok=True)
    with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,"
                "a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for t, w, a in zip(imu_ts, gyro, acc):
            ns = t0_ns + int(round(t * 1e9))
            f.write(f"{ns},{w[0]},{w[1]},{w[2]},{a[0]},{a[1]},{a[2]}\n")
    stamps = []
    with open(os.path.join(root, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t, img in zip(img_ts, frames_u8):
            ns = t0_ns + int(round(t * 1e9))
            png.write(os.path.join(root, "cam0", "data", f"{ns}.png"), np.asarray(img, np.uint8))
            f.write(f"{ns},{ns}.png\n")
            stamps.append(ns)
    return stamps
