"""Dataset readers: rosbag2 (sqlite3 + CDR) and EuRoC ASL — port of
``lvislam_tpu.utils.bag``.

The reference consumes live DDS topics or `ros2 bag play` (docs/quick-start
.md); this module reads the same recordings directly — no ROS installation:

- `Rosbag2Reader`: opens a rosbag2 `.db3` (sqlite3 schema: topics +
  messages), deserializes CDR for the message types the pipeline needs —
  sensor_msgs/Imu, sensor_msgs/PointCloud2, sensor_msgs/Image,
  sensor_msgs/CompressedImage, livox_ros_driver2/CustomMsg
  (`imageProjection.cpp:240-260` field layout), nav_msgs/Odometry and
  sensor_msgs/NavSatFix.
- `euroc_reader`: the ASL folder layout (cam0 PNGs + imu0 CSV).

Both yield (stamp_seconds, topic, kind, payload-dict) in time order — ready
for `LviSystem.feed_*` / the bus. The parsers are host code (numpy on the
message bytes), as in the JAX package; tensors start where `LviSystem`
takes the messages. What differs from the JAX module: images are decoded by
the port's own codecs instead of PIL — a JPEG `CompressedImage` by
`utils/jpeg.py` (bit-equal to PIL's on grayscale frames), a PNG one and
EuRoC's cam0 frames by `utils/png.py` (bit-equal to PIL's ``convert("L")``)
— so no bag or EuRoC folder needs PIL. `pointcloud2_to_scan` takes the
native C decoder (`utils/native.py`) for the common all-float layout, as
the JAX module does, and the generic strided numpy path otherwise.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import Iterator

import numpy as np

from . import jpeg, png


# ---------------------------------------------------------------------------
# CDR (XCDR1 little-endian) primitive reader
# ---------------------------------------------------------------------------

class Cdr:
    """Minimal CDR deserializer: 4-byte encapsulation header, little-endian,
    primitives aligned to their own size (relative to payload start)."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 4  # skip encapsulation {0x00, 0x01, 0x00, 0x00}

    def _align(self, n):
        rem = (self.pos - 4) % n
        if rem:
            self.pos += n - rem

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def _prim(self, fmt, size):
        self._align(size)
        v = struct.unpack_from("<" + fmt, self.buf, self.pos)[0]
        self.pos += size
        return v

    def u16(self):
        return self._prim("H", 2)

    def u32(self):
        return self._prim("I", 4)

    def i32(self):
        return self._prim("i", 4)

    def u64(self):
        return self._prim("Q", 8)

    def f32(self):
        return self._prim("f", 4)

    def f64(self):
        return self._prim("d", 8)

    def string(self):
        n = self.u32()
        s = self.buf[self.pos : self.pos + n - 1].decode("utf-8", "replace") if n else ""
        self.pos += n
        return s

    def bytes_seq(self):
        n = self.u32()
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def f64_array(self, n):
        self._align(8)
        a = np.frombuffer(self.buf, dtype="<f8", count=n, offset=self.pos)
        self.pos += 8 * n
        return a

    def header(self):
        sec = self.i32()
        nsec = self.u32()
        frame = self.string()
        return sec + nsec * 1e-9, frame


def parse_imu(buf: bytes):
    c = Cdr(buf)
    stamp, _ = c.header()
    quat = c.f64_array(4)  # x y z w
    c.f64_array(9)
    gyro = c.f64_array(3)
    c.f64_array(9)
    acc = c.f64_array(3)
    c.f64_array(9)
    return dict(stamp=stamp, quat_xyzw=quat, gyro=gyro, acc=acc)


def parse_pointcloud2(buf: bytes):
    c = Cdr(buf)
    stamp, frame = c.header()
    height = c.u32()
    width = c.u32()
    n_fields = c.u32()
    fields = {}
    for _ in range(n_fields):
        name = c.string()
        offset = c.u32()
        datatype = c.u8()
        count = c.u32()
        fields[name] = (offset, datatype, count)
    is_bigendian = c.u8()
    point_step = c.u32()
    row_step = c.u32()
    data = c.bytes_seq()
    c.u8()  # is_dense
    return dict(stamp=stamp, frame=frame, height=height, width=width,
                fields=fields, point_step=point_step, data=data)


def parse_image(buf: bytes):
    c = Cdr(buf)
    stamp, frame = c.header()
    height = c.u32()
    width = c.u32()
    encoding = c.string()
    c.u8()  # is_bigendian
    step = c.u32()
    data = c.bytes_seq()
    img = np.frombuffer(data, np.uint8)
    if encoding in ("mono8", "8UC1"):
        img = img.reshape(height, step)[:, :width]
    elif encoding in ("bgr8", "rgb8"):
        img = img.reshape(height, step)[:, : width * 3].reshape(height, width, 3)
        img = img.mean(axis=2).astype(np.uint8)
    return dict(stamp=stamp, image=img.astype(np.float32) / 255.0)


def parse_compressed_image(buf: bytes):
    """sensor_msgs/CompressedImage (header, format string, byte blob) —
    what real handheld-rig bags record on the image topic (the reference's
    quick-start bags use image_transport compressed); grayscale f32 in
    [0, 1] like `parse_image`. A JPEG blob (SOI marker) is decoded by
    `utils/jpeg.decode_gray`: a truncated or corrupt one raises
    ``ValueError`` (the reader counts it skipped, as JAX counts PIL's
    ``OSError``); a progressive or arithmetic-coded one raises
    ``NotImplementedError``. Any other blob is decoded as a PNG by
    `utils/png.decode_gray` (a blob that is not a PNG, or a corrupt one,
    raises ``ValueError``; an interlaced, 16-bit or palette PNG raises
    ``NotImplementedError``, where PIL decodes them)."""
    c = Cdr(buf)
    stamp, _ = c.header()
    fmt = c.string()
    data = bytes(c.bytes_seq())
    if data[:2] == b"\xff\xd8":
        img = jpeg.decode_gray(data)
    else:
        img = png.decode_gray(data)
    return dict(stamp=stamp, image=img.astype(np.float32) / 255.0,
                format=fmt)


# CustomPoint on the wire: {offset_time u32, x/y/z f32, reflectivity u8,
# tag u8, line u8} = 19 bytes, padded to 20 so each element's u32 stays
# 4-aligned (XCDR sequence-of-struct layout). The final element may omit the
# trailing pad byte, hence the copy into a padded buffer below.
_LIVOX_POINT = np.dtype([
    ("off", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("refl", "u1"), ("tag", "u1"), ("line", "u1"), ("_pad", "u1"),
])


def parse_livox_custommsg(buf: bytes):
    """livox_ros_driver2/CustomMsg: header, timebase u64, point_num u32,
    lidar_id u8, rsvd u8[3], points[]: {offset_time u32, x f32, y f32,
    z f32, reflectivity u8, tag u8, line u8}. Vectorized strided decode
    (the per-point CDR walk was the host bottleneck of bag replay)."""
    c = Cdr(buf)
    stamp, _ = c.header()
    timebase = c.u64()
    n = c.u32()
    for _ in range(4):  # lidar_id + rsvd[3]
        c.u8()
    n_seq = c.u32()
    stride = _LIVOX_POINT.itemsize  # 20
    raw = np.zeros(n_seq * stride, np.uint8)
    avail = min(len(buf) - c.pos, n_seq * stride)
    raw[:avail] = np.frombuffer(buf, np.uint8, count=avail, offset=c.pos)
    pts = raw.view(_LIVOX_POINT)
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], -1).astype(np.float32)
    return dict(
        stamp=stamp, xyz=xyz,
        time=pts["off"].astype(np.float32) * 1e-9,
        ring=pts["line"].astype(np.int32),
        intensity=pts["refl"].astype(np.float32),
    )


# PointField.datatype codes (sensor_msgs/msg/PointField)
_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def pointcloud2_to_scan(msg: dict) -> dict:
    """PointCloud2 payload -> pipeline scan dict (xyz/intensity/ring/time),
    non-finite points compacted out.

    The common all-float layout (x,y,z[,intensity f32][,ring u16|line u8]
    [,time f32]) goes through the native C decoder (`utils/native.py`,
    `native/src/lvislam_native.cpp::decode_pointcloud2` — the
    pcl::fromROSMsg counterpart, `imageProjection.cpp:240-260`); anything
    else takes the generic strided numpy path (u32-nanosecond `t`, f64
    `timestamp`, ...), as in the JAX module."""
    from . import native

    fields = msg["fields"]
    data = msg["data"]
    step = int(msg["point_step"])
    n = len(data) // step if step else 0

    def off_dt(name):
        if name not in fields:
            return -1, None
        o, code, _cnt = fields[name]
        return int(o), _PF_DTYPES.get(int(code))

    ox, dx = off_dt("x")
    oy, dy = off_dt("y")
    oz, dz = off_dt("z")
    oi, di = off_dt("intensity")
    orr, drr = off_dt("ring")
    if orr < 0:
        orr, drr = off_dt("line")
    ot, dtt = off_dt("time")

    # aliases the native path cannot convert (u32 ns `t`, f64 `timestamp`)
    # force the generic path below
    has_alt_time = ot < 0 and (off_dt("t")[0] >= 0 or off_dt("timestamp")[0] >= 0)
    fast = (
        n > 0 and dx is np.float32 and dy is np.float32 and dz is np.float32
        and (oi < 0 or di is np.float32)
        and ((ot >= 0 and dtt is np.float32) or (ot < 0 and not has_alt_time))
        and (orr < 0 or drr in (np.uint8, np.uint16))
    )
    if fast:
        xyz, inten, ring, t, valid = native.decode_pointcloud2(
            data, n, step,
            {"x": ox, "y": oy, "z": oz, "intensity": oi, "ring": orr, "time": ot},
            capacity=n, ring_is_uint8=drr is np.uint8,
        )
        w = int(valid.sum())
        return dict(xyz=xyz[:w], intensity=inten[:w], ring=ring[:w], time=t[:w])

    rec = np.frombuffer(data, np.uint8)[: n * step].reshape(n, step)

    def field(off, dt, default=None):
        if off < 0 or dt is None:
            return default
        w_ = np.dtype(dt).itemsize
        return rec[:, off:off + w_].copy().view(dt)[:, 0]

    xyz = np.stack([field(ox, dx), field(oy, dy), field(oz, dz)], -1)
    xyz = xyz.astype(np.float32)
    inten = field(oi, di, np.zeros(n, np.float32)).astype(np.float32)
    ring = field(orr, drr, np.zeros(n, np.uint8)).astype(np.int32)
    t = field(ot, dtt, None)
    if t is None:
        o2, d2 = off_dt("t")
        t = field(o2, d2, None)
        if t is not None and d2 is np.uint32:
            t = t.astype(np.float64) * 1e-9
    if t is None:
        o3, d3 = off_dt("timestamp")
        t = field(o3, d3, None)
        if t is not None and d3 is np.float64:
            t = t - t[0]  # absolute f64 -> scan-relative
    t = np.zeros(n, np.float32) if t is None else t.astype(np.float32)
    ok = np.isfinite(xyz).all(-1)
    return dict(xyz=xyz[ok], intensity=inten[ok], ring=ring[ok], time=t[ok])


def parse_odometry(buf: bytes):
    """nav_msgs/Odometry — the reference's GPS input is this type on
    `odometry/gps` (robot_localization navsat output; `mapOptimization.cpp`
    gpsTopic subscription). Also decodes any other Odometry topic."""
    c = Cdr(buf)
    stamp, frame = c.header()
    child = c.string()
    pos = c.f64_array(3)
    quat = c.f64_array(4)  # x y z w
    cov = c.f64_array(36)
    return dict(stamp=stamp, frame=frame, child_frame=child,
                pos=np.asarray(pos), quat_xyzw=np.asarray(quat),
                # diagonal position variances (x, y, z) — the gates the
                # reference reads (`mapOptimization.cpp:1466-1470`)
                pos_cov=np.asarray([cov[0], cov[7], cov[14]]))


def parse_navsatfix(buf: bytes):
    """sensor_msgs/NavSatFix (raw GPS). Convert to a local frame with
    `navsat_to_enu` before feeding the mapper."""
    c = Cdr(buf)
    stamp, frame = c.header()
    status = c._prim("b", 1)  # NavSatStatus.status (int8)
    service = c.u16()
    lat = c.f64()
    lon = c.f64()
    alt = c.f64()
    cov = c.f64_array(9)
    cov_type = c.u8()
    return dict(stamp=stamp, lat=lat, lon=lon, alt=alt, status=status,
                pos_cov=np.asarray([cov[0], cov[4], cov[8]]),
                cov_type=cov_type)


_EARTH_R = 6378137.0


def navsat_to_enu(lat, lon, alt, ref_lat, ref_lon, ref_alt):
    """Equirectangular lat/lon -> local ENU meters around a reference fix
    (adequate at SLAM mission scales; the reference delegates the same job
    to robot_localization's navsat_transform)."""
    d_lat = np.radians(lat - ref_lat)
    d_lon = np.radians(lon - ref_lon)
    e = d_lon * _EARTH_R * np.cos(np.radians(ref_lat))
    n = d_lat * _EARTH_R
    u = alt - ref_alt
    return np.asarray([e, n, u], np.float64)


_PARSERS = {
    "sensor_msgs/msg/Imu": ("imu", parse_imu),
    "sensor_msgs/msg/PointCloud2": ("pointcloud", parse_pointcloud2),
    "sensor_msgs/msg/Image": ("image", parse_image),
    "sensor_msgs/msg/CompressedImage": ("image", parse_compressed_image),
    "livox_ros_driver2/msg/CustomMsg": ("livox", parse_livox_custommsg),
    "livox_ros_driver/msg/CustomMsg": ("livox", parse_livox_custommsg),
    "nav_msgs/msg/Odometry": ("odometry", parse_odometry),
    "sensor_msgs/msg/NavSatFix": ("navsatfix", parse_navsatfix),
}


class Rosbag2Reader:
    """Iterate a rosbag2 sqlite3 file in timestamp order."""

    def __init__(self, db_path: str, topics: list[str] | None = None):
        self.conn = sqlite3.connect(db_path)
        cur = self.conn.execute("SELECT id, name, type FROM topics")
        self.topics = {tid: (name, typ) for tid, name, typ in cur.fetchall()}
        self.filter = set(topics) if topics else None
        # corrupt/truncated CDR payloads are SKIPPED, not fatal — the same
        # behavior DDS gives the reference for free (a mangled packet never
        # reaches the callback, `utility.h:414-470` QoS); count them here
        # so callers can surface data-quality problems
        self.skipped = 0

    def __iter__(self) -> Iterator[tuple]:
        cur = self.conn.execute(
            "SELECT topic_id, timestamp, data FROM messages ORDER BY timestamp"
        )
        for topic_id, ts, data in cur:
            name, typ = self.topics[topic_id]
            if self.filter and name not in self.filter:
                continue
            entry = _PARSERS.get(typ)
            if entry is None:
                continue
            kind, fn = entry
            try:
                msg = fn(data)
            except (struct.error, IndexError, ValueError, MemoryError,
                    OSError):  # ValueError: a truncated or corrupt JPEG or PNG
                # blob (utils/jpeg.py, utils/png.py, where JAX's PIL raises
                # OSError)
                self.skipped += 1
                continue
            yield ts * 1e-9, name, kind, msg


# ---------------------------------------------------------------------------
# EuRoC ASL
# ---------------------------------------------------------------------------

def euroc_reader(root: str, max_items: int | None = None) -> Iterator[tuple]:
    """Yield (stamp, topic, 'imu'|'image', payload) from a EuRoC mav0 dir
    (BASELINE configs 2/4: MH_01). The cam0 PNGs are decoded by the port's
    own `utils/png.py` into PIL's ``convert("L")`` bytes, / 255 in float32,
    as the JAX reader returns them through PIL (which, where PIL is missing,
    drops every frame and yields the IMU alone)."""
    events = []
    imu_csv = os.path.join(root, "imu0", "data.csv")
    if os.path.exists(imu_csv):
        raw = np.genfromtxt(imu_csv, delimiter=",", skip_header=1)
        for row in raw:
            events.append((row[0] * 1e-9, "imu",
                           dict(gyro=row[1:4], acc=row[4:7])))
    cam_csv = os.path.join(root, "cam0", "data.csv")
    if os.path.exists(cam_csv):
        with open(cam_csv) as f:
            next(f)
            for line in f:
                ts, fname = line.strip().split(",")[:2]
                events.append((float(ts) * 1e-9, "image_path",
                               os.path.join(root, "cam0", "data", fname)))
    events.sort(key=lambda e: e[0])
    if max_items:
        events = events[:max_items]
    for t, kind, payload in events:
        if kind == "image_path":
            img = png.read_gray(payload).astype(np.float32) / 255.0
            yield t, kind.replace("_path", ""), "image", dict(image=img)
        else:
            yield t, "imu0", "imu", payload
