"""ctypes bindings for the repo's native host data plane
(``native/src/lvislam_native.cpp``) — port of ``lvislam_tpu.utils.native``.

The library builds at first use with the flags of ``native/Makefile``
(``g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared``) into
``lvislam_tpu_torch/_build/`` (git-ignored; the name carries a hash of the
source and flags); nothing is written into ``native/``. Host code, not a
kernel: where no compiler is found every entry point takes the JAX
module's documented NumPy path instead, with the same results, and
`available()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "src" / "lvislam_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_lib = None
_tried = False


def _build() -> Path | None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not SOURCE.exists():
        return None
    h = hashlib.sha256(" ".join([cxx, *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"liblvislam_native_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    i32, i64, f32p = ctypes.c_int32, ctypes.c_int64, np.ctypeslib.ndpointer(np.float32)
    u8p = np.ctypeslib.ndpointer(np.uint8)
    i32p = np.ctypeslib.ndpointer(np.int32)
    f64p = np.ctypeslib.ndpointer(np.float64)
    lib.decode_pointcloud2.restype = ctypes.c_int
    lib.decode_pointcloud2.argtypes = [
        u8p, i64, i32, i32, i32, i32, i32, i32, i32, i32, i64,
        f32p, f32p, i32p, f32p, u8p,
    ]
    lib.imu_window.restype = ctypes.c_int
    lib.imu_window.argtypes = [
        f64p, f32p, f32p, i64, ctypes.c_double, ctypes.c_double, i64,
        f32p, f32p, f32p,
    ]
    lib.voxel_prefilter.restype = ctypes.c_int
    lib.voxel_prefilter.argtypes = [f32p, u8p, i64, ctypes.c_float, i64, f32p, u8p]
    _lib = lib
    return lib


def available() -> bool:
    """True when the native library is built and loaded (else every entry
    point takes its NumPy path)."""
    return _load() is not None


def decode_pointcloud2(
    data: bytes, n_points: int, point_step: int,
    offsets: dict, capacity: int, ring_is_uint8: bool = False,
):
    """Decode a packed point blob -> (xyz, intensity, ring, time, valid).
    `offsets`: {'x':0,'y':4,'z':8,'intensity':12,'ring':16,'time':18}; use
    -1 for absent fields."""
    lib = _load()
    xyz = np.zeros((capacity, 3), np.float32)
    inten = np.zeros(capacity, np.float32)
    ring = np.zeros(capacity, np.int32)
    time = np.zeros(capacity, np.float32)
    valid = np.zeros(capacity, np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    if lib is not None:
        lib.decode_pointcloud2(
            buf, n_points, point_step,
            offsets.get("x", 0), offsets.get("y", 4), offsets.get("z", 8),
            offsets.get("intensity", -1), offsets.get("ring", -1),
            offsets.get("time", -1), int(ring_is_uint8), capacity,
            xyz, inten, ring, time, valid,
        )
        return xyz, inten, ring, time, valid.astype(bool)
    raw = buf[: n_points * point_step].reshape(n_points, point_step)

    def f32(off):
        return raw[:, off:off + 4].copy().view(np.float32)[:, 0]

    x, y, z = f32(offsets["x"]), f32(offsets["y"]), f32(offsets["z"])
    ok = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    idx = np.nonzero(ok)[0][:capacity]
    m = len(idx)
    xyz[:m] = np.stack([x[idx], y[idx], z[idx]], -1)
    if offsets.get("intensity", -1) >= 0:
        inten[:m] = f32(offsets["intensity"])[idx]
    if offsets.get("ring", -1) >= 0:
        off = offsets["ring"]
        if ring_is_uint8:
            ring[:m] = raw[idx, off]
        else:
            ring[:m] = raw[:, off:off + 2].copy().view(np.uint16)[:, 0][idx]
    if offsets.get("time", -1) >= 0:
        time[:m] = f32(offsets["time"])[idx]
    valid[:m] = 1
    return xyz, inten, ring, time, valid.astype(bool)


def imu_window(stamps, gyro, acc, t0: float, t1: float, capacity: int):
    """Padded IMU window in (t0, t1] -> (dts, acc, gyro, n)."""
    lib = _load()
    stamps = np.ascontiguousarray(stamps, np.float64)
    gyro = np.ascontiguousarray(gyro, np.float32)
    acc = np.ascontiguousarray(acc, np.float32)
    dts = np.zeros(capacity, np.float32)
    acc_o = np.zeros((capacity, 3), np.float32)
    gyr_o = np.zeros((capacity, 3), np.float32)
    if lib is not None:
        n = lib.imu_window(stamps, gyro, acc, len(stamps), t0, t1, capacity,
                           dts, acc_o, gyr_o)
        return dts, acc_o, gyr_o, n
    sel = np.nonzero((stamps > t0) & (stamps <= t1))[0][:capacity]
    n = len(sel)
    if n:
        dts[:n] = np.diff(stamps[sel], prepend=t0)
        acc_o[:n] = acc[sel]
        gyr_o[:n] = gyro[sel]
        acc_o[n:] = acc_o[n - 1]
        gyr_o[n:] = gyr_o[n - 1]
    return dts, acc_o, gyr_o, n


def voxel_prefilter(xyz, valid, leaf: float, capacity: int):
    """The first point of each `leaf` voxel, in input order, to `capacity`
    -> (xyz, valid)."""
    lib = _load()
    xyz = np.ascontiguousarray(xyz, np.float32)
    valid = np.ascontiguousarray(valid, np.uint8)
    out = np.zeros((capacity, 3), np.float32)
    vout = np.zeros(capacity, np.uint8)
    if lib is not None:
        lib.voxel_prefilter(xyz, valid, len(xyz), leaf, capacity, out, vout)
        return out, vout.astype(bool)
    keys = np.floor(xyz / leaf).astype(np.int64)
    key = (keys[:, 0] << 42) ^ (keys[:, 1] << 21) ^ keys[:, 2]
    key[~valid.astype(bool)] = np.iinfo(np.int64).max
    _, first = np.unique(key, return_index=True)
    first = np.sort(first[key[first] != np.iinfo(np.int64).max])[:capacity]
    out[: len(first)] = xyz[first]
    vout[: len(first)] = 1
    return out, vout.astype(bool)
