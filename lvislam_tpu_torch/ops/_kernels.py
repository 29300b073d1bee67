"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` — seconds to build, where an extension
that includes PyTorch's headers takes minutes. The build happens at first
use, from the package's own sources only, into ``_build/`` beside this
package (git-ignored); the library's name carries a hash of the sources and
flags, so an edited source rebuilds. Nothing here runs at import time, so a
machine without ``nvcc`` or a GPU imports the package fine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# nvcc's default -fmad=true is kept: it contracts K2's multiply-adds into
# FMAs, as XLA's CPU backend (which computed the reference trajectories)
# does. K1, K3 and K4 use explicitly rounded intrinsics and are not affected.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_LIB = None
BUILD_LOG = ""
BUILD_SECONDS = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # cand, want_tag, corner_off, dist, pos, Q, B, k, stream
    "lvt_knn_tail": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # pts, nbr, par, out, N, kind, stream
    "lvt_gn_partials": [_P, _P, _P, _P, _I, _I, _P],
    # img, hist, H, W, tiles, n_bins, stream
    "lvt_clahe_hist": [_P, _P, _I, _I, _I, _I, _P],
    # img, cdf, out, H, W, tiles, n_bins, stream
    "lvt_clahe_apply": [_P, _P, _P, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _LIB, BUILD_LOG, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    sources = sorted(SRC_DIR.glob("*.cu"))
    headers = sorted(SRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    so = BUILD_DIR / f"liblvt_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
