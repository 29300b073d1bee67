"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc``, one process per source started
together, into one shared library with a plain C
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
              "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_LIB = None
BUILD_LOG = ""
BUILD_SECONDS = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # per query set (corner, surf): cand, want_tag, corner_off, dist, pos, Q, B;
    # then k, stream
    "lvt_knn_tail_pair": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # c_pts, c_nbr, Nc, s_pts, s_nbr, Ns, par, rows, ticket, out, stream
    "lvt_gn_partials_pair": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P],
    # c_pts, c_nbr, Nc, s_pts, s_nbr, Ns, S, par, rows, tickets, out, stream
    "lvt_gn_partials_pair_batched": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    # img, hist, H, W, tiles, n_bins, slabs, stream
    "lvt_clahe_hist": [_P, _P, _I, _I, _I, _I, _I, _P],
    # img, cdf, out, H, W, tiles, n_bins, rows, cols, stream
    "lvt_clahe_apply": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
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
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        t0 = time.perf_counter()
        # one nvcc per source, all started together (the build takes the
        # slowest source's time, not the sum), then one link
        try:
            procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for src, o in zip(sources, objs)]
            BUILD_LOG = "".join(p.communicate()[0] for p in procs)
            bad = [s.name for s, p in zip(sources, procs) if p.returncode != 0]
            if bad:
                raise RuntimeError(f"nvcc failed on {', '.join(bad)}:\n{BUILD_LOG}")
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                                  *map(str, objs)], capture_output=True, text=True)
            BUILD_LOG += res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{BUILD_LOG}")
            os.replace(tmp, so)
        finally:
            BUILD_SECONDS = time.perf_counter() - t0
            for o in objs:
                o.unlink(missing_ok=True)
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
