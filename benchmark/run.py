"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix,
metrics and checks are found by name (``benchmark/spec.py``). Set-up makes
one lap of the cell's sensor stream on the card from the seed, builds the
system and warms it on the stream's first scans; the window then drives
the system for the given seconds (``benchmark/system.py``). Once it has
closed, the peak memory is read, the system is freed and every answer of
the window is held against the plain reference (``benchmark/reference.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read from a profiled stretch of
the window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit, which also end the
standard error. Without a CUDA card with the cell's chips the run exits 2
and prints no result; if JAX or the JAX package was imported it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import reference, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lvislam_tpu")  # top-level module names
CACHE = spec.ROOT / ".bench_cache"  # the checkout's own build and kernel caches


class NoCard(RuntimeError):
    pass


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card(chips: int):
    """The card the cell runs on; raises `NoCard` where CUDA is missing or
    has fewer cards than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")
    return torch.device("cuda", 0)


def set_caches() -> None:
    """Kernel build caches at fixed paths inside the checkout, so that only
    the first run of a cell there builds. The port builds its own kernels
    into ``lvislam_tpu_torch/_build/``, which is inside it too."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)


def world_seed(seed: int) -> int:
    return seed % (1 << 64)


def make_lap(cell: spec.Cell, seed: int, device, limit: int | None = None):
    """The cell's lap of sensor data, made on `device` from the seed."""
    from .gen import stream

    tr, prog = cell.traffic, cell.config["program"]
    lio = prog.get("lio", prog)
    lidar = dict(tr["lidar"], n_scan=lio["n_scan"], horizon=lio["horizon"])
    if cell.config["system"] == "lio":
        return stream.lio_lap(world_seed(seed), tr["motion"], lidar, device, limit=limit)
    return stream.lvi_lap(world_seed(seed), tr["motion"], lidar, prog["camera"],
                          tr["imu_hz"], device, limit=limit)


def drive(cell: spec.Cell, lap, seconds: float, trace: bool, device, control=None):
    """Build the system and run the warm-up and the window: (Window,
    peak device bytes). The system is freed before returning."""
    import torch

    from . import system as S

    if cell.traffic["loop"] != "closed":
        raise ValueError(f"the harness drives closed loops only, not {cell.traffic['loop']!r}")
    cfg = S.program_config(cell.config, cell.traffic)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if cell.config["system"] == "lio":
        sut = S.LioPipeline(cfg, device=device)
        win = S.lio_closed(sut, lap, cell.traffic, seconds, trace, device, control=control,
                           interval=cell.config["mapping_process_interval"])
    else:
        sut = S.LviSystem(cfg, device=device)
        win = S.lvi_closed(sut, lap, cell.traffic, seconds, trace, device, control=control)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    del sut
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return win, peak


UNITS = {"yaw": "rad", "rot": "rad", "tilt": "rad", "rel_yaw": "rad", "rel_rot": "rad",
         "xy": "m", "pos": "m", "rel_pos": "m", "speed": "mps"}


def _named(prefix: str, errs: dict, keep=slice(None)) -> dict:
    out = {}
    for k, v in errs.items():
        v = v if k.startswith("rel_") else v[keep]
        out[f"{prefix}_{k}_err_{UNITS[k]}"] = reference.worst(v)
    return out


def numbers(cell: spec.Cell, win) -> dict:
    """Every number the checks can compare, from the window's answers and
    the reference (``benchmark/reference.py``), each the worst of the
    window's answers:

    - ``missing``: answers due in the window that never came (fused: frames
      fed in the window that the VIO never answered);
    - ``lio_*``: the LIO answers against where the rig was, from the run's
      first answer (heading, horizontal, 3D position and rotation), against
      gravity (``tilt``), and over the traffic's ``short_horizon_s``
      between the window's answers (``rel_yaw``, ``rel_rot``, ``rel_pos``),
      with the median of the heading's (``rel_yaw_median``): a fault that
      runs through the window moves it, one place where the step slips
      does not;
    - ``vio_*`` (fused): the window's VIO frames the same way, from its
      first estimated frame, with the speed gap, and ``vio_unestimated``,
      the frames of the window that had no estimate."""
    motion, h = cell.traffic["motion"], cell.traffic["short_horizon_s"]
    out = {"missing": float(win.attempted - win.done)}
    if cell.config["system"] == "lvi":
        out["missing"] = float(win.frames_fed - len(win.vio))
    if win.lio:
        st = np.array([s for s, _ in win.lio])
        x6 = np.stack([x for _, x in win.lio])
        w = win.lio_window_from
        out.update(_named("lio", reference.lio_errors(st, x6, motion), slice(w, None)))
        rel = reference.lio_relative(st[w:], x6[w:], motion, h)
        out.update(_named("lio", rel))
        out["lio_rel_yaw_median_err_rad"] = reference.median(rel["rel_yaw"])
    if cell.config["system"] == "lvi":
        up = [(s, x) for s, x in win.vio if x[17] > 0.5]
        out["vio_unestimated"] = float(len(win.vio) - len(up))
        if up:
            st = np.array([s for s, _ in up])
            x = np.stack([x for _, x in up])
            out.update(_named("vio", reference.vio_errors(st, x[:, 0:3], x[:, 3:7], x[:, 7:10],
                                                          motion, h)))
    return out


def answers(win) -> dict:
    """The window's raw answers as arrays (``benchmark.control --dump``)."""
    out = {"lio_window_from": np.int64(win.lio_window_from)}
    if win.lio:
        out["lio_stamps"] = np.array([s for s, _ in win.lio])
        out["lio_x6"] = np.stack([x for _, x in win.lio])
    if win.vio:
        out["vio_stamps"] = np.array([s for s, _ in win.vio])
        out["vio_summary"] = np.stack([x for _, x in win.vio])
    return out


def judge(cell: spec.Cell, found: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): each number the cell's checks
    compare, at most its limit (a number the run could not form fails)."""
    checks = {}
    for name, c in cell.checks["numbers"].items():
        v = found.get(name, float("inf"))  # inf: no answer to judge
        checks[name] = {"value": v if np.isfinite(v) else 1e30, "limit": c["limit"]}
    return all(v["value"] <= v["limit"] for v in checks.values()), checks


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             t_start: float = T_START, control=None, lap_limit=None) -> dict:
    """One run of a cell: the result object of the contract's last line,
    with the numbers not compared under ``found``. Without a `device` the
    card the cell asks for, or `NoCard`. `control` breaks a guarantee of
    the stream (``system.scan_inputs``); `lap_limit` makes only the lap's
    first scans (a test's short run)."""
    cell = spec.cell(workload)
    set_caches()
    import torch

    from . import system  # noqa: F401  (the program's modules: counted as imports)

    if device is None:
        device = card(cell.chips)
    device = torch.device(device)
    marks = {"imports": time.perf_counter()}
    lap = make_lap(cell, seed, device, limit=lap_limit)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    marks["stream"] = time.perf_counter()
    win, peak = drive(cell, lap, seconds, trace, device, control=control)
    setup_s = win.t_open - t_start
    split = {"imports": marks["imports"] - t_start, "stream": marks["stream"] - marks["imports"],
             "system_and_warm": win.t_open - marks["stream"]}
    del lap
    found = numbers(cell, win)
    correct, checks = judge(cell, found)
    ctx = dict(win=win, trace=win.trace, config=cell.config, traffic=cell.traffic,
               program=cell.config["program"], setup_s=setup_s)
    metrics = {}
    for m in cell.metrics(trace):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(win.attempted),
           "failed": int(win.failed), "metrics": metrics, "device": dev}
    if trace and win.trace is not None:
        dev["busy_s"], dev["window_s"] = win.trace.busy_s, win.trace.wall_s
        out["breakdown"] = {"device_ops": win.trace.top_device_ops(),
                            "idle_gaps": win.trace.idle_gaps()}
    out["found"] = {k: v for k, v in found.items() if k not in checks}
    out["setup_split_s"] = split
    out["answers"] = answers(win)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"benchmark: {e}; no result", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run imported {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    out.pop("answers")
    print("setup split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                          out.pop("setup_split_s").items()), file=sys.stderr)
    for name, v in out.pop("found").items():
        print(f"found {name} {v!r} (not compared)", file=sys.stderr)
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
