"""The system under test, driven through its public entry points.

``program_config`` builds the port's configuration object from a
configuration file's ``program`` block; ``lio_closed`` and ``lvi_closed``
drive ``LioPipeline.process_scan`` and ``LviSystem.feed_*`` / ``run`` over
a lap of sensor data for the window, and record what each answer was. A `Probe` around the window reads
the program's counters, and profiles a steady stretch of it in a traced run.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np
import torch
from torch.profiler import record_function

from lvislam_tpu_torch.core import hostsync
from lvislam_tpu_torch.models.lio.pipeline import LioConfig, LioPipeline
from lvislam_tpu_torch.models.pipeline import LviConfig, LviSystem
from lvislam_tpu_torch.ops import clahe
from lvislam_tpu_torch.ops import gn_partials as gnp
from lvislam_tpu_torch.ops import knn_tail as kt



def _build(default, fields: dict):
    """`default` (a dataclass instance) with `fields` set, nested blocks
    built the same way; lists become tuples where the default is a tuple."""
    known = {f.name for f in dataclasses.fields(default)}
    out = {}
    for key, val in fields.items():
        if key not in known:
            raise KeyError(f"{type(default).__name__} has no field {key!r}")
        cur = getattr(default, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            val = _build(cur, val)
        elif isinstance(val, list):
            val = tuple(val)
        out[key] = val
    return dataclasses.replace(default, **out)


def program_config(config: dict, traffic: dict):
    """The port's configuration of a configuration file, with the traffic's
    transport knobs (``upload_batch`` of the LIO step, ``replay_batch`` of
    the fused system) set."""
    transport = traffic.get("transport", {})
    default = LioConfig() if config["system"] == "lio" else LviConfig()
    return _build(default, dict(config["program"], **transport))


def counters() -> dict:
    """The program's own counters: host syncs (``core/hostsync.COUNT``) and
    launches of K1-K4."""
    return {"host_syncs": hostsync.COUNT, "K1": kt.LAUNCHES, "K2": gnp.LAUNCHES,
            "K3": clahe.HIST_LAUNCHES, "K4": clahe.APPLY_LAUNCHES}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    """What a window did: its wall seconds, the work units (mapped sweeps or
    events) due and done in it, the sensor seconds done, failures, the
    answers (for the reference), counters over the window, and the traced
    stretch's trace and work units."""

    t_open: float = 0.0  # host clock at the window's start
    wall_s: float = 0.0
    cpu_s: float = 0.0  # the process's CPU seconds in the window, all its threads
    attempted: int = 0
    done: int = 0
    sensor_s: float = 0.0
    failed: int = 0
    lio: list = dataclasses.field(default_factory=list)  # (stamp, x6) from the first answer
    lio_window_from: int = 0  # index of the window's first LIO answer
    vio: list = dataclasses.field(default_factory=list)  # (stamp, summary) in the window
    frames_fed: int = 0  # frames fed in the window (fused system)
    counts: dict = dataclasses.field(default_factory=dict)
    stages: dict = dataclasses.field(default_factory=dict)  # stage -> [ms]
    trace: object = None
    trace_units: int = 0


class Probe:
    """Counters over the window; with `trace`, a profiled stretch of
    `units` work units, started by ``maybe_start`` once a quarter of the
    window has passed and stopped by ``maybe_stop``."""

    def __init__(self, win: Window, seconds: float, trace: bool, units: int):
        self.win, self.seconds, self.units = win, seconds, units
        self.want = trace
        self.stretch = None
        self.c0 = counters()

    def maybe_start(self, elapsed: float, done: int) -> None:
        if self.want and self.stretch is None and elapsed >= 0.25 * self.seconds:
            from .trace import Stretch

            self.stretch, self.start_done = Stretch(), done
            self.stretch.__enter__()

    def maybe_stop(self, done: int, force: bool = False) -> None:
        st = self.stretch
        if st is not None and self.want and (force or done - self.start_done >= self.units):
            st.__exit__(None, None, None)
            self.win.trace, self.win.trace_units = st.result, done - self.start_done
            self.want = False

    def close(self, done: int) -> None:
        self.maybe_stop(done, force=True)
        c = counters()
        self.win.counts = {k: c[k] - self.c0[k] for k in c}


# ---------------------------------------------------------------------------
# The controls, and the LIO step
# ---------------------------------------------------------------------------

CAMERA_LATE_S = 0.03  # the "camera_late" control's offset of every frame stamp


def controlled(scan: dict, control: str | None) -> dict:
    """A scan as the control runs hand it over: "deskew_off" breaks the
    guarantee that every point carries its own time in the sweep, giving
    each the sweep's start time. The camera's control leaves scans alone."""
    if control in (None, "camera_late"):
        return scan
    if control != "deskew_off":
        raise ValueError(f"unknown control {control!r}")
    return dict(scan, time=np.zeros_like(scan["time"]))


def frame_stamp(stamp: float, control: str | None) -> float:
    """A frame's stamp as it is handed over: "camera_late" breaks the
    guarantee that the camera's clock is the IMU's (td fixed at 0), stamping
    every frame `CAMERA_LATE_S` after it was taken."""
    return stamp + CAMERA_LATE_S if control == "camera_late" else stamp


class Throttle:
    """The upstream mapOptimization's ``mappingProcessInterval``
    (``mapOptimization.cpp:312``): a sweep is mapped when `interval` s or
    more have passed since the last mapped one; the others are dropped on
    arrival. At 0.15 s and a 10 Hz sensor, every other sweep is mapped."""

    def __init__(self, interval: float):
        self.interval, self.last = interval, -1e18

    def take(self, stamp: float) -> bool:
        if stamp - self.last < max(self.interval, 1e-9):
            return False
        self.last = stamp
        return True


def scan_inputs(lap, i: int, control: str | None = None):
    """(stamp, the arguments of ``process_scan``) of the stream's i-th scan."""
    stamp, scan = lap.scan(i)
    rel, gyro, rpy = lap.scan_imu[i % len(lap.scan_t)]
    return stamp, (controlled(scan, control), rel, gyro, rpy)


def _drain(pipe, win: Window, taken: int) -> int:
    """Read the trajectory entries the host has not taken yet (one readback
    a batch); returns the new count taken."""
    while taken < len(pipe.trajectory):
        st, x6 = pipe.trajectory[taken]
        rows = x6.detach().cpu().numpy().reshape(-1, 6)
        stamps = st if isinstance(st, tuple) else (st,)
        win.lio.extend(zip(stamps, rows))
        taken += 1
    return taken


def lio_warm(pipe, lap, traffic: dict, thr: Throttle, win: Window, device, control) -> int:
    """The warm span: every sweep stamped before ``warm_s`` through the
    throttle and the step (the replay's two laps fill the map and loop
    closure's slots, so that its window sees the step's steady state);
    returns the next sweep's index."""
    i = 0
    while lap.scan(i)[0] < traffic["warm_s"] - 1e-9:
        stamp, args = scan_inputs(lap, i, control)
        i += 1
        if thr.take(stamp):
            pipe.process_scan(*args)
    pipe.flush()
    _drain(pipe, win, 0)
    sync(device)
    win.lio_window_from = len(win.lio)
    return i


def lio_closed(pipe, lap, traffic: dict, seconds: float, trace: bool, device,
               control=None, interval: float = 0.0) -> Window:
    """Sweeps fed as fast as the step takes them: the warm span, then until
    the window has lasted `seconds` at the end of an upload batch (its
    ``upload_batch`` poses read back together); a mapped sweep whose pose
    never came is missing. The sensor seconds done run from the last warm
    sweep mapped to the last sweep answered."""
    win = Window()
    thr = Throttle(interval)
    i = lio_warm(pipe, lap, traffic, thr, win, device, control)
    first = thr.last
    taken = len(pipe.trajectory)
    probe = Probe(win, seconds, trace, traffic["trace_units"])
    K = pipe.cfg.upload_batch
    n, t0, c0 = 0, time.perf_counter(), time.process_time()
    win.t_open = t0
    while True:
        stamp, args = scan_inputs(lap, i, control)
        i += 1
        if not thr.take(stamp):
            continue  # dropped on arrival, as the upstream's mapping does
        with record_function("bench.lio_scan"):
            pipe.process_scan(*args)
        n += 1
        if n % K:
            continue  # the batch is still being staged
        with record_function("bench.readback"):
            taken = _drain(pipe, win, taken)
        elapsed = time.perf_counter() - t0
        probe.maybe_stop(n)
        if elapsed >= seconds:
            break
        probe.maybe_start(elapsed, n)
    win.wall_s, win.cpu_s = time.perf_counter() - t0, time.process_time() - c0
    probe.close(n)
    win.attempted, win.done = n, len(win.lio) - win.lio_window_from
    win.sensor_s = win.lio[-1][0] - first if win.done else 0.0
    win.failed = sum(not np.isfinite(x).all() for _, x in win.lio[win.lio_window_from:])
    return win


# ---------------------------------------------------------------------------
# The fused system
# ---------------------------------------------------------------------------

class LviDriver:
    """Feeds a fused system the lap's stream event by event (IMU up to the
    event's lookahead, then the scan or frame, then ``run``), recording
    each scan's fused pose and each frame's VIO summary as they reach the
    host."""

    def __init__(self, system, lap, traffic: dict, control=None):
        self.sys, self.lap, self.control = system, lap, control
        self.events = lap.events(traffic["imu_lookahead_s"])
        self.n_traj = 0
        self.frames = 0
        self.failures = 0.0
        self.frames_fed = 0  # frames fed while recording

    def step(self, win: Window, record_vio: bool) -> float:
        """One event; returns its stamp. Counts a raised handler and each new
        VIO failure as failed. A frame's summary is recorded with the stamp
        the system took it at."""
        s = self.sys
        stamp, kind, k, imu = next(self.events)
        for j in imu:
            t, w, f, rpy = self.lap.imu_sample(j)
            s.feed_imu(t, w, f, rpy=rpy)
        if kind == "lidar":
            s.feed_lidar(stamp, controlled(self.lap.scans[k], self.control))
        else:
            s.feed_image(frame_stamp(stamp, self.control), self.lap.frames[k])
            self.frames_fed += record_vio
        try:
            with record_function(f"bench.{kind}"):
                s.run()
        except Exception as e:  # a handler that raised: the event failed
            traceback.print_exception(e, file=sys.stderr)
            win.failed += 1
        while self.n_traj < len(s.trajectory):
            st, x6 = s.trajectory[self.n_traj]
            win.lio.append((st, np.asarray(x6, np.float64).copy()))
            self.n_traj += 1
        if s.vio_frames > self.frames:
            self.frames = s.vio_frames
            summ = np.asarray(s.frame_summary, np.float64).copy()
            if record_vio:
                win.vio.append((float(s.frame_times[-1]), summ))
                win.failed += int(max(summ[19] - self.failures, 0))
            self.failures = max(self.failures, summ[19])
        return stamp


def lvi_closed(system, lap, traffic: dict, seconds: float, trace: bool, device,
               control=None) -> Window:
    """The warm span of sensor time, then events as fast as the system takes
    them until the window has lasted `seconds`."""
    win = Window()
    drv = LviDriver(system, lap, traffic, control)
    last = drv.step(win, record_vio=False)
    while last < traffic["warm_s"] - 1e-9:
        last = drv.step(win, record_vio=False)
    sync(device)
    win.lio_window_from = len(win.lio)
    n_rec = len(system.metrics.records)
    probe = Probe(win, seconds, trace, traffic["trace_units"])
    done, t0, c0, first = 0, time.perf_counter(), time.process_time(), last
    win.t_open = t0
    while True:
        last = drv.step(win, record_vio=True)
        done += 1
        elapsed = time.perf_counter() - t0
        probe.maybe_stop(done)
        if elapsed >= seconds:
            break
        probe.maybe_start(elapsed, done)
    sync(device)
    win.wall_s, win.cpu_s = time.perf_counter() - t0, time.process_time() - c0
    probe.close(done)
    win.attempted = win.done = done
    win.frames_fed = drv.frames_fed
    win.sensor_s = last - first
    win.failed += sum(not np.isfinite(x).all() for _, x in win.lio[win.lio_window_from:])
    processed = {st for st, _ in win.lio[win.lio_window_from:]}
    for r in system.metrics.records[n_rec:]:
        if r["stage"] == "image" or r.get("stamp") in processed:
            win.stages.setdefault(r["stage"], []).append(1e3 * r["dt"])
    return win
