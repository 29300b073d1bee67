"""A torch.profiler trace of a steady stretch of the window, reduced to what
the per-layer readers take: the device's operations, the program's ranges,
the device's busy time and the host's work in its idle gaps.

The trace is exported as Chrome trace JSON into the run's temporary
directory, read back and deleted.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10  # entries of each breakdown list
LABELLED_GAPS = 2000  # the longest idle gaps each labelled by the host's work


class Stretch:
    """``with Stretch() as st:`` profiles the block (CPU and CUDA), timing
    it by the host clock after a synchronize on either side; ``st.result``
    is then a `Trace`."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            finally:
                os.unlink(path)
            self.result = Trace(events, wall)
        return False


class Trace:
    """The device operations (name, start µs, duration µs), the host events
    and the stretch's wall seconds."""

    def __init__(self, events: list, wall_s: float):
        self.wall_s = wall_s
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.device_ops = [(e["name"], float(e["ts"]), float(e["dur"])) for e in dev]
        self.kernels = [op for op, e in zip(self.device_ops, dev) if e["cat"] == "kernel"]
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        self.host = [(e["name"], float(e["ts"]), float(e["dur"]), e["cat"]) for e in host]
        self.ranges = collections.defaultdict(float)  # user_annotation name -> µs
        for name, _, dur, cat in self.host:
            if cat == "user_annotation":
                self.ranges[name] += dur
        self._busy = self._merged()

    def _merged(self) -> list:
        """The union of device intervals, as merged (start, end) µs."""
        out: list = []
        for _, ts, dur in sorted(self.device_ops, key=lambda o: o[1]):
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], ts + dur)
            else:
                out.append([ts, ts + dur])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) / 1e6

    def kernel_durations(self, substring: str) -> list:
        return [dur for name, _, dur in self.kernels if substring in name]

    def top_device_ops(self) -> list:
        """[[kernel name, seconds], ...]: the device operations by total time."""
        tot = collections.Counter()
        for name, _, dur in self.device_ops:
            tot[name] += dur / 1e6
        return [[n, s] for n, s in tot.most_common(TOP)]

    def idle_gaps(self) -> list:
        """[[host work, seconds], ...]: idle device time by what the host was
        doing at each gap's middle (the innermost range, then the innermost
        host operation under it), the longest gaps labelled."""
        if len(self._busy) < 2 or not self.host:
            return []
        b = np.asarray(self._busy)
        starts, ends = b[1:, 0], b[:-1, 1]
        gaps = starts - ends
        order = np.argsort(-gaps)[:LABELLED_GAPS]
        mids = (starts[order] + ends[order]) / 2
        hs = np.array([h[1] for h in self.host])
        he = hs + np.array([h[2] for h in self.host])
        dur = he - hs
        is_range = np.array([h[3] == "user_annotation" for h in self.host])
        tot = collections.Counter()
        for g, m in zip(gaps[order], mids):
            cover = np.nonzero((hs <= m) & (he >= m))[0]
            label = []
            for kind in (is_range, ~is_range):
                c = cover[kind[cover]]
                if len(c):
                    label.append(self.host[c[np.argmin(dur[c])]][0])
            tot[" / ".join(label) or "no host event"] += g / 1e6
        return [[n, s] for n, s in tot.most_common(TOP)]
