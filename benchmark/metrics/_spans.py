"""The program's spans in a traced stretch (``benchmark/trace.Trace``), for
the per-layer readers: its ``record_function`` ranges and the host's kernel
launches. The fused system handles an event synchronously on one host
thread, so an event's spans are the ranges that start inside its handler's
range, ``lvi.image`` or ``lvi.lidar``, the event's root. A stretch with no
handler's range comes from a program that opens none: the readers then
return None. A span that opens no range in a stretch counts 0 there."""

from __future__ import annotations

import bisect

ROOTS = ("lvi.image", "lvi.lidar")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """The stretch's ranges as (start µs, end µs, name), enclosing ranges
    first, and the start µs of every kernel launch on the host."""

    def __init__(self, tr):
        self.ranges = sorted(((ts, ts + dur, name) for name, ts, dur, cat in tr.host
                              if cat == "user_annotation"), key=lambda r: (r[0], -r[1]))
        self.launches = sorted(ts for name, ts, _, cat in tr.host
                               if cat in LAUNCH_CATS and "Launch" in name)

    def named(self, *names) -> list:
        return [(a, b) for a, b, n in self.ranges if n in names]

    def count(self, *names) -> int:
        return len(self.named(*names))

    def ms(self, *names) -> float:
        return sum(b - a for a, b in self.named(*names)) / 1e3

    def launches_in(self, *names) -> int:
        """Kernel launches made inside the named spans."""
        lo, hi = bisect.bisect_left, bisect.bisect_right
        return sum(hi(self.launches, b) - lo(self.launches, a) for a, b in self.named(*names))

    def coverage_pct(self) -> float:
        """The share of the roots' time that the union of the spans nested
        in them covers."""
        starts = [a for a, _, _ in self.ranges]
        total = covered = 0.0
        for i, (a, b, name) in enumerate(self.ranges):
            if name not in ROOTS:
                continue
            total += b - a
            end = a
            for c0, c1, _ in self.ranges[i + 1: bisect.bisect_right(starts, b)]:
                c1 = min(c1, b)
                if c1 > end:
                    covered += c1 - max(c0, end)
                    end = c1
        return 100.0 * covered / total if total > 0 else 0.0


def of(ctx) -> Spans | None:
    """The spans of the run's traced stretch, or None where it has none."""
    tr = ctx["trace"]
    if tr is None:
        return None
    s = Spans(tr)
    return s if s.count(*ROOTS) else None


def per(num: float, den: int) -> float:
    return num / den if den else 0.0
