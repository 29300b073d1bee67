"""The LIO step's spans in a traced stretch, for the LIO cells' readers.
The LIO step runs one mapped sweep synchronously on one host thread under
its root range ``lio.step`` (``models/lio/pipeline.lio_full_step``); a
stretch without one comes from a program that opens none, and the readers
then return None. ``_spans.of`` looks for the fused system's roots, so
these readers build ``_spans.Spans`` themselves."""

from __future__ import annotations

from benchmark.metrics import _spans

ROOT = "lio.step"


def of(ctx) -> _spans.Spans | None:
    """The spans of the run's traced stretch, or None where it holds no
    ``lio.step``."""
    tr = ctx["trace"]
    if tr is None:
        return None
    s = _spans.Spans(tr)
    return s if s.count(ROOT) else None


def per_sweep_ms(ctx, *names) -> float | None:
    """ms a mapped sweep (a ``lio.step`` span) in the named spans."""
    s = of(ctx)
    return None if s is None else _spans.per(s.ms(*names), s.count(ROOT))


def holding(s: _spans.Spans, outer: str, inner: str) -> int:
    """How many `outer` spans hold at least one `inner` span."""
    inside = s.named(inner)
    return sum(any(a <= c and d <= b for c, d in inside) for a, b in s.named(outer))
