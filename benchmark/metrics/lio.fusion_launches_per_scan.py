"""lio.fusion_launches_per_scan: the host's kernel launches inside the
``lio.fusion`` spans, a mapped sweep (a ``lio.frontend`` span) of the
traced stretch."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.launches_in("lio.fusion"), s.count("lio.frontend"))
