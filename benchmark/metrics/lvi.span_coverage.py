"""lvi.span_coverage (%): the share of the ``lvi.image`` and ``lvi.lidar``
spans' time that the union of the program's spans nested in them covers:
100 less the handlers' untraced self time (``_spans``)."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else s.coverage_pct()
