"""lio.gn_iters_per_scan: ``lio.gn_iter`` spans, one a GN iteration of
``ops/scan2map``, a ``lio.scan_to_map`` span of the traced stretch."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.count("lio.gn_iter"), s.count("lio.scan_to_map"))
