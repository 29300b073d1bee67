"""lio.posegraph_ms: mean ms of the traced stretch's ``lio.posegraph``
spans (``mapping._optimize_graph``: the whole graph's Gauss-Newton solve
and the pose rewrite after a loop factor); 0 where none ran."""

from benchmark.metrics import _lio, _spans


def read(ctx):
    s = _lio.of(ctx)
    return None if s is None else _spans.per(s.ms("lio.posegraph"), s.count("lio.posegraph"))
