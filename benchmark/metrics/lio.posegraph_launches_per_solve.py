"""lio.posegraph_launches_per_solve: the host's kernel launches
(``cuda_runtime`` / ``cuda_driver`` rows named ``*Launch*``) inside the
``lio.posegraph`` spans, a solve of the traced stretch; 0 where none ran."""

from benchmark.metrics import _lio, _spans


def read(ctx):
    s = _lio.of(ctx)
    return None if s is None else _spans.per(s.launches_in("lio.posegraph"),
                                             s.count("lio.posegraph"))
