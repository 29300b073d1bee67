"""lio.fusion_ms: ms a mapped sweep in the ``lio.fusion`` spans
(``_on_lidar``: the glue window's upload and ``_scan_glue``,
``fusion_correct`` / ``fusion_initialize``) of the traced stretch. A
mapped sweep opens one ``lio.frontend`` span; a throttled one none."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.ms("lio.fusion"), s.count("lio.frontend"))
