"""loop.detect_ms: ms a frame in the ``loop.detect`` spans
(``_loop_detect``: ``add_and_detect`` and, on a loop, ``_external_loop``)
of the traced stretch; a frame that is no keyframe opens none."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.ms("loop.detect"), s.count("lvi.image"))
