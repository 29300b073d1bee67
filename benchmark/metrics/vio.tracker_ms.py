"""vio.tracker_ms: ms a frame in the ``vio.tracker`` spans
(``frame_step._track``: ``tracker_step``, CLAHE with K3 / K4, KLT,
F-RANSAC, refill) of the traced stretch."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.ms("vio.tracker"), s.count("lvi.image"))
