"""vio.ba_ms: ms a frame in the ``vio.ba`` spans (``process_image``:
``ops/ba.solve``, the window's LM solve) of the traced stretch."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.ms("vio.ba"), s.count("lvi.image"))
