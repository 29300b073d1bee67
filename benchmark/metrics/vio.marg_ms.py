"""vio.marg_ms: ms a frame in the ``vio.marg`` spans (``process_image``:
``ba.marginalize_old`` or ``marginalize_second_new``) of the traced
stretch."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.ms("vio.marg"), s.count("lvi.image"))
