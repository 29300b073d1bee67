"""vio.ba_iters_per_frame: ``vio.ba_iter`` spans, one an LM iteration of
``ba.solve``, a frame of the traced stretch."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.count("vio.ba_iter"), s.count("lvi.image"))
