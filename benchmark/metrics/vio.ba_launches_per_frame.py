"""vio.ba_launches_per_frame: the host's kernel launches (``cuda_runtime`` /
``cuda_driver`` rows named ``*Launch*``) inside the ``vio.ba`` spans, a
frame of the traced stretch."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.launches_in("vio.ba"), s.count("lvi.image"))
