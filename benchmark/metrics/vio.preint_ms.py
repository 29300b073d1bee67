"""vio.preint_ms: ms a frame in the ``vio.preint`` spans
(``frame_step._estimate``: ``process_imu``, the frame's IMU
preintegration and propagation) of the traced stretch."""

from benchmark.metrics import _spans


def read(ctx):
    s = _spans.of(ctx)
    return None if s is None else _spans.per(s.ms("vio.preint"), s.count("lvi.image"))
