"""lio.step_ms: ms a mapped sweep in the ``lio.step`` spans (one a
``lio_full_step``: front end, scan-to-map, keyframe, graph solve, map
update and loop closure) of the traced stretch."""

from benchmark.metrics import _lio


def read(ctx):
    return _lio.per_sweep_ms(ctx, "lio.step")
