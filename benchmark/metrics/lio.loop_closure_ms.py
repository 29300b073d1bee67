"""lio.loop_closure_ms: ms a mapped sweep (a ``lio.step`` span) in the
``lio.loop_closure`` spans (``loop_closure_step``: the candidate search,
the submap ICP and the loop factor) of the traced stretch."""

from benchmark.metrics import _lio


def read(ctx):
    return _lio.per_sweep_ms(ctx, "lio.loop_closure")
