"""lio.loops_closed_share (%): the share of the traced stretch's
``lio.loop_closure`` spans (a loop check) that hold a ``lio.loop_factor``
span (a verified revisit whose factor went into the graph); 0 where the
stretch checked no loop."""

from benchmark.metrics import _lio


def read(ctx):
    s = _lio.of(ctx)
    if s is None:
        return None
    checks = s.count("lio.loop_closure")
    return 100.0 * _lio.holding(s, "lio.loop_closure", "lio.loop_factor") / checks if checks else 0.0
