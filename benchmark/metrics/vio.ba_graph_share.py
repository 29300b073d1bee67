"""vio.ba_graph_share: the share (%) of the traced stretch's ``vio.ba_iter``
and ``vio.marg`` spans (an LM iteration of ``ba.solve``, a
marginalization) that hold a ``vio.ba_graph`` span, the replay of a CUDA
graph. None where the stretch has neither span or no handler's span, or
where the program replays no graphs (its ``ops.ba`` counts no
``CAPTURES``)."""

from benchmark.metrics import _spans


def _replays_graphs() -> bool:
    from lvislam_tpu_torch.ops import ba

    return hasattr(ba, "CAPTURES")


def read(ctx):
    s = _spans.of(ctx)
    if s is None or not _replays_graphs():
        return None
    outer = s.named("vio.ba_iter", "vio.marg")
    replays = s.named("vio.ba_graph")
    held = sum(any(a <= c and d <= b for c, d in replays) for a, b in outer)
    return 100.0 * held / len(outer) if outer else None
