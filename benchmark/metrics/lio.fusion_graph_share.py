"""lio.fusion_graph_share: the share (%) of the traced stretch's
``lio.fusion`` spans (a mapped sweep's smoother step in ``_on_lidar``) that
hold a ``lio.fusion_graph`` span, the replay of the correction's CUDA graph.
None where the stretch has no ``lio.fusion`` span or no handler's span, or
where the program replays no smoother graphs (its
``models.lio.imu_fusion`` counts no ``CAPTURES``)."""

from benchmark.metrics import _spans


def _replays_graphs() -> bool:
    from lvislam_tpu_torch.models.lio import imu_fusion

    return hasattr(imu_fusion, "CAPTURES")


def read(ctx):
    s = _spans.of(ctx)
    if s is None or not _replays_graphs():
        return None
    outer = s.named("lio.fusion")
    replays = s.named("lio.fusion_graph")
    held = sum(any(a <= c and d <= b for c, d in replays) for a, b in outer)
    return 100.0 * held / len(outer) if outer else None
