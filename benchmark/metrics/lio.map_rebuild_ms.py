"""lio.map_rebuild_ms: ms a mapped sweep (a ``lio.step`` span) in the
``lio.map_rebuild`` spans (``mapping._full_map_rebuild``: the local map
re-assembled from the selected keyframes and both voxel hashes rebuilt,
after every graph correction and every 8 keyframes) of the traced
stretch."""

from benchmark.metrics import _lio


def read(ctx):
    return _lio.per_sweep_ms(ctx, "lio.map_rebuild")
