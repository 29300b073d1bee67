"""lvi.lidar_handler_ms: mean ms of the fused system's ``lidar`` handler
(its ``StageTimer`` rows) over the window's handled events; a scan the
mapping throttle drops does not count."""


def read(ctx):
    rows = ctx["win"].stages.get("lidar")
    return sum(rows) / len(rows) if rows else None
