"""lvi.kernels_per_event: CUDA kernels in the traced stretch, an event
(a scan or a frame)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["win"].trace_units:
        return None
    return len(tr.kernels) / ctx["win"].trace_units
