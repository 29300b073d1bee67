"""k2_roofline (%): K2, the GN partials of a line or plane fit a point (``csrc/gn_partials.cu``): its launches' least time at the
published peaks (``benchmark/roofline.py``, from the configuration's
shapes) over their device time in the traced stretch."""

from benchmark import roofline


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return roofline.share_pct("K2", ctx["program"], tr.kernel_durations("gn_partials"))
