"""k1_roofline (%): K1, the 5 nearest of 27 voxel cells (``csrc/knn_tail.cu``): its launches' least time at the
published peaks (``benchmark/roofline.py``, from the configuration's
shapes) over their device time in the traced stretch."""

from benchmark import roofline


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return roofline.share_pct("K1", ctx["program"], tr.kernel_durations("knn_tail"))
