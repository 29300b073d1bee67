"""k3_roofline (%): K3, the CLAHE tile histograms (``csrc/clahe.cu``): its launches' least time at the
published peaks (``benchmark/roofline.py``, from the configuration's
shapes) over their device time in the traced stretch."""

from benchmark import roofline


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return roofline.share_pct("K3", ctx["program"], tr.kernel_durations("clahe_hist"))
