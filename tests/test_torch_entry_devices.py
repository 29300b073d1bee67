"""The port's entry points run on the card unless the caller names the CPU:
with no device given they take ``cuda``, and without a CUDA device that
raises instead of falling back to the CPU. ``device="cpu"`` works."""

import pytest
import torch

from lvislam_tpu_torch.models.lio import mapping
from lvislam_tpu_torch.models.lio.pipeline import LioConfig, LioPipeline
from lvislam_tpu_torch.models.vio.feature_tracker import FeatureTracker, tracker_init, TrackerParams

torch.set_num_threads(1)

CAPS = mapping.LioCaps(max_keyframes=8, kf_corner=32, kf_surf=64, sel_keyframes=4,
                       map_corner=256, map_surf=512, scan_corner=32, scan_surf=64,
                       max_loops=2, max_gps=2, loop_submap=128, icp_iters=2)
CFG = LioConfig(n_scan=4, horizon=64, point_capacity=256, caps=CAPS)
BUILDERS = {
    "LioPipeline": lambda **kw: LioPipeline(CFG, **kw).state.x6,
    "lio_init": lambda **kw: mapping.lio_init(CAPS, **kw).x6,
    "FeatureTracker.init_state": lambda **kw: FeatureTracker().init_state(**kw).pts,
    "tracker_init": lambda **kw: tracker_init(48, 64, TrackerParams(), **kw).pts,
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        assert BUILDERS[name]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BUILDERS[name]()


@pytest.mark.parametrize("name", list(BUILDERS))
def test_cpu_when_asked(name):
    assert BUILDERS[name](device="cpu").device.type == "cpu"
