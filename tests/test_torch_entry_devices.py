"""The port's entry points run on the card unless the caller names the CPU:
with no device given they take ``cuda``, and without a CUDA device that
raises instead of falling back to the CPU. ``device="cpu"`` works."""

import pytest
import torch

from lvislam_tpu_torch.core.config import CameraIntrinsics
from lvislam_tpu_torch.models.lio import imu_fusion, mapping
from lvislam_tpu_torch.models.lio.pipeline import LioConfig, LioPipeline
from lvislam_tpu_torch.models.loop import loop_detector
from lvislam_tpu_torch.models.pipeline import LviConfig, LviSystem
from lvislam_tpu_torch.models.vio import estimator, feature_manager
from lvislam_tpu_torch.models.vio.feature_tracker import FeatureTracker, tracker_init, TrackerParams
from lvislam_tpu_torch.models.vio.pipeline import VioRunner, VioRunnerConfig
from lvislam_tpu_torch.core import messages
from lvislam_tpu_torch.ops import ba, chessboard, preintegration
from lvislam_tpu_torch.parallel import batch_replay, mesh
from lvislam_tpu_torch.scripts import run_euroc_vio, run_synthetic_lvi
from lvislam_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CAPS = mapping.LioCaps(max_keyframes=8, kf_corner=32, kf_surf=64, sel_keyframes=4,
                       map_corner=256, map_surf=512, scan_corner=32, scan_surf=64,
                       max_loops=2, max_gps=2, loop_submap=128, icp_iters=2)
CFG = LioConfig(n_scan=4, horizon=64, point_capacity=256, caps=CAPS)
VIO_CAPS = feature_manager.VioCaps(window=3, max_features=16, imu_buf=8, frame_features=8)
BA_CFG = ba.BAConfig(window=3, max_features=16)
RUNNER_CFG = VioRunnerConfig(
    camera=CameraIntrinsics(model_type="PINHOLE", image_width=64, image_height=48),
    tracker=TrackerParams(max_cnt=8, klt_levels=1), caps=VIO_CAPS, ba=BA_CFG,
    image_height=48, image_width=64)
LVI_CFG = LviConfig(
    lio=CFG, vio_caps=VIO_CAPS, ba=BA_CFG, tracker=TrackerParams(max_cnt=8, klt_levels=1),
    camera=RUNNER_CFG.camera, image_height=48, image_width=64, depth_cloud_slots=2,
    loop_caps=loop_detector.LoopCaps(max_keyframes=4, extra_points=8, vocab_words=16),
    vocab_path=None)
BUILDERS = {
    "LioPipeline": lambda **kw: LioPipeline(CFG, **kw).state.x6,
    "lio_init": lambda **kw: mapping.lio_init(CAPS, **kw).x6,
    "FeatureTracker.init_state": lambda **kw: FeatureTracker().init_state(**kw).pts,
    "tracker_init": lambda **kw: tracker_init(48, 64, TrackerParams(), **kw).pts,
    "VioRunner": lambda **kw: VioRunner(RUNNER_CFG, **kw).vio.ws.Ps,
    "vio_init": lambda **kw: estimator.vio_init(VIO_CAPS, estimator.VioParams(), **kw).prior.J,
    "fusion_init": lambda **kw: imu_fusion.fusion_init(imu_fusion.FusionParams(), **kw).sqrt_info,
    "table_init": lambda **kw: feature_manager.table_init(VIO_CAPS, **kw).obs,
    "empty_prior": lambda **kw: ba.empty_prior(BA_CFG, **kw).ws_bar.Qs,
    "preint_init": lambda **kw: preintegration.preint_init([0.0, 0.0, 9.8], [0.0] * 3, [0.0] * 3,
                                                           [0.0] * 3, **kw).jacobian,
    "ImuNoise.create": lambda **kw: preintegration.ImuNoise.create(0.1, 0.01, 1e-3, 1e-4, **kw).acc_n,
    "navstate_identity": lambda **kw: preintegration.navstate_identity(**kw).quat,
    "consistent_window": lambda **kw: synthetic.consistent_window(2, 4, **kw)[2].Ps,
    "LviSystem": lambda **kw: LviSystem(LVI_CFG, **kw).depth_clouds,
    "make_mesh": lambda device=None: torch.empty(0, device=mesh.make_mesh(
        devices=None if device is None else [device] * 2).devices[0, 0]),
    "batched_lio_init": lambda **kw: batch_replay.batched_lio_init(CAPS, 2, **kw).x6,
    "db_init": lambda **kw: loop_detector.db_init(loop_detector.LoopCaps(
        max_keyframes=4, extra_points=8, vocab_words=16), **kw).bags,
    "validity_mask": lambda **kw: messages.validity_mask(2, 4, **kw),
    "board_object_points": lambda **kw: chessboard.board_object_points(2, 3, 0.1, **kw),
    "run_euroc_vio.main": lambda **kw: _script_device(run_euroc_vio, ["/nonexistent"], **kw),
    "run_synthetic_lvi.main": lambda **kw: _script_device(run_synthetic_lvi, ["0.05"], **kw),
}


class _Built(Exception):
    pass


def _script_device(script, argv, device=None):
    """A script's `main` up to the system it builds: the device of the
    first tensor it makes (the run itself is stopped there)."""
    made = []
    cls = script.VioRunner if script is run_euroc_vio else script.lvi.LviSystem

    class Stop(cls):
        def __init__(self, cfg, device=None, **kw):
            made.append(torch.empty(0, device=_resolve(device)))
            raise _Built

    name = "VioRunner" if script is run_euroc_vio else None
    try:
        if name:
            script.VioRunner = Stop
        else:
            script.lvi.LviSystem = Stop
        script.main(argv + ([] if device is None else ["--device", device]))
    except _Built:
        pass
    finally:
        if name:
            script.VioRunner = cls
        else:
            script.lvi.LviSystem = cls
    return made[0]


def _resolve(device):
    from lvislam_tpu_torch.core.device import resolve

    return resolve(device)


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


def test_preint_init_follows_its_inputs():
    """Given a tensor, the fresh delta lies where that tensor lies."""
    acc = torch.zeros(3)
    assert preintegration.preint_init(acc, acc, acc, acc).jacobian.device.type == "cpu"
