"""The port's feature tracker against the JAX package on the CPU: 6 steps at
320x240 with CLAHE on, from `tracker_init` and from a state carried over
from JAX, with JAX's own RANSAC draws injected through the tracker's
sampler.

Tolerances. Each module matches JAX to f32 rounding, but rounding reaches
the tracker's thresholds: LK stops once every step falls to 0.01 px, so a
window sum one ulp apart can run one iteration more (a ~0.01 px move), and
one feature that then flips at a gate shifts the ids that refill hands out
after it. Measured on these frames: identical ids and tracked counts on
the first 5 steps with points within 0.011 px, one count apart on the
6th. So per step: tracked counts within 2, and at least 90% of JAX's
published (valid) features have a port feature within 0.05 px.

The slow test recomputes the JAX run's values that `chip_smoke.py` gates
the card against (`lvislam_tpu_torch/utils/anchors.py`)."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.core.config import CameraIntrinsics as JCam
from lvislam_tpu.models.vio import feature_tracker as jft
from lvislam_tpu.ops import ransac as jr
from lvislam_tpu.utils import synthetic as jsyn
from lvislam_tpu_torch.models.vio import feature_tracker as tft
from lvislam_tpu_torch.utils import anchors, convert
from lvislam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = JCam(model_type="PINHOLE", gamma1=200.0, gamma2=200.0, u0=160.0, v0=120.0,
           k1=0.0, k2=0.0, p1=0.0, p2=0.0, image_width=320, image_height=240)
PARAMS = jft.TrackerParams(equalize=True)
T0, DT = 1.0, 0.1


def jax_sampler(weights, n_hyp, k):
    """JAX's draws for the tracker's RANSAC: `_sample_indices` with
    `PRNGKey(0)`, as `fundamental_ransac` makes them."""
    w = jnp.asarray(weights.cpu().numpy())
    idx = jr._sample_indices(jax.random.PRNGKey(0), n_hyp, k, w.shape[0], w)
    return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(weights.device)


@pytest.fixture(scope="module")
def frames():
    world = jsyn.default_world(seed=3)
    traj = jsyn.figure8_trajectory(scale=3.0, period=30.0)
    return [jsyn.render_camera_image(world, traj, T0 + DT * k, width=320, height=240, f=200.0)
            for k in range(10)]


def _out(o):
    return {k: np.asarray(getattr(o, k)) for k in ("ids", "uv", "norm", "valid", "n_tracked")}


def _assert_close_step(oj, ot, k):
    assert abs(int(oj["n_tracked"]) - int(ot["n_tracked"])) <= 2, k
    uj, ut = oj["uv"][oj["valid"]], ot["uv"][ot["valid"]]
    if len(uj):
        d = np.abs(uj[:, None, :] - ut[None, :, :]).max(-1).min(1)
        assert (d <= 0.05).mean() >= 0.9, (k, np.sort(d)[-5:])


def _run(jstate, tstate, frames, t0):
    """Step both trackers over `frames`; returns the per-step outputs."""
    tcam, tparams = convert.camera_from_jax(CAM), convert.tracker_params_from_jax(PARAMS)
    outs = []
    for k, f in enumerate(frames):
        t = np.float32(t0 + DT * k)
        jstate, oj = jft.tracker_step(jstate, jnp.asarray(f), jnp.float32(t), PARAMS, CAM)
        tstate, ot = tft.tracker_step(tstate, torch.from_numpy(f), float(t), tparams, tcam,
                                      sampler=jax_sampler)
        outs.append((_out(oj), _out(ot)))
    return outs


def test_six_steps_from_init(frames):
    outs = _run(jft.tracker_init(240, 320, PARAMS),
                tft.tracker_init(240, 320, convert.tracker_params_from_jax(PARAMS), device="cpu"),
                frames[:6], T0)
    for k, (oj, ot) in enumerate(outs):
        _assert_close_step(oj, ot, k)
    assert int(outs[-1][1]["n_tracked"]) > 15
    for oj, ot in outs[:5]:  # before any gate flip (measured): identical tables
        np.testing.assert_array_equal(ot["ids"], oj["ids"])
        np.testing.assert_allclose(ot["uv"], oj["uv"], atol=0.02, rtol=0)


def test_six_steps_from_a_carried_state(frames):
    """Run JAX 4 steps, carry its state (pyramid included) over, then step
    both from the same state."""
    js = jft.tracker_init(240, 320, PARAMS)
    for k in range(4):
        js, _ = jft.tracker_step(js, jnp.asarray(frames[k]), jnp.float32(T0 + DT * k),
                                 PARAMS, CAM)
    ts = convert.tracker_state_from_jax(js)
    for name in ("ids", "track_cnt", "next_id", "initialized"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    outs = _run(js, ts, frames[4:10], T0 + 4 * DT)
    for k, (oj, ot) in enumerate(outs):
        _assert_close_step(oj, ot, k)
    oj, ot = outs[0]
    np.testing.assert_array_equal(ot["ids"], oj["ids"])  # one step from a shared state
    np.testing.assert_allclose(ot["uv"], oj["uv"], atol=0.02, rtol=0)


def test_tracker_init_matches_jax():
    js = jft.tracker_init(240, 321, PARAMS)
    ts = tft.tracker_init(240, 321, convert.tracker_params_from_jax(PARAMS), device="cpu")
    assert [tuple(p.shape) for p in ts.prev_pyr] == [p.shape for p in js.prev_pyr]
    for name in ("pts", "ids", "track_cnt", "norm_pts", "next_id", "prev_time", "initialized"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)


def test_seed_prev_image_matches_jax(frames):
    tparams = convert.tracker_params_from_jax(PARAMS)
    img = np.ascontiguousarray(frames[0][:96, :128])
    js = jft.seed_prev_image(jft.tracker_init(96, 128, PARAMS), jnp.asarray(img), PARAMS)
    ts = tft.seed_prev_image(tft.tracker_init(96, 128, tparams, device="cpu"),
                             torch.from_numpy(img), tparams)
    assert bool(ts.initialized)
    for a, b in zip(ts.prev_pyr, js.prev_pyr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_feature_tracker_module_is_tracker_step(frames):
    tcam, tparams = convert.camera_from_jax(CAM), convert.tracker_params_from_jax(PARAMS)
    module = tft.FeatureTracker(tparams, tcam)
    s1, s2 = module.init_state("cpu"), tft.tracker_init(240, 320, tparams, device="cpu")
    for k in range(3):
        s1, o1 = module(s1, torch.from_numpy(frames[k]), T0 + DT * k)
        s2, o2 = tft.tracker_step(s2, torch.from_numpy(frames[k]), T0 + DT * k, tparams, tcam)
        for a, b in zip(o1, o2):
            assert torch.equal(a, b)
    assert int(o1.n_tracked) > 10  # the port's own sampler, fewer than 8 points on step 0


@pytest.mark.slow
def test_jax_sequence_anchors():
    """Recompute chip_smoke.py's JAX reference values: the JAX tracker over
    the 20 MEI 1024x576 frames and JAX depth association of the last 5
    (about a minute: the frames are raycast on the host)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    cam, world, traj, ts, frames = chip_smoke.tracker_frames()
    params = jft.TrackerParams()
    state = jft.tracker_init(cam.image_height, cam.image_width, params)
    outs = []
    for f, t in zip(frames, ts):
        state, o = jft.tracker_step(state, jnp.asarray(f), jnp.float32(t), params, JCam())
        outs.append(_out(o))
    scans = [tsyn.simulate_lidar_scan(world, traj, i / chip_smoke.RATE, n_scan=4, horizon=6000,
                                      sweep_time=1.0 / chip_smoke.RATE)
             for i in chip_smoke.CLOUD_SCANS]
    cloud = chip_smoke.depth_cloud(scans, traj)
    last = slice(-chip_smoke.DEPTH_FRAMES, None)
    depths = []
    for o, t in zip(outs[last], ts[last]):
        p, q = chip_smoke.body_pose(traj, t)
        depths.append(np.asarray(jft.register_depth(
            jnp.asarray(o["norm"]), jnp.asarray(o["valid"]), jnp.asarray(cloud),
            jnp.ones(len(cloud), bool), jnp.asarray(p), jnp.asarray(q))))
    share, med = chip_smoke.depth_metrics(outs[last], depths, ts[last], world, traj)
    got = {
        "n_tracked": [int(o["n_tracked"]) for o in outs],
        "epipolar_median_px": chip_smoke.epipolar_median_px(outs, ts, traj),
        "depth_share": share,
        "depth_median_err_m": med,
    }
    print(got)
    assert got == anchors.TRACKER_SEQUENCE
