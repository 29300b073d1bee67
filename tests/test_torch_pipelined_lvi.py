"""The pipelined frame stages (``frame_step.track_stage`` /
``estimate_stage``) and ``LviConfig.pipeline_devices`` of the port against
the JAX package's: the two packers byte for byte, the split stages against
the port's own ``frame_step`` bit for bit and against JAX's stages from one
carried JAX state, a pipelined JAX ``LviSystem`` on three virtual CPU
devices carried into the port on ``("cpu",) * 3`` and fed on, and (slow)
the JAX pipelined system's own readings over the 12 s parity sequence,
``anchors.LVI_PIPELINED``."""

import copy
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from lvislam_tpu.models.vio import frame_step as jfs  # noqa: E402
from lvislam_tpu_torch.models.vio import frame_step as tfs  # noqa: E402
from lvislam_tpu_torch.utils import anchors, convert  # noqa: E402
from lvislam_tpu_torch.utils import synthetic as tsyn  # noqa: E402

from test_torch_lvi_system import (  # noqa: E402
    init_frame, jax_lvi_sequence, jax_parity_system, jax_sampler, watch_init)
from test_torch_synthetic_entry import ONE_ULP, _Nudged  # noqa: E402

torch.set_num_threads(1)

PORT_DEVICES = ("cpu", "cpu", "cpu")


def jax_pipelined_system():
    """The phase-14 anchor's JAX system (`jax_parity_system`) rebuilt with
    its three stages on three of the virtual CPU devices that
    `tests/conftest.py` provides: (LIO, tracker, estimator)."""
    from lvislam_tpu.models import pipeline as jlvi

    devs = tuple(jax.devices("cpu")[:3])
    assert len(devs) == 3
    return jlvi.LviSystem(dataclasses.replace(jax_parity_system().cfg, pipeline_devices=devs))


def jax_pipelined_run(data, nudge=None):
    """The JAX pipelined system over the 12 s parity sequence, 2 s then
    10 s as phase 14 feeds it, inputs changed by one `ONE_ULP` entry or
    not: (system, init record, wall seconds)."""
    s = jax_pipelined_system()
    rec = watch_init(s)
    feed = s if nudge is None else _Nudged(s, nudge)
    t0 = time.time()
    tsyn.feed_lvi(feed, data, 0.0, 2.0)
    s.run()
    tsyn.feed_lvi(feed, data, 2.0, 12.0)
    s.run()
    return s, rec, time.time() - t0


def pipelined_ate(s) -> float:
    from lvislam_tpu.utils.metrics import ate_rmse

    traj = tsyn.figure8_trajectory(scale=3.0, period=30.0)
    est = np.stack([np.asarray(x6)[3:6] for _, x6 in s.trajectory])
    gt = np.stack([traj.pose(np.array([t]))[0][0] for t, _ in s.trajectory])
    return float(ate_rmse(est, gt, align=True))


def copy_system(jsys):
    """A deep copy of a pipelined JAX system that shares its devices (JAX
    devices do not copy)."""
    return copy.deepcopy(jsys, {id(d): d for d in jsys.cfg.pipeline_devices})


def anchor_config_sha256(cfg) -> str:
    """The configuration's hash with `pipeline_devices` cleared: devices are
    not configuration values, and the JAX and the port's differ."""
    return anchors.config_sha256(dataclasses.replace(cfg, pipeline_devices=None))


@pytest.mark.slow
def test_jax_pipelined_anchor():
    """The JAX pipelined `LviSystem` on three virtual CPU devices over the
    12 s parity sequence, and the same run with each `ONE_ULP` input
    change: the values `anchors.LVI_PIPELINED` stores (``-s`` prints
    them)."""
    import pprint

    data = jax_lvi_sequence()
    s, rec, wall = jax_pipelined_run(data)
    frame, path = init_frame(rec)
    got = {
        "ate_m": pipelined_ate(s),
        "ate_one_ulp_m": {name: pipelined_ate(jax_pipelined_run(data, name)[0])
                          for name in ONE_ULP},
        "init_frame": frame, "init_path": path,
        "trajectory_points": len(s.trajectory),
        "vio_frames": s.vio_frames,
        "failure_count": int(np.asarray(s.vio.failure_count)),
        "keyframes": int(np.asarray(s.lio.state.kf_count)),
        "config_sha256": anchor_config_sha256(s.cfg),
        "stream_sha256": tsyn.lvi_sequence_sha256(data),
    }
    pprint.pprint(dict(got, wall_s=round(wall, 1)), width=100, sort_dicts=False)
    assert got == anchors.LVI_PIPELINED


# ---- the stages and the pipelined system from carried JAX states ----

CARRY_T, BOOT_T, STEADY_T, END_T = 1.05, 1.15, 1.55, 1.65


@pytest.fixture(scope="module")
def parity_data():
    return tsyn.lvi_sequence(duration=END_T + 0.05)


@pytest.fixture(scope="module")
def jax_pipe_run(parity_data):
    """The JAX pipelined system fed to CARRY_T (10 frames), BOOT_T (its
    queued frame is the lidar-seeded initialization), STEADY_T and END_T;
    deep copies at the first three points, each with its last frame's
    stage-T output still queued (the bus run, not `run`, which drains it)."""
    s = jax_pipelined_system()
    copies = []
    lo = 0.0
    for hi in (CARRY_T, BOOT_T, STEADY_T):
        tsyn.feed_lvi(s, parity_data, lo, hi)
        s.bus.run()
        copies.append(copy_system(s))
        lo = hi
    tsyn.feed_lvi(s, parity_data, lo, END_T)
    s.run()
    return copies + [s]


def _seed_example(rng, with_seed):
    if not with_seed:
        return None
    return dict(Ps=rng.normal(size=(5, 3)), Qs=rng.normal(size=(5, 4)),
                Vs=rng.normal(size=(5, 3)), ba=rng.normal(size=3), bg=rng.normal(size=3))


@pytest.mark.parametrize("case", [False, True])
def test_pack_track_and_pack_estimate_byte_identical(case):
    """The two stage uploads byte for byte as JAX packs them (float and
    8-bit frames, with and without the TF, with and without a seed)."""
    from lvislam_tpu.models.vio import feature_manager as jfm

    rng = np.random.default_rng(5)
    img = rng.random((24, 32)).astype(np.float32)
    fresh = rng.random(6) > 0.5
    body = ([np.array([1.0, 2.0, 3.0]), np.array([0.9, 0.1, 0.2, 0.3])] if case
            else [None, None])
    for im in (img, (img * 255).astype(np.uint8)):
        a = jfs.pack_track(im, 1.25, fresh, *body)
        b = tfs.pack_track(im, 1.25, fresh, *body)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    caps = jfm.VioCaps(window=4, max_features=32, imu_buf=8, frame_features=16)
    dts = rng.random(8).astype(np.float32)
    accs, gyrs = rng.normal(size=(8, 3)).astype(np.float32), rng.normal(size=(8, 3)).astype(np.float32)
    seed = _seed_example(rng, case)
    for n in (0, 5, 8):
        a = jfs.pack_estimate(caps, 1.25, dts, accs, gyrs, n, seed)
        b = tfs.pack_estimate(convert.vio_caps_from_jax(caps), 1.25, dts, accs, gyrs, n, seed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _estimate_inputs(jsys):
    """`_estimate_pending`'s packing of the queued frame on a copy of the
    JAX system: (stamp, pending stage-T output, ebuf, imu_n, seeded)."""
    s = copy_system(jsys)
    pend = s._pending_track
    t = pend["stamp"]
    dts, accs, gyrs, n = s._imu_window(s._last_est_time, t, s.cfg.vio_caps.imu_buf,
                                        interp_end=True)
    s.frame_times.append(t)
    seed = s._lidar_seed(t)
    ebuf = jfs.pack_estimate(s.cfg.vio_caps, t, dts, accs, gyrs, n, seed)
    return t, pend, ebuf, n, seed is not None


@pytest.mark.parametrize("which", ["bootstrap", "steady"])
def test_estimate_stage_from_carried_state(jax_pipe_run, which):
    """`estimate_stage` on the JAX system's queued stage-T output and VIO
    state, JAX's draws injected: the summary within the estimator's bounds
    (bootstrap 5e-3 m / 2e-3, steady 1e-4 m / 1e-5) with its flags equal.
    The bootstrap frame takes the lidar seed."""
    jsys = jax_pipe_run[1] if which == "bootstrap" else jax_pipe_run[2]
    _, pend, ebuf, n, seeded = _estimate_inputs(jsys)
    assert seeded == (which == "bootstrap")
    c = jsys.cfg
    tout, depth, rt = jax.device_put((pend["tout"], pend["depth"], pend["rt"]), jsys._dev_vio)
    _, sj = jfs.estimate_stage(jsys.vio, tout.ids, tout.norm, tout.vel, depth, tout.valid, rt,
                               tout.n_tracked, jax.device_put(jnp.asarray(ebuf), jsys._dev_vio),
                               c.vio_caps, c.vio_params, c.ba)
    port = convert.lvi_system_from_jax(jsys, pipeline_devices=PORT_DEVICES)
    tc, pt = port.cfg, port._pending_track
    _, st, fc = tfs.estimate_stage(
        port.vio, pt["tout"].ids, pt["tout"].norm, pt["tout"].vel, pt["depth"],
        pt["tout"].valid, pt["rt"], pt["tout"].n_tracked, torch.from_numpy(ebuf), tc.vio_caps,
        tc.vio_params, tc.ba, frame_count=port._vio_frame_count, imu_n=n,
        seed_available=seeded, sampler=jax_sampler)
    sj, st = np.asarray(sj), st.numpy()
    assert bool(sj[17] > 0.5) and bool(st[17] > 0.5)
    np.testing.assert_array_equal(st[17:21], sj[17:21])
    pos_tol, q_tol = (5e-3, 2e-3) if which == "bootstrap" else (1e-4, 1e-5)
    np.testing.assert_allclose(st[0:3], sj[0:3], atol=pos_tol)
    np.testing.assert_allclose(st[3:7] * np.sign(st[3]), sj[3:7] * np.sign(sj[3]), atol=q_tol)
    np.testing.assert_allclose(st[7:16], sj[7:16], atol=10 * pos_tol)
    assert fc == int(jsys.vio.frame_count) + (0 if int(jsys.vio.frame_count) >= 10 else 1)


def _next_frame(jsys, data):
    t = min(ts for ts, _ in data["imgs"] if ts > jsys._pending_track["stamp"])
    return t, dict(data["imgs"])[t]


def test_track_stage_from_carried_state(parity_data, jax_pipe_run):
    """`track_stage` of the next frame from the carried tracker and depth
    ring, JAX's draws injected: the same feature ids, validity and count;
    coordinates within 1e-3 px (1e-5 on the normalized plane); depths
    given to the same features, within 1 mm."""
    jsys = jax_pipe_run[2]
    t, img = _next_frame(jsys, parity_data)
    vo = jsys.vins_odom
    tbuf = jfs.pack_track(img, t, jsys.depth_stamps > t - 5.0, vo["trans"], vo["quat"])
    c = jsys.cfg
    _, tj, dj, rj = jfs.track_stage(jsys.tracker, jnp.asarray(tbuf), jsys.depth_clouds,
                                    jsys.depth_valid, c.tracker, c.camera, c.image_height,
                                    c.image_width)
    port = convert.lvi_system_from_jax(jsys, pipeline_devices=PORT_DEVICES)
    tc = port.cfg
    _, tt, dt, rt = tfs.track_stage(port.tracker, torch.from_numpy(tbuf), port.depth_clouds,
                                    port.depth_valid, tc.tracker, tc.camera, tc.image_height,
                                    tc.image_width, sampler=jax_sampler)
    for name in ("ids", "valid", "n_tracked"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(tj, name)))
    live = np.asarray(tj.ids) >= 0
    np.testing.assert_allclose(tt.uv.numpy()[live], np.asarray(tj.uv)[live], atol=1e-3)
    np.testing.assert_allclose(tt.norm.numpy()[live], np.asarray(tj.norm)[live], atol=1e-5)
    dj = np.asarray(dj)
    np.testing.assert_array_equal(dt.numpy() > 0, dj > 0)
    assert (dj > 0).sum() > 10
    np.testing.assert_allclose(dt.numpy()[dj > 0], dj[dj > 0], atol=1e-3)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def test_stages_equal_frame_step_bit_for_bit(parity_data, jax_pipe_run):
    """`track_stage` then `estimate_stage` on one frame give `frame_step`'s
    tracker, VIO state, features, depths and summary bit for bit (the same
    eager ops on the same inputs)."""
    jsys = jax_pipe_run[2]
    port = convert.lvi_system_from_jax(jsys, pipeline_devices=PORT_DEVICES)
    t, img = _next_frame(jsys, parity_data)
    c = port.cfg
    dts, accs, gyrs, n = port._imu_window(port._last_est_time, t, c.vio_caps.imu_buf,
                                          interp_end=True)
    vo = port.vins_odom
    fresh = port.depth_stamps > t - 5.0
    fbuf = tfs.pack_frame(c.vio_caps, img, t, dts, accs, gyrs, n, fresh, vo["trans"],
                          vo["quat"], None)
    common = dict(frame_count=port._vio_frame_count, imu_n=n, seed_available=False,
                  sampler=jax_sampler)
    trk_a, vio_a, tout_a, depth_a, sum_a, fc_a = tfs.frame_step(
        port.tracker, port.vio, torch.from_numpy(fbuf), port.depth_clouds, port.depth_valid,
        c.tracker, c.camera, c.vio_caps, c.vio_params, c.ba, c.image_height, c.image_width,
        **common)
    trk_b, tout_b, depth_b, rt = tfs.track_stage(
        port.tracker, torch.from_numpy(tfs.pack_track(img, t, fresh, vo["trans"], vo["quat"])),
        port.depth_clouds, port.depth_valid, c.tracker, c.camera, c.image_height,
        c.image_width, sampler=jax_sampler)
    vio_b, sum_b, fc_b = tfs.estimate_stage(
        port.vio, tout_b.ids, tout_b.norm, tout_b.vel, depth_b, tout_b.valid, rt,
        tout_b.n_tracked, torch.from_numpy(tfs.pack_estimate(c.vio_caps, t, dts, accs, gyrs,
                                                             n, None)),
        c.vio_caps, c.vio_params, c.ba, **common)
    assert fc_a == fc_b
    assert torch.equal(sum_a, sum_b) and torch.equal(depth_a, depth_b)
    for a, b in zip(tout_a, tout_b):
        assert torch.equal(a, b)
    for tree_a, tree_b in ((trk_a, trk_b), (vio_a, vio_b)):
        fa = convert.to_numpy(tree_a)
        for name, v in convert.to_numpy(tree_b).items():
            np.testing.assert_array_equal(v, fa[name], err_msg=name)


def test_pipelined_system_short_feed_from_carried_state(parity_data, jax_pipe_run):
    """A pipelined JAX `LviSystem` (three virtual CPU devices) carried into
    the port on ("cpu",) * 3 at 1.05 s with its queued stage-T output, then
    0.6 s of the parity sequence through both (JAX's draws in the port): the
    bounds of `test_lvi_system_short_feed_from_carried_state` (the same
    processed scans and estimated frames, the VIO initialized by the lidar
    seed, trajectory rows within 25 mm / 2 mrad, `vins_odom` within 8 mm),
    each stage's state on its device."""
    at_carry, jend = jax_pipe_run[0], jax_pipe_run[3]
    assert at_carry._pending_track is not None
    port = convert.lvi_system_from_jax(at_carry, sampler=jax_sampler,
                                       pipeline_devices=PORT_DEVICES)
    n0 = len(port.trajectory)
    tsyn.feed_lvi(port, parity_data, CARRY_T, END_T)
    port.run()
    assert [t for t, _ in port.trajectory] == [t for t, _ in jend.trajectory]
    assert port.vio_frames == jend.vio_frames and port._pending_track is None
    assert port.frame_times == jend.frame_times
    assert port._vio_initialized and jend._vio_initialized
    a = np.stack([x for _, x in port.trajectory[n0:]])
    b = np.stack([np.asarray(x) for _, x in jend.trajectory[n0:]])
    assert np.abs(a[:, 3:6] - b[:, 3:6]).max() < 0.025
    assert np.abs(a[:, 0:3] - b[:, 0:3]).max() < 2e-3
    assert port.vins_odom["stamp"] == jend.vins_odom["stamp"]
    assert np.abs(port.vins_odom["trans"] - jend.vins_odom["trans"]).max() < 8e-3
    assert port.vins_odom["reset_id"] == jend.vins_odom["reset_id"]
    assert [o[0] for o in port.lio_odoms] == [o[0] for o in jend.lio_odoms]
    assert port.depth_slot == jend.depth_slot
    for x, dev in ((port.lio.state.x6, port._dev_lio), (port.fusion.pos, port._dev_lio),
                   (port.tracker.pts, port._dev_trk), (port.depth_clouds, port._dev_trk),
                   (port.vio.ws.Ps, port._dev_vio), (port.loop_db.bags, port._dev_vio)):
        assert x.device == dev


def test_pipelined_placement_and_stale_frames(parity_data):
    """A pipelined system built on the CPU places each stage's state on its
    device, queues a frame's stage-T output until the next frame (the
    estimator one frame behind) and drains the queue in `run`. Fed frame 0,
    frame 0 again, an older stamp, then frame 1, it queues and estimates
    what the JAX pipelined system does with the same feed: the same
    `frame_times` and `vio_frames` (the reference's pipelined handler tests
    `last_image_time` but never sets it, so it drops no frame). `device`
    beside `pipeline_devices` raises."""
    from lvislam_tpu_torch.models.pipeline import LviSystem

    cfg = dataclasses.replace(convert.lvi_config_from_jax(jax_parity_system().cfg),
                              pipeline_devices=PORT_DEVICES)
    with pytest.raises(ValueError, match="pipeline_devices"):
        LviSystem(cfg, device="cpu")
    sys_ = LviSystem(cfg)
    assert (sys_._dev_lio, sys_._dev_trk, sys_._dev_vio) == (torch.device("cpu"),) * 3
    assert sys_.lio.state.x6.device == sys_.fusion.pos.device == sys_._dev_lio
    assert sys_.tracker.pts.device == sys_.depth_clouds.device == sys_._dev_trk
    assert sys_.vio.ws.Ps.device == sys_.loop_db.bags.device == sys_._dev_vio
    jsys = jax_pipelined_system()
    imgs = parity_data["imgs"]
    both = (jsys, sys_)
    for s in both:
        s.feed_image(*imgs[0])
        s.bus.run()
    assert sys_.vio_frames == jsys.vio_frames == 0
    assert sys_._pending_track["stamp"] == jsys._pending_track["stamp"] == imgs[0][0]
    for s in both:
        s.feed_image(*imgs[0])  # a repeated stamp
        s.feed_image(imgs[0][0] - 0.05, imgs[0][1])  # an older one
        s.bus.run()
    assert sys_.vio_frames == jsys.vio_frames
    assert sys_.frame_times == jsys.frame_times
    assert sys_._pending_track["stamp"] == jsys._pending_track["stamp"]
    for s in both:
        s.feed_image(*imgs[1])
        s.run()  # stage E for the queued frame, stage T for frame 1, then the drain
    assert sys_.vio_frames == jsys.vio_frames and sys_._pending_track is None
    assert jsys._pending_track is None
    assert sys_.frame_times == jsys.frame_times
    assert sys_.frame_times[-1] == imgs[1][0]
