"""The batched fused replay (``lvislam_tpu_torch.models.replay`` and
``LviSystem``'s event staging behind ``LviConfig.replay_batch``) against
the JAX package's: the event packers byte for byte, the scan and frame
events from one carried JAX ``ReplayCarry``, a JAX ``LviSystem`` whose
replay is active carried into the port and fed on, the port's own paths
(partial-batch flush, a failing batch, the hand-back on a VIO failure,
``pipeline_devices`` beside ``replay_batch``), and (slow) the JAX replay's
readings over the 12 s parity sequence, ``anchors.LVI_REPLAY``."""

import copy
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from lvislam_tpu.models import replay as jrp  # noqa: E402
from lvislam_tpu_torch.models import replay as trp  # noqa: E402
from lvislam_tpu_torch.utils import anchors, convert  # noqa: E402
from lvislam_tpu_torch.utils import synthetic as tsyn  # noqa: E402

from test_torch_lvi_system import (  # noqa: E402
    init_frame, jax_lvi_sequence, jax_parity_system, jax_sampler, watch_init)
from test_torch_synthetic_entry import ONE_ULP, _Nudged  # noqa: E402

torch.set_num_threads(1)

ANCHOR_BATCH = 16  # `bench.py:539`


def jax_replay_system(batch: int = ANCHOR_BATCH):
    """The phase-14 anchor's JAX system (`jax_parity_system`) with the
    bench's `replay_batch`."""
    s = jax_parity_system()
    s.cfg.replay_batch = batch
    return s


def ate_of(s) -> float:
    from lvislam_tpu.utils.metrics import ate_rmse

    traj = tsyn.figure8_trajectory(scale=3.0, period=30.0)
    est = np.stack([np.asarray(x6)[3:6] for _, x6 in s.trajectory])
    gt = np.stack([traj.pose(np.array([t]))[0][0] for t, _ in s.trajectory])
    return float(ate_rmse(est, gt, align=True))


def jax_replay_run(data, nudge=None):
    """The JAX replay system over the 12 s parity sequence, 2 s then 10 s
    as phase 24 feeds it, inputs changed by one `ONE_ULP` entry or not:
    (system, init record, wall seconds)."""
    s = jax_replay_system()
    rec = watch_init(s)
    feed = s if nudge is None else _Nudged(s, nudge)
    t0 = time.time()
    tsyn.feed_lvi(feed, data, 0.0, 2.0)
    s.run()
    tsyn.feed_lvi(feed, data, 2.0, 12.0)
    s.run()
    return s, rec, time.time() - t0


def replay_anchor_values(s, rec) -> dict:
    """The fields of `anchors.LVI_REPLAY` of one JAX run (its ATE aside)."""
    frame, path = init_frame(rec)
    return {
        "init_frame": frame, "init_path": path,
        "trajectory_points": len(s.trajectory),
        "vio_frames": s.vio_frames,
        "failure_count": int(np.asarray(s.vio.failure_count)),
        "keyframes": int(np.asarray(s.lio.state.kf_count)),
        "config_sha256": anchors.config_sha256(s.cfg),
    }


@pytest.mark.slow
def test_jax_replay_anchor():
    """The JAX `LviSystem` with `replay_batch = 16` on the CPU over the 12 s
    parity sequence, and the same run with each `ONE_ULP` input change: the
    values `anchors.LVI_REPLAY` stores (``-s`` prints them)."""
    import pprint

    data = jax_lvi_sequence()
    s, rec, wall = jax_replay_run(data)
    assert s._replay_statics is not None and s._replay_active
    got = {"ate_m": ate_of(s),
           "ate_one_ulp_m": {name: ate_of(jax_replay_run(data, name)[0]) for name in ONE_ULP},
           **replay_anchor_values(s, rec),
           "stream_sha256": tsyn.lvi_sequence_sha256(data)}
    pprint.pprint(dict(got, wall_s=round(wall, 1)), width=100, sort_dicts=False)
    assert got == anchors.LVI_REPLAY


# ---- the packers ----

def _parity_statics():
    """The JAX replay statics of the parity configuration, and the port's
    from the converted configuration."""
    jcfg = jax_replay_system(8).cfg
    return jrp.statics_from(jcfg), trp.statics_from(convert.lvi_config_from_jax(jcfg))


def test_statics_field_for_field():
    """`statics_from` at the parity configuration: every field (nested
    configurations as dicts) and the row sizes equal JAX's, and the
    converted JAX statics equal the port's own."""
    jst, tst = _parity_statics()
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    for name in ("scan_len", "frame_len", "row_len", "depth_n"):
        assert getattr(tst, name) == getattr(jst, name), name
    assert convert.replay_statics_from_jax(jst) == tst
    assert (trp.KIND_SCAN, trp.KIND_FRAME, trp.KIND_NOOP, trp.GUESS_CAP, trp.GLUE_CAP,
            trp._HDR, trp._AUX_F32, trp._SCAN_OUT, trp._FRAME_OUT, trp.OUT_LEN) == \
        (jrp.KIND_SCAN, jrp.KIND_FRAME, jrp.KIND_NOOP, jrp.GUESS_CAP, jrp.GLUE_CAP,
         jrp._HDR, jrp._AUX_F32, jrp._SCAN_OUT, jrp._FRAME_OUT, jrp.OUT_LEN)


def _window(rng, n):
    return (rng.random(80).astype(np.float32) * 0.01, rng.normal(size=(80, 3)).astype(np.float32),
            rng.normal(size=(80, 3)).astype(np.float32), n)


@pytest.mark.parametrize("n_guess,n_glue,do_depth", [(0, 0, False), (5, 64, True), (80, 12, True)])
def test_packers_byte_identical(n_guess, n_glue, do_depth):
    """`pack_scan_event` (empty, partial and over-full IMU windows, with and
    without the depth flag), `pack_frame_event` and `pack_noop_event` byte
    for byte as JAX packs them, at the parity configuration."""
    jst, tst = _parity_statics()
    rng = np.random.default_rng(n_guess + n_glue)
    scan_buf = rng.integers(-2000, 2000, tst.scan_len).astype(np.int16)
    guess, glue = _window(rng, n_guess), _window(rng, n_glue)
    a = jrp.pack_scan_event(jst, scan_buf, do_depth, guess, glue)
    b = trp.pack_scan_event(tst, scan_buf, do_depth, guess, glue)
    assert a.dtype == b.dtype == np.int16 and a.tobytes() == b.tobytes()
    frame_buf = rng.integers(-2000, 2000, tst.frame_len).astype(np.int16)
    assert jrp.pack_frame_event(jst, frame_buf).tobytes() == \
        trp.pack_frame_event(tst, frame_buf).tobytes()
    assert jrp.pack_noop_event(jst).tobytes() == trp.pack_noop_event(tst).tobytes()


# ---- a JAX replay system carried into the port ----

BATCH = 8
CARRY_T, END_T = 1.65, 2.85  # 1.65 s: the replay active (init at 1.15 s)


@pytest.fixture(scope="module")
def parity_data():
    return tsyn.lvi_sequence(duration=END_T + 0.3)


def copy_replay_system(s):
    """A deep copy of a JAX replay system without its worker thread and
    queues (threads do not copy; the copy starts its own if it ships)."""
    keep = (s._rp_worker, s._rp_q, s._rp_results)
    s._rp_worker = s._rp_q = s._rp_results = None
    try:
        return copy.deepcopy(s)
    finally:
        s._rp_worker, s._rp_q, s._rp_results = keep


@pytest.fixture(scope="module")
def jax_replay_fed(parity_data):
    """The JAX system with `replay_batch = 8` fed to CARRY_T (its replay
    active and drained), a copy there, then fed on to END_T."""
    s = jax_replay_system(BATCH)
    tsyn.feed_lvi(s, parity_data, 0.0, CARRY_T)
    s.run()
    assert s._replay_active and not s._ev_rows
    at_carry = copy_replay_system(s)
    tsyn.feed_lvi(s, parity_data, CARRY_T, END_T)
    s.run()
    return at_carry, s


def _stage(jsys, data, kind, t):
    """On a copy of `jsys`: its IMU up to t, then the scan or frame at t
    staged as `_on_lidar` / `_on_image` stage it. Returns (the copy, the
    row)."""
    c = copy_replay_system(jsys)
    c.cfg.replay_batch = 10 ** 6  # stage only
    for i, ti in enumerate(data["imu_ts"]):
        if c.imu_times[-1] < ti <= t:
            c._on_imu(ti, dict(gyro=data["w"][i], acc=data["f"][i], rpy=data["rpys"][i]))
    if kind == "scan":
        c._stage_scan(t, dict(data["scans"])[t])
    else:
        c._stage_frame(t, dict(image=dict(data["imgs"])[t]))
    return c, c._ev_rows[-1]


def _jax_event(c, row):
    """JAX's `replay_batch_step` on [row] + 7 no-op rows (the system's own
    compiled batch): (carry', the row's outputs)."""
    rows = [row] + [jrp.pack_noop_event(c._replay_statics)] * (BATCH - 1)
    carry, outs = jrp.replay_batch_step(c._carry, jnp.asarray(np.stack(rows)),
                                        c._replay_statics)
    return carry, np.asarray(outs)[0]


def _next(data, key, after):
    return min(t for t, _ in data[key] if t > after + 1e-9)


@pytest.mark.parametrize("case", ["depth", "depth_no_guess", "no_depth"])
def test_scan_event_from_carried_state(parity_data, jax_replay_fed, case):
    """`_scan_branch` of the next processed scan from the carried JAX
    `ReplayCarry`: the 48 outputs (the LIO pose within the carried-state
    bounds of `test_torch_lio_slice`, 1e-2 m / 2e-3 rad; the fused position
    and velocity, corrected by that pose, within the same 1e-2, its
    attitude within 2e-3, its biases within 1e-4; the flags, reset id and
    keyframe count equal), `vins`
    unchanged, and the depth ring written at the same slot with the same
    stamp and validity, the other slots untouched. The written slot holds
    the new keyframe's surf cloud, the front end's voxels cut to the slot's
    capacity; the port's front end differs from JAX's in a few points of
    the scan, which moves which voxels the cut keeps, so at least 98% of the
    slot's points have a JAX point within 1 mm (7 of 1024 do not, here).
    "depth_no_guess" clears the carry's guess flag: the masked write leaves
    ring and slot as they were."""
    at_carry = jax_replay_fed[0]
    t = _next(parity_data, "scans", at_carry._last_map_time + 0.15 - 1e-6)
    c, row = _stage(at_carry, parity_data, "scan", t)
    hdr = row[:trp._HDR].view(np.float32)
    hdr[1] = float(case != "no_depth")
    if case == "depth_no_guess":
        c._carry = c._carry._replace(vins=c._carry.vins.at[18].set(0.0))
    jc, jo = _jax_event(c, row)
    tc, to = trp._scan_branch(convert.replay_carry_from_jax(c._carry, "cpu"),
                              torch.from_numpy(row), convert.replay_statics_from_jax(
                                  c._replay_statics))
    to = to.numpy()
    assert to[0] == jo[0] == trp.KIND_SCAN
    np.testing.assert_allclose(to[4:7], jo[4:7], atol=1e-2)  # x6 translation
    np.testing.assert_allclose(to[1:4], jo[1:4], atol=2e-3)  # x6 rotation
    np.testing.assert_allclose(to[7:10], jo[7:10], atol=1e-2)  # fused position
    np.testing.assert_allclose(to[10:14] * np.sign(to[10]), jo[10:14] * np.sign(jo[10]),
                               atol=2e-3)  # fused attitude
    np.testing.assert_allclose(to[14:17], jo[14:17], atol=1e-2)  # fused velocity
    np.testing.assert_allclose(to[17:23], jo[17:23], atol=1e-4)  # biases
    np.testing.assert_array_equal(to[23:27], jo[23:27])  # reset id, degenerate, kf, init
    np.testing.assert_array_equal(to[27:], jo[27:])
    np.testing.assert_array_equal(tc.vins.numpy(), np.asarray(jc.vins))
    np.testing.assert_array_equal(tc.depth_stamps.numpy(), np.asarray(jc.depth_stamps))
    assert int(tc.depth_slot) == int(jc.depth_slot) == \
        int(c._carry.depth_slot) + (case == "depth")
    np.testing.assert_array_equal(tc.depth_valid.numpy(), np.asarray(jc.depth_valid))
    k = int(c._carry.depth_slot) % tc.depth_clouds.shape[0]
    ct, cj = tc.depth_clouds.numpy(), np.asarray(jc.depth_clouds)
    other = np.arange(ct.shape[0]) != k
    np.testing.assert_array_equal(ct[other], cj[other])
    if case == "depth":
        from scipy.spatial import cKDTree

        v = tc.depth_valid.numpy()[k]
        assert v.sum() > 100
        near, _ = cKDTree(cj[k][v]).query(ct[k][v])
        assert (near < 1e-3).mean() >= 0.98
    else:
        np.testing.assert_array_equal(ct, np.asarray(c._carry.depth_clouds))


def test_frame_event_from_carried_state(parity_data, jax_replay_fed):
    """`_frame_branch` of the next frame from the carried JAX `ReplayCarry`,
    JAX's draws injected. Against the port's own `frame_step` given the
    same frame with the freshness mask computed from the ring's stamps and
    the TF from `vins` packed by the host (the interactive form): the
    outputs, tracker and VIO state bit for bit. Against JAX: the tracked
    count equal and the ids equal but for one pair of slots (on this frame
    the F-RANSAC keeps one borderline feature where JAX keeps another), so
    the estimator solves a window that differs by one feature: its summary
    within the bootstrap-frame bounds of `test_frame_step_from_carried_state`
    (5e-3 m, 2e-3, 5e-2 on velocity and biases), the flags equal, `vins` the
    summary's nav state at the frame stamp, the window fill equal."""
    from lvislam_tpu_torch.models.vio import frame_step as tfs

    at_carry = jax_replay_fed[0]
    t = _next(parity_data, "imgs", at_carry.last_image_time)
    c, row = _stage(at_carry, parity_data, "frame", t)
    jc, jo = _jax_event(c, row)
    carry = convert.replay_carry_from_jax(c._carry, "cpu")
    st_ = convert.replay_statics_from_jax(c._replay_statics)
    tc, to = trp._frame_branch(carry, torch.from_numpy(row), st_, sampler=jax_sampler)

    # the port's interactive form of the same frame, bit for bit
    H, W, M = st_.height, st_.width, st_.vio_caps.imu_buf
    fbuf = row[trp._HDR: trp._HDR + st_.frame_len].copy()
    f = fbuf[H * W // 2:].view(np.float32)
    vins = carry.vins.numpy()
    fresh = carry.depth_stamps.numpy() > f[M * 7] - np.float32(5.0)
    f[M * 7 + 2], f[M * 7 + 3: M * 7 + 10] = 1.0, vins[1:8]
    f[M * 7 + 12: M * 7 + 12 + st_.depth_slots] = fresh
    trk, vio, _, _, summary, fc = tfs.frame_step(
        carry.tracker, carry.vio, torch.from_numpy(fbuf), carry.depth_clouds, carry.depth_valid,
        st_.tracker, st_.cam, st_.vio_caps, st_.vio_params, st_.ba_cfg, H, W,
        frame_count=carry.frame_count, imu_n=int(f[M * 7 + 1]), seed_available=False,
        sampler=jax_sampler)
    assert fc == tc.frame_count
    np.testing.assert_array_equal(to.numpy()[1 + trp._SCAN_OUT:], summary.numpy())
    for a, b in ((trk, tc.tracker), (vio, tc.vio)):
        fa = convert.to_numpy(a)
        for name, v in convert.to_numpy(b).items():
            np.testing.assert_array_equal(v, fa[name], err_msg=name)

    to, f = to.numpy(), slice(1 + trp._SCAN_OUT, None)
    assert to[0] == jo[0] == trp.KIND_FRAME
    np.testing.assert_array_equal(to[1:f.start], 0.0)
    ids_t, ids_j = tc.tracker.ids.numpy(), np.asarray(jc.tracker.ids)
    assert (ids_t != ids_j).sum() <= 2
    st, sj = to[f], jo[f]
    assert sj[17] > 0.5
    np.testing.assert_array_equal(st[17:21], sj[17:21])
    np.testing.assert_allclose(st[0:3], sj[0:3], atol=5e-3)
    np.testing.assert_allclose(st[3:7] * np.sign(st[3]), sj[3:7] * np.sign(sj[3]), atol=2e-3)
    np.testing.assert_allclose(st[7:16], sj[7:16], atol=5e-2)
    vt, vj = tc.vins.numpy(), np.asarray(jc.vins)
    assert vt[0] == vj[0] == np.float32(t) and vt[17:].tolist() == vj[17:].tolist()
    np.testing.assert_array_equal(vt[1:17], st[0:16])
    assert tc.frame_count == int(jc.vio.frame_count)


def test_loop_points_match_jax(parity_data, jax_replay_fed):
    """`_loop_points` (shared by the frame event and `_loop_detect`) on the
    carried VIO state and the tracker's live features: the validity equal
    and the world points within 1e-5 m of JAX's."""
    from lvislam_tpu.models.vio import feature_tracker as jft
    from lvislam_tpu_torch.models.vio import feature_tracker as tft

    vio, tr = jax_replay_fed[0]._carry.vio, jax_replay_fed[0]._carry.tracker
    valid = (tr.ids >= 0) & (tr.track_cnt > 1)
    jout = jft.TrackerOutput(ids=tr.ids, uv=tr.pts, norm=tr.norm_pts,
                             vel=jnp.zeros_like(tr.pts), valid=valid, n_tracked=jnp.sum(valid))
    pj, vj = jrp._loop_points(vio, jout)
    tout = tft.TrackerOutput(*(torch.from_numpy(np.array(np.asarray(x))) for x in jout))
    pt, vt = trp._loop_points(convert.vio_state_from_jax(vio, "cpu"), tout)
    ok = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), ok)
    assert ok.sum() > 10
    np.testing.assert_allclose(pt.numpy()[ok], np.asarray(pj)[ok], atol=1e-5)


@pytest.fixture(scope="module")
def port_fed(parity_data, jax_replay_fed):
    """The JAX system at CARRY_T carried into the port (JAX's draws) and fed
    on to END_T."""
    port = convert.lvi_system_from_jax(jax_replay_fed[0], device="cpu", sampler=jax_sampler)
    assert port._replay_active and port._carry.frame_count == port._vio_frame_count
    n0 = len(port.trajectory)
    tsyn.feed_lvi(port, parity_data, CARRY_T, END_T)
    port.run()
    return port, n0


def test_carried_replay_fed_two_batches(port_fed, jax_replay_fed):
    """From the carried replay, END_T - CARRY_T of the parity sequence
    through both (two full batches and a flushed partial one): the same
    trajectory stamps and frames, the fused IMU-rate stream's length and
    the ring's stamps and slot equal; td equal (estimate_td is off); every
    staged event came back, one upload and one readback a batch. The poses
    within 50 mm / 5 mrad: from the first frame on, the two solve windows
    that differ by a feature (`test_frame_event_from_carried_state`), and
    the rows drift apart as the interactive path's do
    (`test_lvi_system_short_feed_from_carried_state`: 25 mm / 2 mrad over
    half this span); JAX holds its own replay to 0.10 m of its interactive
    path (`tests/test_lvi_replay.py`)."""
    port, n0 = port_fed
    jend = jax_replay_fed[1]
    assert [t for t, _ in port.trajectory] == [t for t, _ in jend.trajectory]
    assert len(port.trajectory) - n0 >= 5
    assert port.vio_frames == jend.vio_frames and port._replay_active
    a = np.stack([np.asarray(x) for _, x in port.trajectory[n0:]])
    b = np.stack([np.asarray(x) for _, x in jend.trajectory[n0:]])
    assert np.abs(a[:, 3:6] - b[:, 3:6]).max() < 0.05
    assert np.abs(a[:, 0:3] - b[:, 0:3]).max() < 5e-3
    assert port._td == jend._td
    assert len(port.imu_rate_odom) == len(jend.imu_rate_odom)
    rc = port.replay_counts
    assert rc["batches"] >= 2 and rc["uploads"] == rc["readbacks"] == rc["batches"]
    assert rc["staged"] == rc["returned"] and not port._ev_rows
    assert not port._rp_pending
    np.testing.assert_array_equal(port._carry.depth_stamps.numpy(),
                                  np.asarray(jend._carry.depth_stamps))
    assert int(port._carry.depth_slot) == int(jend._carry.depth_slot)
    # the host handles point at the carried state after the drain
    assert port.lio.state is port._carry.lio and port.vio is port._carry.vio


# ---- the port's own paths, from the carried replay system ----

def _port_at_carry(jax_replay_fed, **cfg):
    port = convert.lvi_system_from_jax(jax_replay_fed[0], device="cpu", sampler=jax_sampler)
    port.cfg = dataclasses.replace(port.cfg, **cfg)
    return port


def test_partial_batch_flush_keeps_order(parity_data, jax_replay_fed):
    """A run that ends mid-batch ships the staged events padded with no-op
    rows; a second drive continues the same carry; the trajectory stays
    ordered and nothing is stranded (the port's counterpart of
    `tests/test_lvi_replay.py::test_replay_partial_batch_flush`)."""
    port = _port_at_carry(jax_replay_fed)
    n0, b0 = len(port.trajectory), port.replay_counts["batches"]
    tsyn.feed_lvi(port, parity_data, CARRY_T, CARRY_T + 0.2)  # fewer events than a batch
    port.bus.run()
    assert 0 < len(port._ev_rows) < BATCH and port.replay_counts["batches"] == b0
    port.run()
    assert not port._ev_rows and port.replay_counts["batches"] == b0 + 1
    n1 = len(port.trajectory)
    assert n1 > n0
    tsyn.feed_lvi(port, parity_data, CARRY_T + 0.2, CARRY_T + 0.5)
    port.run()
    stamps = [t for t, _ in port.trajectory]
    assert len(stamps) > n1 and stamps == sorted(stamps)
    assert port.replay_counts["staged"] == port.replay_counts["returned"]
    assert not port._rp_pending


def test_batch_failure_surfaces_at_run(parity_data, jax_replay_fed, monkeypatch):
    """An exception inside `replay_batch_step` is raised by `run`."""
    port = _port_at_carry(jax_replay_fed)

    def boom(*a, **kw):
        raise FloatingPointError("injected")

    monkeypatch.setattr(trp, "replay_batch_step", boom)
    tsyn.feed_lvi(port, parity_data, CARRY_T, CARRY_T + 0.3)
    with pytest.raises(FloatingPointError, match="injected"):
        port.run()


def test_vio_failure_hands_back_to_interactive(parity_data, jax_replay_fed, monkeypatch):
    """A frame output that comes back uninitialized (a forced VIO failure)
    deactivates the replay: the carry is handed back (ring stamps and slot,
    `vins_odom`, the window fill), the fused odometry stream is cleared,
    and the next frame runs the interactive path (`frame_step` in the
    handler) before the replay takes over again."""
    port = _port_at_carry(jax_replay_fed)
    branch, forced = trp._frame_branch, []

    def failing(*a, **kw):
        carry, out = branch(*a, **kw)
        if not forced:
            forced.append(True)
            out = out.clone()
            out[1 + trp._SCAN_OUT + 17] = 0.0
        return carry, out

    monkeypatch.setattr(trp, "_frame_branch", failing)
    slot0 = int(port._carry.depth_slot)
    tsyn.feed_lvi(port, parity_data, CARRY_T, CARRY_T + 0.6)  # > one batch
    port.run()
    assert forced and not port._replay_active and port._carry is None
    assert not port._vio_initialized and port.lio_odoms == []
    assert port.depth_slot >= slot0 and port._vio_frame_count > 0
    assert port.vins_odom is not None
    staged = port.replay_counts["staged"]
    assert staged == port.replay_counts["returned"]
    monkeypatch.setattr(trp, "_frame_branch", branch)
    frames0 = port.vio_frames
    t = _next(parity_data, "imgs", port.last_image_time)
    port._on_image(t, dict(image=dict(parity_data["imgs"])[t]))
    # the frame ran in the handler (interactive), it was not staged
    assert port.vio_frames == frames0 + 1 and port.replay_counts["staged"] == staged
    assert port._vio_initialized  # the estimator is up: the replay can resume
    assert port._maybe_activate_replay() and port._carry is not None


def test_pipeline_devices_beside_replay_batch(parity_data):
    """`pipeline_devices` with `replay_batch` > 1 runs the pipelined path:
    with the VIO up, a frame goes to stage T and nothing is staged."""
    from lvislam_tpu_torch.models.pipeline import LviSystem

    cfg = dataclasses.replace(convert.lvi_config_from_jax(jax_replay_system(BATCH).cfg),
                              pipeline_devices=("cpu",) * 3)
    assert cfg.replay_batch == BATCH
    sys_ = LviSystem(cfg)
    sys_._vio_initialized = True
    sys_.vins_odom = dict(stamp=0.0, trans=np.zeros(3, np.float32),
                          quat=np.array([1, 0, 0, 0], np.float32), vel=np.zeros(3, np.float32),
                          ba=np.zeros(3, np.float32), bg=np.zeros(3, np.float32), reset_id=0)
    assert not sys_._maybe_activate_replay()
    t, img = parity_data["imgs"][0]
    sys_.feed_image(t, img)
    sys_.bus.run()
    assert sys_._pending_track["stamp"] == t
    assert not sys_._replay_active and not sys_._ev_rows and sys_._carry is None
