"""The fused LVI system (``lvislam_tpu_torch.models.pipeline.LviSystem``)
against the JAX package's: the parity sequence generator, a short feed from
one carried state, the host-side glue, and (slow) the JAX interactive path's
own reference values over the 12 s parity sequence."""

import copy
import os
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
from lvislam_tpu.ops import ransac as jr  # noqa: E402
from lvislam_tpu_torch.models.vio import frame_step as tfs  # noqa: E402
from lvislam_tpu_torch.utils import anchors, convert  # noqa: E402
from lvislam_tpu_torch.utils import synthetic as tsyn  # noqa: E402

torch.set_num_threads(1)


def jax_lvi_sequence(duration=12.0, horizon=900):
    """`bench.py:_lvi_seq_data`'s build, on the JAX package's synthetic
    module (without the bench's on-disk cache)."""
    from scipy.spatial.transform import Rotation as Rsc

    from lvislam_tpu.utils import synthetic as syn

    world = syn.default_world(seed=0)
    traj = syn.figure8_trajectory(scale=3.0, period=30.0)
    d = duration
    imu_ts = (np.arange(int(d * 200)) + 1) / 200
    w_all, f_all = traj.imu(imu_ts)
    rpys = np.stack([
        Rsc.from_matrix(traj.pose(np.array([t]))[1][0]).as_euler("ZYX")[::-1]
        for t in imu_ts]).astype(np.float32)
    scans = [(0.05 + i / 10, syn.simulate_lidar_scan(
        world, traj, 0.05 + i / 10, n_scan=4, horizon=horizon, sweep_time=0.1))
        for i in range(int(d * 10) - 1)]
    imgs = [(0.1 + i / 10, tsyn._u8(syn.render_camera_image(
        world, traj, 0.1 + i / 10, width=320, height=240, f=200.0)))
        for i in range(int(d * 10) - 1)]
    return dict(imu_ts=imu_ts, w=w_all, f=f_all, rpys=rpys, scans=scans, imgs=imgs)


def jax_parity_system():
    """`tests/test_lvi_system.py:make_system` with `bench.py:apply_perf_knobs`
    on the CPU (pallas=False), interactive path (replay_batch=1)."""
    from bench import apply_perf_knobs
    from test_lvi_system import make_system

    s = make_system(pallas=False)
    apply_perf_knobs(s, pallas=False)
    s.cfg.replay_batch = 1
    return s


def watch_init(sys_):
    """Record, a frame, whether the lidar seed was available and whether the
    VIO came out initialized. Returns the list it fills: (vio_frames,
    seeded, initialized) a processed frame."""
    rec, seeded = [], [False]
    orig = sys_._lidar_seed

    def seed(stamp):
        s = orig(stamp)
        seeded[0] = s is not None
        return s

    sys_._lidar_seed = seed
    sys_.bus.subscribe("image", lambda t, m: rec.append(
        (sys_.vio_frames, seeded[0], bool(sys_._vio_initialized))))
    return rec


def init_frame(rec):
    """(frame number, "lidar_seed" | "visual") of the first initialized frame."""
    for n, seeded, ok in rec:
        if ok:
            return n, ("lidar_seed" if seeded else "visual")
    return None, None



def jax_sampler(weights, n_hyp, k):
    """JAX's draws (every RANSAC caller of the fused path uses PRNGKey(0))."""
    w = jnp.asarray(weights.numpy())
    idx = jr._sample_indices(jax.random.PRNGKey(0), n_hyp, k, w.shape[0], w)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


CARRY_T, STEADY_T, END_T = 1.05, 1.45, 1.65


@pytest.fixture(scope="module")
def parity_data():
    return tsyn.lvi_sequence(duration=END_T + 0.05)


@pytest.fixture(scope="module")
def jax_run(parity_data):
    """The JAX parity system fed to CARRY_T (10 frames: the frame after is
    the VIO's lidar-seeded initialization), then to STEADY_T, then to END_T;
    deep copies of its state at the first two points."""
    s = jax_parity_system()
    tsyn.feed_lvi(s, parity_data, 0.0, CARRY_T)
    s.run()
    at_carry = copy.deepcopy(s)
    tsyn.feed_lvi(s, parity_data, CARRY_T, STEADY_T)
    s.run()
    at_steady = copy.deepcopy(s)
    tsyn.feed_lvi(s, parity_data, STEADY_T, END_T)
    s.run()
    return at_carry, at_steady, s


def test_parity_sequence_is_the_anchor_stream():
    """The port's generator makes the JAX-side build's 12 s sequence bit for
    bit: its sha256 is the one the slow anchor test computed from
    `bench.py:_lvi_seq_data`'s build on the JAX package's synthetic module."""
    assert tsyn.lvi_sequence_sha256(tsyn.lvi_sequence()) == anchors.LVI_PARITY["stream_sha256"]


def test_parity_config_is_the_anchor_config():
    """`chip_smoke.lvi_parity_config` (kernels off) is the configuration the
    JAX anchor ran, and the converted JAX configuration hashes alike."""
    import chip_smoke

    assert anchors.config_sha256(chip_smoke.lvi_parity_config(kernels=False)) == \
        anchors.LVI_PARITY["config_sha256"]
    jcfg = jax_parity_system().cfg
    assert anchors.config_sha256(convert.lvi_config_from_jax(jcfg)) == anchors.config_sha256(jcfg)


@pytest.mark.parametrize("with_seed", [False, True])
def test_pack_frame_byte_identical(with_seed):
    from lvislam_tpu.models.vio import feature_manager as jfm

    rng = np.random.default_rng(4)
    caps = jfm.VioCaps(window=4, max_features=32, imu_buf=8, frame_features=16)
    img = rng.random((24, 32)).astype(np.float32)
    n = 5
    dts = rng.random(8).astype(np.float32)
    accs, gyrs = rng.normal(size=(8, 3)).astype(np.float32), rng.normal(size=(8, 3)).astype(np.float32)
    fresh = rng.random(6) > 0.5
    seed = None
    if with_seed:
        seed = dict(Ps=rng.normal(size=(5, 3)), Qs=rng.normal(size=(5, 4)),
                    Vs=rng.normal(size=(5, 3)), ba=rng.normal(size=3), bg=rng.normal(size=3))
    args = [img, 1.25, dts, accs, gyrs, n, fresh]
    body = ([np.array([1.0, 2.0, 3.0]), np.array([0.9, 0.1, 0.2, 0.3])] if with_seed
            else [None, None])
    a = jfs.pack_frame(caps, *args, *body, seed)
    b = tfs.pack_frame(convert.vio_caps_from_jax(caps), *args, *body, seed)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    u8 = (img * 255).astype(np.uint8)
    assert jfs.pack_frame(caps, u8, *args[1:], *body, seed).tobytes() == \
        tfs.pack_frame(convert.vio_caps_from_jax(caps), u8, *args[1:], *body, seed).tobytes()


def _frame_inputs(jsys, data, t):
    """`_on_image`'s packing of the frame at stamp t on a copy of `jsys`:
    (buffer, imu_n, seed available)."""
    s = copy.deepcopy(jsys)
    img = dict(data["imgs"])[t]
    td = 0.0
    dts, accs, gyrs, n = s._imu_window(s.last_image_time + td, t + td,
                                        s.cfg.vio_caps.imu_buf, interp_end=True)
    s.frame_times.append(t)
    seed = s._lidar_seed(t)
    vo = s.vins_odom
    buf = jfs.pack_frame(s.cfg.vio_caps, img, t, dts, accs, gyrs, n,
                         s.depth_stamps > t - 5.0, vo["trans"] if vo else None,
                         vo["quat"] if vo else None, seed)
    return buf, n, seed is not None


@pytest.mark.parametrize("which", ["bootstrap", "steady"])
def test_frame_step_from_carried_state(parity_data, jax_run, which):
    """`frame_step` from the JAX system's carried tracker, VIO state and
    depth ring, JAX's draws injected: the 21-float summary within the
    estimator's bounds (bootstrap frame 5e-3 m / 2e-3, steady 1e-4 m /
    1e-5) and its flags equal. The bootstrap frame takes the lidar seed."""
    jsys = jax_run[0] if which == "bootstrap" else jax_run[1]
    t = min(ts for ts, _ in parity_data["imgs"] if ts > jsys.last_image_time)
    buf, n, seeded = _frame_inputs(jsys, parity_data, t)
    assert seeded == (which == "bootstrap")
    c = jsys.cfg
    statics = (c.tracker, c.camera, c.vio_caps, c.vio_params, c.ba, c.image_height, c.image_width)
    _, _, _, _, sj = jfs.frame_step(jsys.tracker, jsys.vio, jnp.asarray(buf), jsys.depth_clouds,
                                    jsys.depth_valid, *statics, use_depth=True)
    port = convert.lvi_system_from_jax(jsys, device="cpu")
    tc = port.cfg
    _, _, _, _, st, fc = tfs.frame_step(
        port.tracker, port.vio, torch.from_numpy(buf), port.depth_clouds, port.depth_valid,
        tc.tracker, tc.camera, tc.vio_caps, tc.vio_params, tc.ba, tc.image_height,
        tc.image_width, use_depth=True, frame_count=port._vio_frame_count, imu_n=n,
        seed_available=seeded, sampler=jax_sampler)
    sj, st = np.asarray(sj), st.numpy()
    assert bool(sj[17] > 0.5) and bool(st[17] > 0.5)  # initialized
    np.testing.assert_array_equal(st[17:20], sj[17:20])  # initialized, keyframe, failures
    assert st[20] == sj[20]  # tracked features
    pos_tol, q_tol = (5e-3, 2e-3) if which == "bootstrap" else (1e-4, 1e-5)
    np.testing.assert_allclose(st[0:3], sj[0:3], atol=pos_tol)
    np.testing.assert_allclose(st[3:7] * np.sign(st[3]), sj[3:7] * np.sign(sj[3]), atol=q_tol)
    np.testing.assert_allclose(st[7:16], sj[7:16], atol=10 * pos_tol)
    assert fc == int(jsys.vio.frame_count) + (0 if int(jsys.vio.frame_count) >= 10 else 1)


def test_lvi_system_short_feed_from_carried_state(parity_data, jax_run):
    """`lvi_system_from_jax` at 1.05 s, then 0.6 s of the parity sequence
    through both systems (JAX's draws in the port): the same processed scan
    and frame stamps (throttle), the VIO initialized on the same frame by
    the lidar seed, trajectory rows within 25 mm / 2 mrad, `vins_odom`
    within 8 mm, the fused odometry stream's stamps and reset ids equal."""
    at_carry, _, jend = jax_run
    port = convert.lvi_system_from_jax(at_carry, device="cpu", sampler=jax_sampler)
    n0 = len(port.trajectory)
    tsyn.feed_lvi(port, parity_data, CARRY_T, END_T)
    port.run()
    assert [t for t, _ in port.trajectory] == [t for t, _ in jend.trajectory]
    assert port.vio_frames == jend.vio_frames
    assert port._vio_initialized and jend._vio_initialized
    a = np.stack([x for _, x in port.trajectory[n0:]])
    b = np.stack([np.asarray(x) for _, x in jend.trajectory[n0:]])
    assert np.abs(a[:, 3:6] - b[:, 3:6]).max() < 0.025
    assert np.abs(a[:, 0:3] - b[:, 0:3]).max() < 2e-3
    assert port.vins_odom["stamp"] == jend.vins_odom["stamp"]
    assert np.abs(port.vins_odom["trans"] - jend.vins_odom["trans"]).max() < 8e-3
    assert port.vins_odom["reset_id"] == jend.vins_odom["reset_id"]
    assert [o[0] for o in port.lio_odoms] == [o[0] for o in jend.lio_odoms]
    assert [o[6] for o in port.lio_odoms] == [o[6] for o in jend.lio_odoms]
    assert np.abs(np.stack([o[1] for o in port.lio_odoms])
                  - np.stack([o[1] for o in jend.lio_odoms])).max() < 0.025
    assert len(port.imu_rate_odom) == len(jend.imu_rate_odom)
    assert port.depth_slot == jend.depth_slot
    np.testing.assert_array_equal(port.depth_stamps, jend.depth_stamps)


def test_host_glue_equal_given_the_same_buffers(jax_run):
    """`_imu_window`, `_lidar_seed` and `_emit_imu_rate` on the carried host
    buffers give JAX's arrays exactly (host numpy, line for line)."""
    jsys = jax_run[0]
    port = convert.lvi_system_from_jax(jsys, device="cpu")
    for args in ((0.3, 0.52, 32, False, False), (0.5, 0.93, 32, True, False),
                 (0.95, 1.2, 64, True, True), (0.2, 0.4, 8, False, True)):
        for a, b in zip(port._imu_window(*args), jsys._imu_window(*args)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    t = jsys.last_image_time + 0.1
    for sys_ in (port, jsys):
        sys_.frame_times.append(t)
    sp, sj = port._lidar_seed(t), jsys._lidar_seed(t)
    assert sj is not None and sp.keys() == sj.keys()
    for k in sj:
        np.testing.assert_array_equal(sp[k], sj[k], err_msg=k)
    window = jsys._imu_window(jsys.last_lidar_time, jsys.last_lidar_time + 0.1, 64,
                              lidar_frame=True)
    n0p, n0j = len(port.imu_rate_odom), len(jsys.imu_rate_odom)
    port._emit_imu_rate(*window)
    jsys._emit_imu_rate(*window)
    assert len(port.imu_rate_odom) - n0p == len(jsys.imu_rate_odom) - n0j == window[3] > 0
    for rp, rj in zip(port.imu_rate_odom[n0p:], jsys.imu_rate_odom[n0j:]):
        assert rp[0] == rj[0]
        np.testing.assert_array_equal(rp[1], rj[1])
        np.testing.assert_array_equal(rp[2], rj[2])


class _Stop(Exception):
    pass


def _recording(sys_):
    """Replace the LIO step of `sys_` by a recorder that stops the handler:
    the scans that reach the LIO, with their stamp and GPS argument."""
    seen = []

    def process_scan(scan, irt, ig, rpy, odom=None, gps=None):
        seen.append((scan["stamp"], None if gps is None else float(gps["stamp"])))
        raise _Stop

    sys_.lio.process_scan = process_scan
    return seen


def _drive(sys_, events):
    for kind, t, arg in events:
        if kind == "gps":
            sys_.feed_gps(t, np.array([1.0, 2.0, 0.0]), np.array([0.5, 0.5, 0.5]))
        elif kind == "lidar":
            sys_.feed_lidar(t, arg)
            try:
                sys_.run()
            except _Stop:
                pass


def test_lidar_gates_reproduce_jax(parity_data):
    """The mapping throttle, the disorder drop (a repeated or older scan
    stamp), the GPS staleness gate (a fix within 0.2 s of the scan) and
    `test_stampless_scan_gets_bus_time` (a scan without its own stamp is
    stamped with bus time), on a fresh system of each package."""
    from lvislam_tpu_torch.models.pipeline import LviSystem

    jsys = jax_parity_system()
    port = LviSystem(convert.lvi_config_from_jax(jsys.cfg), device="cpu")
    scans = dict(parity_data["scans"])
    sc = scans[min(scans)]
    bare = {k: v for k, v in sc.items() if k != "stamp"}
    events = [("lidar", 0.05, bare), ("lidar", 0.05, sc), ("lidar", 0.15, sc),
              ("gps", 0.10, None), ("lidar", 0.25, sc), ("lidar", 0.20, sc),
              ("lidar", 0.55, sc), ("gps", 0.60, None), ("lidar", 0.85, sc),
              ("lidar", 1.05, sc), ("lidar", 1.0, sc)]
    seen_j, seen_t = _recording(jsys), _recording(port)
    _drive(jsys, events)
    _drive(port, events)
    assert seen_t == seen_j
    assert seen_j == [(0.05, None), (0.25, 0.1), (0.55, None), (0.85, None), (1.05, None)]


def test_duplicate_and_stale_frames_are_dropped(jax_run):
    """The disorder drop of `_on_image`: a frame whose stamp is not after
    the last one never reaches `frame_step` (no state changes)."""
    jsys = jax_run[0]
    port = convert.lvi_system_from_jax(jsys, device="cpu")
    t = port.last_image_time
    for stamp in (t, t - 0.1):
        port.feed_image(stamp, np.zeros((240, 320), np.uint8))
    port.run()
    assert port.vio_frames == jsys.vio_frames and port.last_image_time == t
    assert port.frame_times == jsys.frame_times


def test_loop_detect_points_and_keyframe_insert(jax_run, monkeypatch):
    """`_loop_detect` from the carried steady state: the world points and
    their validity handed to `add_and_detect` equal the JAX package's
    (`replay._loop_points`, the same gather as its `_loop_detect`), and the
    keyframe goes into the database."""
    from lvislam_tpu.models.replay import _loop_points
    from lvislam_tpu.models.vio import feature_tracker as jft
    from lvislam_tpu_torch.models.loop import loop_detector as tld
    from lvislam_tpu_torch.models.vio import feature_tracker as tft

    jsys = jax_run[1]
    tr = jsys.tracker
    valid = (tr.ids >= 0) & (tr.track_cnt > 1)
    jout = jft.TrackerOutput(ids=tr.ids, uv=tr.pts, norm=tr.norm_pts,
                             vel=jnp.zeros_like(tr.pts), valid=valid, n_tracked=jnp.sum(valid))
    pj, vj = _loop_points(jsys.vio, jout)
    port = convert.lvi_system_from_jax(jsys, device="cpu")
    tout = tft.TrackerOutput(*(torch.from_numpy(np.array(np.asarray(x))) for x in jout))
    seen = []
    add = tld.add_and_detect
    monkeypatch.setattr(tld, "add_and_detect",
                        lambda db, img, uv, norm, pts, ok, *a, **kw:
                        seen.append((pts, ok)) or add(db, img, uv, norm, pts, ok, *a, **kw))
    img = torch.as_tensor(dict(tsyn.lvi_sequence(duration=0.3)["imgs"])[0.1] / 255.0,
                          dtype=torch.float32)
    port._loop_detect(1.5, img, tout)
    np.testing.assert_array_equal(seen[0][1].numpy(), np.asarray(vj))
    ok = np.asarray(vj)
    assert ok.sum() > 10
    np.testing.assert_allclose(seen[0][0].numpy()[ok], np.asarray(pj)[ok], atol=1e-5)
    assert int(port.loop_db.count) == int(jsys.loop_db.count) + 1


def test_unported_options_raise(tmp_path):
    """`pipeline_devices`, the JAX system's placement of its stages on three
    devices, is refused: the port runs the fused system on one device.
    `debug_dir` builds (`utils/debugviz.py`)."""
    from lvislam_tpu_torch.models.pipeline import LviConfig, LviSystem

    with pytest.raises(ValueError, match="pipeline_devices"):
        LviSystem(LviConfig(pipeline_devices=("cpu",) * 3, vocab_path=None), device="cpu")
    sys_ = LviSystem(LviConfig(debug_dir=str(tmp_path / "dbg"), vocab_path=None), device="cpu")
    assert sys_.cfg.debug_dir and sys_._dbg_kf_imgs is None


@pytest.mark.parametrize("entry", ["LviSystem", "lvi_config_from_jax", "lvi_system_from_jax"])
def test_pipelined_configuration_refused(entry):
    """A configuration with `pipeline_devices` set is refused with a
    ValueError naming the field at each entry it can arrive through: the
    port's `LviSystem` (before it places anything: no device is given, and
    none is resolved), and the conversions of a pipelined JAX configuration
    and of a pipelined JAX system, its stages on three of the virtual CPU
    devices of `tests/conftest.py`."""
    from lvislam_tpu.models import pipeline as jlvi
    from lvislam_tpu.models.loop import loop_detector as jld
    from lvislam_tpu.models.vio import feature_manager as jfm
    from lvislam_tpu_torch.models.pipeline import LviConfig, LviSystem

    devs = tuple(jax.devices("cpu")[:3])
    assert len(set(devs)) == 3
    small = dict(vio_caps=jfm.VioCaps(window=3, max_features=16, imu_buf=8, frame_features=8),
                 loop_caps=jld.LoopCaps(max_keyframes=4, extra_points=8, vocab_words=16),
                 vocab_path=None)
    with pytest.raises(ValueError, match="pipeline_devices"):
        if entry == "LviSystem":
            LviSystem(LviConfig(pipeline_devices=("cpu",) * 3, vocab_path=None))
        elif entry == "lvi_config_from_jax":
            convert.lvi_config_from_jax(jlvi.LviConfig(pipeline_devices=devs, **small))
        else:
            jsys = jlvi.LviSystem(jlvi.LviConfig(pipeline_devices=devs, **small))
            assert jsys.vio.ws.Ps.devices() == {devs[2]}
            convert.lvi_system_from_jax(jsys, device="cpu")


def test_debug_dir_hooks_from_carried_state(parity_data, jax_run, tmp_path):
    """`LviConfig(debug_dir=...)` from the carried JAX state at 1.05 s, then
    0.6 s of the parity sequence with the overlays every 2 frames: the port
    writes the files JAX writes (names, sizes, headers; at least 99% of the
    bytes equal: the tracks agree to ~1e-4 px, so a cross can move by one
    pixel), and a port run without the hooks gives the same trajectory bit
    for bit (the hooks read back and change nothing)."""
    import dataclasses

    from lvislam_tpu.utils.bus import Bus

    jsys = copy.deepcopy(jax_run[0])
    jsys.cfg.debug_dir, jsys.cfg.debug_every = str(tmp_path / "jax"), 2
    # a deep copy's bus still calls the handlers of the system it was copied
    # from (closures are not copied): subscribe the copy's own, as its
    # constructor does (no event is pending)
    jsys.bus = Bus()
    jsys.bus.subscribe("imu", jsys._on_imu)
    jsys.bus.subscribe("lidar", lambda t, m: jsys._timed("lidar", jsys._on_lidar, t, m))
    jsys.bus.subscribe("image", lambda t, m: jsys._timed("image", jsys._on_image, t, m))
    port = convert.lvi_system_from_jax(jsys, device="cpu", sampler=jax_sampler)
    port.cfg = dataclasses.replace(port.cfg, debug_dir=str(tmp_path / "port"))
    plain = convert.lvi_system_from_jax(jax_run[0], device="cpu", sampler=jax_sampler)
    for s in (jsys, port, plain):
        tsyn.feed_lvi(s, parity_data, CARRY_T, END_T)
        s.run()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) >= 4 and any(n.startswith("depth_") for n in names)
    for name in names:
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert len(a) == len(b) and a[:15] == b[:15], name
        same = np.frombuffer(a, np.uint8) == np.frombuffer(b, np.uint8)
        assert same.mean() >= 0.99, (name, same.mean())
    assert [t for t, _ in port.trajectory] == [t for t, _ in plain.trajectory]
    for (_, x), (_, y) in zip(port.trajectory, plain.trajectory):
        np.testing.assert_array_equal(x, y)



def test_debug_loop_match_image(tmp_path):
    """The loop hook: each keyframe's 8-bit image is kept in the device ring
    at its database slot, and on a found loop the match image is written, byte for
    byte the JAX module's `draw_matches` of the same arrays (the ring's old
    image, the new frame, the old slot's keypoints in pixels, the tracks)."""
    from types import SimpleNamespace

    from lvislam_tpu.utils import debugviz as jdv
    from lvislam_tpu_torch.models.pipeline import LviConfig, LviSystem

    sys_ = LviSystem(LviConfig(debug_dir=str(tmp_path), vocab_path=None), device="cpu")
    rng = np.random.default_rng(3)
    imgs = [torch.from_numpy(rng.random((240, 320)).astype(np.float32)) for _ in range(2)]
    E, N = sys_.cfg.loop_caps.extra_points, 12
    sys_.loop_db = SimpleNamespace(
        kp_norm=torch.from_numpy(rng.normal(0, 0.3, (4, E, 2)).astype(np.float32)),
        kp_valid=torch.from_numpy(rng.random((4, E)) > 0.3))
    tout = SimpleNamespace(uv=torch.from_numpy(rng.uniform(0, 300, (N, 2)).astype(np.float32)))
    for k, found in ((5, False), (6, True)):
        sys_.vio_frames = k
        cand = SimpleNamespace(cur_index=torch.tensor(k - 4), found=torch.tensor(found),
                               old_index=torch.tensor(1))
        sys_._debug_loop(imgs[k - 5], tout, cand, found)
    assert sorted(os.listdir(tmp_path)) == ["loop_match_00006.ppm"]
    cam = sys_.cfg.camera
    old_u8 = np.clip(imgs[0].numpy() * 255.0, 0, 255).astype(np.uint8)
    old_uv = sys_.loop_db.kp_norm[1].numpy() * float(cam.gamma1) + np.array([cam.u0, cam.v0])
    jdv.save_ppm(str(tmp_path / "jax.ppm"), jdv.draw_matches(
        old_u8, imgs[1].numpy(), old_uv, tout.uv.numpy(), sys_.loop_db.kp_valid[1].numpy()[:N]))
    assert (tmp_path / "loop_match_00006.ppm").read_bytes() == (tmp_path / "jax.ppm").read_bytes()

@pytest.mark.slow
def test_jax_interactive_anchor():
    """The JAX `LviSystem`'s interactive path on the CPU over the 12 s parity
    sequence: the values `utils/anchors.LVI_PARITY` stores (prints them)."""
    from lvislam_tpu.utils.metrics import ate_rmse
    from lvislam_tpu.utils import synthetic as syn

    data = jax_lvi_sequence()
    s = jax_parity_system()
    rec = watch_init(s)
    t0 = time.time()
    tsyn.feed_lvi(s, data, 0.0, 2.0)
    s.run()
    tsyn.feed_lvi(s, data, 2.0, 12.0)
    s.run()
    wall = time.time() - t0
    traj = syn.figure8_trajectory(scale=3.0, period=30.0)
    est = np.stack([x6[3:6] for _, x6 in s.trajectory])
    gt = np.stack([traj.pose(np.array([t]))[0][0] for t, _ in s.trajectory])
    frame, path = init_frame(rec)
    got = {
        "ate_m": float(ate_rmse(est, gt, align=True)),
        "init_frame": frame, "init_path": path,
        "trajectory_points": len(s.trajectory),
        "vio_frames": s.vio_frames,
        "failure_count": int(np.asarray(s.vio.failure_count)),
        "keyframes": int(np.asarray(s.lio.state.kf_count)),
        "config_sha256": anchors.config_sha256(s.cfg),
        "stream_sha256": tsyn.lvi_sequence_sha256(data),
        "wall_s": round(wall, 1),
    }
    print("LVI_PARITY =", got)
    ref = anchors.LVI_PARITY
    for key, v in got.items():
        if key == "wall_s":
            continue
        if isinstance(v, float):
            assert v == pytest.approx(ref[key], rel=1e-9), key
        else:
            assert v == ref[key], key
