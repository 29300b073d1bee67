"""The port's sliding-window VIO estimator and `VioRunner` against the JAX
package on the CPU, on a short rendered sequence (320x240, 64 features,
window 6, 96 slots, 32 IMU samples a frame, 3 BA iterations: the sizes of
tests/test_vio_runner.py) on the figure-8 with real accelerometer excitation
(scale 1.5, period 12), so the visual bootstrap (path B) fires, on the
first full window.

The JAX tracker and estimator run the whole stream once; every frame's inputs
and the JAX state before and after it are kept. The port then takes (a) one
step from each carried JAX state, with JAX's RANSAC draws, and (b) the whole
sequence on its own state from `vio_init`.

Tolerances, one step from a shared state: integer tables, masks and flags
exact. Before initialization the window states are IMU propagation only
(1e-5). A steady frame is one BA from a good start: positions and
velocities 1e-4, quaternions 1e-5 (measured 7e-7, 3e-6, 4e-7), inverse depths
1e-3 with at most 2 of 96 slots beyond (measured: one low-parallax feature
off by 7% on 2 of 11 frames). The bootstrap frame (SfM, alignment, then a
first BA of 3 iterations from that rough start, which leaves most inverse
depths negative in JAX too) and the seeded one amplify the initializer's
1e-4 (tests/test_torch_initializer.py): positions 5e-3 m (measured 1.6e-3),
velocities 2e-2 m/s, quaternions 2e-3; of the inverse depths only how many
came out positive. The free-running sequence feeds the differences back
frame after frame; its bound is measured (stated at the test)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from lvislam_tpu.core.config import CameraIntrinsics as JCam
from lvislam_tpu.models.vio import estimator as jest, feature_manager as jfm, feature_tracker as jft
from lvislam_tpu.ops import ba as jba, ransac as jr
from lvislam_tpu.utils import synthetic as jsyn
from lvislam_tpu_torch.core import hostsync
from lvislam_tpu_torch.ops import handeye
from lvislam_tpu_torch.models.vio import estimator as test_, feature_manager as tfm
from lvislam_tpu_torch.models.vio import feature_tracker as tft
from lvislam_tpu_torch.models.vio.pipeline import VioRunner, VioRunnerConfig
from lvislam_tpu_torch.utils import convert
from lvislam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

W, FCAP, M, NF = 6, 96, 32, 64
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
QIC = tuple(np.roll(Rsc.from_matrix(R_BC).as_quat(), 1).tolist())
CAM = JCam(model_type="PINHOLE", gamma1=200.0, gamma2=200.0, u0=160.0, v0=120.0,
           k1=0.0, k2=0.0, p1=0.0, p2=0.0, image_width=320, image_height=240)
TRACKER = jft.TrackerParams(max_cnt=NF, min_dist=16, klt_levels=2, klt_half=7, klt_iters=15,
                            equalize=False)
CAPS = jfm.VioCaps(window=W, max_features=FCAP, imu_buf=M, frame_features=NF)
PARAMS = jest.VioParams(g_norm=jsyn.GRAVITY)
BACFG = jba.BAConfig(window=W, max_features=FCAP, iterations=3, estimate_td=False,
                     estimate_extrinsic=False)
T_CAPS, T_PARAMS, T_BACFG = (convert.vio_caps_from_jax(CAPS), convert.vio_params_from_jax(PARAMS),
                             convert.ba_config_from_jax(BACFG))
DURATION = 1.9


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def jax_sampler(weights, n_hyp, k):
    w = jnp.asarray(weights.numpy())
    idx = jr._sample_indices(jax.random.PRNGKey(0), n_hyp, k, w.shape[0], w)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


def _no_seed(mod):
    z = jnp.zeros if mod is jnp else torch.zeros
    q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (W + 1, 1))
    return dict(available=mod.asarray(False) if mod is jnp else False,
                Ps=z((W + 1, 3)), Qs=mod.asarray(q) if mod is jnp else _t(q),
                Vs=z((W + 1, 3)), ba=z(3), bg=z(3))


def _jax_init(params=PARAMS, qic=QIC):
    s = jest.vio_init(CAPS, params)
    return s._replace(ws=s.ws._replace(qic=jnp.asarray(qic, jnp.float32)))


@pytest.fixture(scope="module")
def stream():
    """The rendered stream, the JAX tracker's output per frame and the IMU
    window per frame, as `VioRunner.feed_image` forms them."""
    traj = tsyn.figure8_trajectory(scale=1.5, period=12.0)
    events, gyro, acc, frames = tsyn.vio_stream(DURATION, world_seed=0, scale=1.5, period=12.0)
    tracker = jft.tracker_init(240, 320, TRACKER)
    imu_t = np.array([t for t, kind, _ in events if kind == "imu"])
    steps, last = [], -1.0
    for t, kind, i in events:
        if kind != "img":
            continue
        tracker, tout = jft.tracker_step(tracker, jnp.asarray(frames[i]), jnp.float32(t), TRACKER, CAM)
        imu = None
        if last > 0:
            sel = np.nonzero((imu_t > last) & (imu_t <= t))[0][:M]
            n = len(sel)
            dts, accs, gyrs = np.zeros(M, np.float32), np.zeros((M, 3), np.float32), np.zeros((M, 3), np.float32)
            dts[:n] = np.diff(imu_t[sel], prepend=last)
            accs[:n], gyrs[:n] = acc[sel], gyro[sel]
            accs[n:], gyrs[n:] = accs[n - 1], gyrs[n - 1]
            imu = (dts, accs, gyrs)
        last = t
        steps.append(dict(t=t, imu=imu, ids=np.asarray(tout.ids), norm=np.asarray(tout.norm),
                          vel=np.asarray(tout.vel), valid=np.asarray(tout.valid)))
    return dict(steps=steps, events=events, gyro=gyro, acc=acc, frames=frames, traj=traj)


def _jax_step(state, st, params=PARAMS, seed_dict=None):
    if st["imu"] is not None:
        state = jest.process_imu(state, *map(jnp.asarray, st["imu"]), CAPS, params)
    return jest.process_image(state, jnp.asarray(st["ids"]), jnp.asarray(st["norm"]),
                              jnp.asarray(st["vel"]), jnp.full(NF, -1.0), jnp.asarray(st["valid"]),
                              seed_dict or _no_seed(jnp), CAPS, params, BACFG)


def _torch_step(state, st, params=T_PARAMS, seed_dict=None, frame_count=None):
    """One frame through the port; `frame_count` defaults to the carried
    state's own (a caller that runs free passes its host copy)."""
    if frame_count is None:
        frame_count = int(state.frame_count)
    if st["imu"] is not None:
        state = test_.process_imu(state, *map(_t, st["imu"]), T_CAPS, params, frame_count=frame_count)
    return test_.process_image(state, _t(st["ids"]), _t(st["norm"]), _t(st["vel"]),
                               torch.full((NF,), -1.0), _t(st["valid"]), seed_dict or _no_seed(torch),
                               T_CAPS, params, T_BACFG, frame_count=frame_count, sampler=jax_sampler)


@pytest.fixture(scope="module")
def jax_run(stream):
    """JAX over the whole stream: (state before, state after, outputs) per frame."""
    state, run = _jax_init(), []
    for st in stream["steps"]:
        before = state
        state, out = _jax_step(state, st)
        run.append((before, state, out))
    return run


EXACT = ("frame_count", "frame_valid", "initialized", "failed", "failure_count", "last_marg_old",
         "last_P_ok", "ex_valid", "ex_count", "ric_ok")


TOL = {
    "propagated": dict.fromkeys(("Ps", "Qs", "Vs", "Bas", "Bgs", "tic", "qic", "td"), 1e-5),
    "steady": dict(Ps=1e-4, Qs=1e-5, Vs=1e-4, Bas=1e-4, Bgs=1e-5, tic=1e-6, qic=1e-6, td=1e-6),
    "bootstrap": dict(Ps=5e-3, Qs=2e-3, Vs=2e-2, Bas=2e-2, Bgs=2e-3, tic=1e-6, qic=1e-6, td=1e-6),
}


def _assert_states_close(sj, st, mode: str, where):
    for name in EXACT:
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                      err_msg=f"{where} {name}")
    for name in ("ids", "start_frame", "obs_valid", "lidar_flag"):
        np.testing.assert_array_equal(getattr(st.table, name).numpy(), np.asarray(getattr(sj.table, name)),
                                      err_msg=f"{where} table.{name}")
    np.testing.assert_allclose(st.table.obs.numpy(), np.asarray(sj.table.obs), atol=1e-6)
    for name, atol in TOL[mode].items():
        np.testing.assert_allclose(getattr(st.ws, name).numpy(), np.asarray(getattr(sj.ws, name)),
                                   atol=atol, rtol=0, err_msg=f"{where} ws.{name}")
    ij, it = np.asarray(sj.table.inv_depth), st.table.inv_depth.numpy()
    if mode == "propagated":
        np.testing.assert_allclose(it, ij, atol=1e-6, rtol=0, err_msg=f"{where} inv_depth")
    elif mode == "steady":
        # (a slot without a depth has no residual: its step is rounding noise
        # in both, and it stays without one)
        np.testing.assert_array_equal(it > 0, ij > 0, err_msg=f"{where} inv_depth > 0")
        assert int((np.abs(it - ij)[ij > 0] > 1e-3).sum()) <= 2, where
    else:
        assert abs(int((ij > 0).sum()) - int((it > 0).sum())) <= 0.1 * FCAP, where
    # (the bootstrap repropagates with its own gyro bias estimate)
    p_tol = 2e-4 if mode == "bootstrap" else 1e-5
    np.testing.assert_allclose(st.pints.delta_q.numpy(), np.asarray(sj.pints.delta_q), atol=p_tol,
                               err_msg=f"{where} pints")
    np.testing.assert_allclose(st.pints.delta_p.numpy(), np.asarray(sj.pints.delta_p), atol=p_tol)
    if mode != "propagated":
        Jj, Jt = np.asarray(sj.prior.J, np.float64), st.prior.J.numpy().astype(np.float64)
        Hj = Jj.T @ Jj
        # the prior is linearized at the solved state: its information moves
        # with the states' difference (an all but empty prior: absolute)
        tol = {"steady": 1e-3, "bootstrap": 5e-2}[mode]
        np.testing.assert_allclose(Jt.T @ Jt, Hj, atol=tol * max(np.abs(Hj).max(), 1.0), rtol=0,
                                   err_msg=f"{where} prior")


def test_vio_init_matches_jax():
    sj = _jax_init()
    st = test_.vio_init(T_CAPS, T_PARAMS, device="cpu")
    st = st._replace(ws=st.ws._replace(qic=torch.tensor(QIC)))
    flat_j = convert.to_numpy(convert.vio_state_from_jax(sj, "cpu"))
    flat_t = convert.to_numpy(st)
    assert flat_j.keys() == flat_t.keys()
    for k in flat_t:
        assert flat_t[k].dtype == flat_j[k].dtype and flat_t[k].shape == flat_j[k].shape, k
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)


def test_jax_run_initializes_visually(jax_run):
    init = [bool(o["initialized"]) for _, _, o in jax_run]
    assert not init[W - 1] and init[W] and init[-1], init
    assert int(jax_run[-1][1].failure_count) == 0


@pytest.mark.parametrize("phase", ["filling", "bootstrap", "steady"])
def test_one_step_from_each_carried_jax_state(stream, jax_run, phase):
    init = [bool(o["initialized"]) for _, _, o in jax_run]
    k0 = init.index(True)  # the bootstrap frame
    frames = {"filling": range(0, k0), "bootstrap": [k0],
              "steady": range(k0 + 1, len(jax_run))}[phase]
    assert len(frames) > 0
    n_old = 0
    for k in frames:
        before, after, out_j = jax_run[k]
        state = convert.vio_state_from_jax(before, "cpu")
        fc = int(before.frame_count)
        state, out_t = _torch_step(state, stream["steps"][k], frame_count=fc)
        _assert_states_close(after, state, "propagated" if k < k0 else phase, where=f"frame {k}")
        assert out_t["frame_count"] == int(after.frame_count)
        assert bool(out_t["is_keyframe"]) == bool(out_j["is_keyframe"])
        np.testing.assert_allclose(out_t["pos"].numpy(), np.asarray(out_j["pos"]), atol=5e-3)
        assert (1 <= out_t["ba_iterations"] <= 3) if k >= k0 else out_t["ba_iterations"] == 0
        n_old += k >= k0 and bool(out_j["is_keyframe"])
    # MARGIN_OLD ran on the solved frames; MARGIN_SECOND_NEW is driven below
    assert n_old > 0 or phase == "filling"


def test_margin_second_new_step_from_a_carried_state(stream, jax_run):
    """With no parallax between the two newest window frames (their
    observations made equal in the carried state) both take the
    MARGIN_SECOND_NEW branch: prior-only marginalization, the two trailing
    preintegrations merged."""
    before = jax_run[-1][1]
    tb = before.table
    before = before._replace(table=tb._replace(
        obs=tb.obs.at[:, W - 1].set(tb.obs[:, W - 2]),
        obs_valid=tb.obs_valid.at[:, W - 1].set(tb.obs_valid[:, W - 2])))
    # the incoming frame re-observes the table's live features (20 long
    # tracks or more are needed for the parallax test to count)
    ids = np.asarray(tb.ids)
    slots = np.nonzero(ids >= 0)[0][:NF]
    pad = NF - len(slots)
    assert len(slots) >= 20
    st = dict(stream["steps"][-1], ids=np.r_[ids[slots], np.full(pad, -1, np.int32)].astype(np.int32),
              norm=np.r_[np.asarray(tb.obs)[slots, W - 2], np.zeros((pad, 2), np.float32)],
              vel=np.zeros((NF, 2), np.float32), valid=np.r_[np.ones(len(slots), bool), np.zeros(pad, bool)])
    after, out_j = _jax_step(before, st)
    state, out_t = _torch_step(convert.vio_state_from_jax(before, "cpu"), st)
    assert not bool(out_j["is_keyframe"]) and not bool(out_t["is_keyframe"])
    _assert_states_close(after, state, "bootstrap", where="second_new")
    sdt = np.asarray(after.pints.sum_dt)
    np.testing.assert_allclose(state.pints.sum_dt.numpy(), sdt, atol=1e-6)
    assert sdt[W - 2] > 1.5 * sdt[0]  # two intervals in one


def test_full_window_without_parallax_stays_uninitialized(stream, jax_run):
    """A full window whose frames all repeat one observation has no
    reference frame for the SfM: both stay uninitialized and slide, and the
    port does not run the bootstrap at all (it reads the parallax flag
    first, where JAX computes the SfM and discards it)."""
    before = jax_run[W][0]
    assert int(before.frame_count) == W and not bool(before.initialized)
    tb = before.table
    flat = before._replace(table=tb._replace(obs=jnp.broadcast_to(tb.obs[:, :1], tb.obs.shape)))
    st = dict(stream["steps"][W], norm=np.zeros((NF, 2), np.float32))
    after, out_j = _jax_step(flat, st)
    hostsync.reset()
    state, out_t = _torch_step(convert.vio_state_from_jax(flat, "cpu"), st, frame_count=W)
    # initialized (twice: before and after the attempt) and the parallax flag
    assert hostsync.COUNT == 3
    assert not bool(out_j["initialized"]) and not bool(out_t["initialized"])
    _assert_states_close(after, state, "propagated", where="no parallax")


def test_seeded_initialization_path_a(stream, jax_run):
    """A full, uninitialized window with lidar odometry available: states
    seeded, preintegrations repropagated with the seeded biases."""
    k = W  # first frame with a full window
    before = jax_run[k][0]
    assert int(before.frame_count) == W and not bool(before.initialized)
    traj = stream["traj"]
    ts = [stream["steps"][i]["t"] for i in range(k - W, k + 1)]
    P, R = traj.pose(np.array(ts))
    V = (traj.pose(np.array(ts) + 1e-4)[0] - traj.pose(np.array(ts) - 1e-4)[0]) / 2e-4
    seed = dict(Ps=(P - P[0]).astype(np.float32),
                Qs=np.roll(Rsc.from_matrix(R).as_quat(), 1, axis=-1).astype(np.float32),
                Vs=V.astype(np.float32), ba=np.array([0.01, 0.0, -0.01], np.float32),
                bg=np.array([0.001, 0.002, 0.0], np.float32))
    after, out_j = _jax_step(before, stream["steps"][k],
                             seed_dict=dict(available=jnp.asarray(True), **{a: jnp.asarray(b) for a, b in seed.items()}))
    state, out_t = _torch_step(convert.vio_state_from_jax(before, "cpu"), stream["steps"][k],
                               seed_dict=dict(available=torch.tensor(True), **{a: _t(b) for a, b in seed.items()}))
    assert bool(out_j["initialized"]) and bool(out_t["initialized"])
    _assert_states_close(after, state, "bootstrap", where="path A")
    np.testing.assert_allclose(state.pints.linearized_bg.numpy(), np.asarray(after.pints.linearized_bg), atol=0)
    np.testing.assert_allclose(state.pints.jacobian.numpy(), np.asarray(after.pints.jacobian), atol=1e-5)


def test_forced_failure_reboots_like_jax(stream, jax_run):
    before = jax_run[-1][1]
    assert bool(before.initialized)
    # the previous frame's pose 10 m away: the jump check fires after the solve
    bad = before._replace(last_P=before.ws.Ps[W] + jnp.array([10.0, 0, 0]), last_P_ok=jnp.array(True))
    after, out_j = _jax_step(bad, stream["steps"][-1])
    hostsync.reset()
    state, out_t = _torch_step(convert.vio_state_from_jax(bad, "cpu"), stream["steps"][-1])
    assert bool(out_j["failed"]) and bool(out_t["failed"]) and out_t["frame_count"] == 0
    assert int(state.failure_count) == int(after.failure_count) == 1
    flat_j, flat_t = convert.to_numpy(convert.vio_state_from_jax(after, "cpu")), convert.to_numpy(state)
    for key in flat_t:  # a fresh state, the calibration kept
        np.testing.assert_array_equal(flat_t[key], flat_j[key], err_msg=key)
    np.testing.assert_array_equal(state.ws.qic.numpy(), np.asarray(bad.ws.qic))


def test_hand_eye_bootstrap_matches_jax(stream):
    """ESTIMATE_EXTRINSIC=2 from an identity extrinsic rotation: the pair
    ring fills alike and initialization stays blocked; the solve agrees up to
    sign on JAX's ring."""
    pj = dataclasses.replace(PARAMS, estimate_extrinsic_rotation=True, ex_min_pairs=4)
    pt = convert.vio_params_from_jax(pj)
    state_j = _jax_init(pj, qic=(1.0, 0.0, 0.0, 0.0))
    assert not bool(state_j.ric_ok)
    agreed = 0
    for k, st in enumerate(stream["steps"][:9]):
        state_t, prev_q = convert.vio_state_from_jax(state_j, "cpu"), state_j.ex_q
        state_j, _ = _jax_step(state_j, st, params=pj)
        state_t, _ = _torch_step(state_t, st, params=pt)
        for name in ("ric_ok", "initialized", "frame_count"):
            np.testing.assert_array_equal(getattr(state_t, name).numpy(), np.asarray(getattr(state_j, name)),
                                          err_msg=f"frame {k} {name}")
        # a pair is pushed when the epipolar solve passes its inlier and
        # cheirality counts: a borderline solve may pass in one only
        if int(state_t.ex_count) != int(state_j.ex_count):
            continue
        agreed += 1
        np.testing.assert_array_equal(state_t.ex_valid.numpy(), np.asarray(state_j.ex_valid))
        # the preintegrated rotation to rounding; the epipolar one is a noisy
        # 8-point solve (128 hypotheses) on 0.1 s of parallax, loose by
        # nature: 2e-2 (measured up to 9e-3)
        for name, atol in (("ex_qimu", 1e-5), ("ex_qcam", 2e-2)):
            a, b = np.asarray(getattr(state_j, name)), getattr(state_t, name).numpy()
            sign = np.sign(np.sum(a * b, axis=1, keepdims=True))
            np.testing.assert_allclose(sign * b, a, atol=atol, err_msg=f"frame {k} {name}")
        # with this little rotation the null vector swings with the epipolar
        # noise, so the running estimate is held to JAX's on JAX's own ring
        res = handeye.calibrate_rotation(_t(state_j.ex_qcam), _t(state_j.ex_qimu), _t(state_j.ex_valid),
                                         _t(prev_q), min_pairs=pt.ex_min_pairs)
        if int(state_j.ex_count) >= 3:
            assert abs(np.dot(np.asarray(state_j.ex_q), res.q_ic.numpy())) > 1 - 1e-4, k
    assert agreed >= 7 and int(state_j.ex_count) >= 4 and not bool(state_t.initialized)


def test_free_running_sequence_tracks_jax(stream, jax_run):
    """The port on its own state over the whole stream, host frame count
    mirrored as the runner does. Same bootstrap frame, no failure; the newest
    pose stays within 3 cm of JAX's on every frame (measured 8 mm at most:
    the one-step differences fed back over 12 solved frames) and within the
    estimator's own accuracy of the truth."""
    state = test_.vio_init(T_CAPS, T_PARAMS, device="cpu")
    state = state._replace(ws=state.ws._replace(qic=torch.tensor(QIC)))
    fc, pos_t, pos_j, syncs = 0, [], [], []
    for st, (_, after, out_j) in zip(stream["steps"], jax_run):
        hostsync.reset()
        state, out = _torch_step(state, st, frame_count=fc)
        syncs.append(hostsync.COUNT)
        fc = out["frame_count"]
        assert bool(out["initialized"]) == bool(out_j["initialized"])
        if bool(out["initialized"]):
            pos_t.append(out["pos"].numpy())
            pos_j.append(np.asarray(out_j["pos"]))
    assert int(state.failure_count) == 0 and fc == W == int(state.frame_count)
    assert len(pos_t) >= 10
    np.testing.assert_allclose(np.stack(pos_t), np.stack(pos_j), atol=3e-2, rtol=0)
    # steady state: initialized, marg_old, failed + at most iterations-1 LM flags
    assert max(syncs[-5:]) <= 3 + BACFG.iterations - 1, syncs


def test_vio_runner_smoke(stream):
    """tests/test_vio_runner.py through the port's runner on the CPU, with
    the FREQ throttle (every frame fed twice, the repeat 20 ms later) and the
    stream-gap restart."""
    cfg = VioRunnerConfig(
        camera=convert.camera_from_jax(CAM), tracker=convert.tracker_params_from_jax(TRACKER),
        caps=T_CAPS, params=T_PARAMS, ba=T_BACFG, image_height=240, image_width=320, freq=10.0,
        qic=QIC)
    runner = VioRunner(cfg, device="cpu")
    outs, throttled = [], 0
    for t, kind, i in stream["events"]:
        if t > 1.65:
            break
        if kind == "imu":
            runner.feed_imu(t, stream["gyro"][i], stream["acc"][i])
        else:
            outs.append(runner.feed_image(t, stream["frames"][i]))
            throttled += runner.feed_image(t + 0.02, stream["frames"][i]) is None
    assert sum(o is not None for o in outs) >= 10 and throttled == len(outs)
    assert runner.frame_count == int(runner.vio.frame_count) >= W
    assert int((runner.vio.table.ids >= 0).sum()) > 20
    assert all(isinstance(o["ba_iterations"], int) for o in outs)
    # a gap of more than max_stream_gap restarts both and counts as a reset
    out = runner.feed_image(t + 5.0, stream["frames"][0])
    assert out is not None and runner.frame_count == 1
    assert int(runner.vio.failure_count) == 1 and not bool(runner.vio.initialized)


def _as_jax(cls, x):
    """The JAX package's dataclass `cls` with the port object's values."""
    return cls(**{f.name: getattr(x, f.name) for f in dataclasses.fields(x)})


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("full", [False, True], ids=["fixture", "full_width"])
def test_jax_vio_runner_anchors(full, seed):
    """Recompute chip_smoke.py's JAX reference values for its VIO phases:
    the JAX `VioRunner` on the CPU over exactly the stream and configuration
    of `chip_smoke.vio_inputs` / `vio_config` (the fixture's size in one to
    three minutes a seed; the full width, 752x480 with 256 slots, in several).
    Seed 0 is the JAX package as it stands; seed s > 0 folds s into the key
    of every RANSAC draw (`ransac._sample_indices`), which shows how far the
    bootstrap on this 5 s stream hangs on the draws."""
    import os
    import sys

    from lvislam_tpu.models.vio.pipeline import VioRunner as JRunner, VioRunnerConfig as JConfig
    from lvislam_tpu_torch.utils import anchors

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke

    cfg = chip_smoke.vio_config(full)
    traj, events, gyro, acc, frames = chip_smoke.vio_inputs(full)
    draw = jr._sample_indices
    try:
        if seed:
            jr._sample_indices = lambda key, *a: draw(jax.random.fold_in(key, seed), *a)
        jax.clear_caches()  # the jitted callers hold the draws they were traced with
        runner = JRunner(JConfig(
            camera=_as_jax(JCam, cfg.camera), tracker=_as_jax(jft.TrackerParams, cfg.tracker),
            caps=_as_jax(jfm.VioCaps, cfg.caps), params=_as_jax(jest.VioParams, cfg.params),
            ba=_as_jax(jba.BAConfig, cfg.ba), image_height=cfg.image_height,
            image_width=cfg.image_width, freq=cfg.freq, tic=cfg.tic, qic=cfg.qic))
        init_at = None
        for t, kind, i in events:
            if kind == "imu":
                runner.feed_imu(t, gyro[i], acc[i])
                continue
            runner.feed_image(t, frames[i])
            if init_at is None and runner.trajectory:
                init_at = i
    finally:
        jr._sample_indices = draw
        jax.clear_caches()
    live = bool(runner.vio.initialized) and len(runner.trajectory) >= 3
    ate = chip_smoke.vio_summary(runner.trajectory, traj)[0] if live else None
    failures, fc = int(runner.vio.failure_count), int(runner.vio.frame_count)
    got = {"status": chip_smoke.vio_status(live, failures, fc, ate),
           "initialized_at_frame": init_at, "trajectory_points": len(runner.trajectory),
           "failure_count": failures, "ate_m": ate}
    print(seed, got)
    assert got == (anchors.VIO_FULL_WIDTH if full else anchors.VIO_FIXTURE)[seed]
