"""The port's IMU-rate fusion smoother against the JAX package on the CPU.

`fusion_correct` is one QR Gauss-Newton on a 36x30 Jacobian whose rows span
weights from 1 (degenerate lidar) to 1e4 (whitened IMU). QR is unique only up
to the sign of each row of R, so the carried prior is compared as
`sqrt_infoᵀ sqrt_info`, within 2e-4 of its largest entry (measured <= 6e-5:
f32 QR of rows that far apart in weight). State fields: positions and
velocities within 2e-5 (measured <= 6e-6), biases and quaternion within 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from lvislam_tpu.core import lie as jlie
from lvislam_tpu.models.lio import imu_fusion as jfus
from lvislam_tpu.utils import synthetic as jsyn
from lvislam_tpu_torch.models.lio import imu_fusion as tfus
from lvislam_tpu_torch.utils import convert
from lvislam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

# the walk and prior of tests/test_imu_fusion.py::test_fusion_estimates_bias
KW = dict(imuGravity=jsyn.GRAVITY, imuAccBiasN=2e-2, imuGyrBiasN=5e-3, priorBiasSigma=0.1)
PJ = jfus.FusionParams(**KW)
PT = convert.fusion_params_from_jax(PJ)
TRUE_BG = np.array([0.02, -0.01, 0.015])
TRUE_BA = np.array([0.05, 0.08, -0.06])
RATE, N = 10.0, 24


def _t(a):
    return torch.from_numpy(np.array(a))


def _stream(seconds):
    traj = jsyn.figure8_trajectory(scale=3.0, period=30.0)
    t, w, f = jsyn.simulate_imu_stream(traj, 0.0, seconds, rate=200.0, gyro_bias=TRUE_BG,
                                       accel_bias=TRUE_BA, gyro_noise=1e-4, accel_noise=1e-3)
    return traj, t, w, f


def _pose(traj, tk):
    p, R = traj.pose(np.array([tk]))
    return p[0].astype(np.float32), np.roll(Rsc.from_matrix(R[0]).as_quat(), 1).astype(np.float32)


def _window(t, w, f, k):
    """The padded IMU window of correction k (tests/test_imu_fusion.py)."""
    tk = k / RATE
    sel = (t > tk - 1.0 / RATE) & (t <= tk)
    n = int(sel.sum())
    dts, accs, gyrs = np.zeros(N, np.float32), np.zeros((N, 3), np.float32), np.zeros((N, 3), np.float32)
    dts[:n] = np.diff(t[sel], prepend=tk - 1.0 / RATE)
    accs[:n], gyrs[:n] = f[sel], w[sel]
    accs[n:], gyrs[n:] = accs[n - 1], gyrs[n - 1]
    return dts, accs, gyrs


def _assert_state_close(sj, st):
    for name, atol in (("pos", 2e-5), ("vel", 2e-5), ("quat", 1e-6), ("ba", 1e-6), ("bg", 1e-6)):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                   atol=atol, rtol=0, err_msg=name)
    Ij = np.asarray(sj.sqrt_info, np.float64)
    It = st.sqrt_info.numpy().astype(np.float64)
    Ij, It = Ij.T @ Ij, It.T @ It
    np.testing.assert_allclose(It, Ij, atol=2e-4 * np.abs(Ij).max(), rtol=0)
    for name in ("initialized", "failed", "reset_id"):
        assert getattr(st, name).numpy() == np.asarray(getattr(sj, name)), name


def test_simulate_imu_stream_is_the_jax_package_s():
    traj, t, w, f = _stream(1.0)
    t2, w2, f2 = tsyn.simulate_imu_stream(
        tsyn.figure8_trajectory(scale=3.0, period=30.0), 0.0, 1.0, rate=200.0,
        gyro_bias=TRUE_BG, accel_bias=TRUE_BA, gyro_noise=1e-4, accel_noise=1e-3)
    for a, b in ((t, t2), (w, w2), (f, f2)):
        np.testing.assert_array_equal(a, b)


def test_init_and_initialize_match_jax():
    sj = jfus.fusion_init(PJ)
    st = tfus.fusion_init(PT, device="cpu")
    for name in st._fields:
        a, b = np.asarray(getattr(sj, name)), getattr(st, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)
    p, q = np.array([1, 2, 3], np.float32), np.array([0, 1, 0, 0], np.float32)
    sj = jfus.fusion_initialize(sj._replace(reset_id=jnp.int32(3)), jnp.asarray(p), jnp.asarray(q), PJ)
    st = tfus.fusion_initialize(st._replace(reset_id=torch.tensor(3, dtype=torch.int32)), _t(p), _t(q), PT)
    _assert_state_close(sj, st)
    assert bool(st.initialized) and int(st.reset_id) == 3


@pytest.mark.parametrize("degenerate", [False, True])
def test_ten_corrections_each_from_the_carried_jax_state(degenerate):
    traj, t, w, f = _stream(1.2)
    sj = jfus.fusion_initialize(jfus.fusion_init(PJ), *map(jnp.asarray, _pose(traj, 0.0)), PJ)
    for k in range(1, 11):
        dts, accs, gyrs = _window(t, w, f, k)
        p, q = _pose(traj, k / RATE)
        st = convert.fusion_state_from_jax(sj, "cpu")
        sj = jfus.fusion_correct(sj, jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs),
                                 jnp.asarray(p), jnp.asarray(q), jnp.asarray(degenerate), PJ)
        st = tfus.fusion_correct(st, _t(dts), _t(accs), _t(gyrs), _t(p), _t(q),
                                 torch.tensor(degenerate), PT)
        _assert_state_close(sj, st)
        assert not bool(st.failed)


def test_free_running_smoother_tracks_jax_and_the_bias():
    """40 corrections, each smoother carrying its own state: the port stays
    with JAX (position 1e-4 m, gyro bias 2e-5: rounding fed back through 40
    solves; measured 2e-5 and 3e-6) and moves towards the injected bias."""
    traj, t, w, f = _stream(4.2)
    sj = jfus.fusion_initialize(jfus.fusion_init(PJ), *map(jnp.asarray, _pose(traj, 0.0)), PJ)
    st = convert.fusion_state_from_jax(sj, "cpu")
    for k in range(1, 41):
        dts, accs, gyrs = _window(t, w, f, k)
        p, q = _pose(traj, k / RATE)
        sj = jfus.fusion_correct(sj, jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs),
                                 jnp.asarray(p), jnp.asarray(q), jnp.asarray(False), PJ)
        st = tfus.fusion_correct(st, _t(dts), _t(accs), _t(gyrs), _t(p), _t(q),
                                 torch.tensor(False), PT)
        assert not bool(st.failed)
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sj.pos), atol=1e-4)
    np.testing.assert_allclose(st.bg.numpy(), np.asarray(sj.bg), atol=2e-5)
    np.testing.assert_allclose(st.ba.numpy(), np.asarray(sj.ba), atol=2e-4)
    assert np.linalg.norm(st.bg.numpy() - TRUE_BG) < np.linalg.norm(TRUE_BG)
    assert np.linalg.norm(st.pos.numpy() - _pose(traj, 4.0)[0]) < 0.1


def test_failure_reset_matches_jax():
    pj = jfus.FusionParams(imuGravity=jsyn.GRAVITY)
    pt = convert.fusion_params_from_jax(pj)
    sj = jfus.fusion_initialize(jfus.fusion_init(pj), jnp.zeros(3), jlie.quat_identity(), pj)
    st = convert.fusion_state_from_jax(sj, "cpu")
    # absurd accelerations -> runaway velocity -> failure
    dts = np.full(32, 0.005, np.float32)
    accs = np.tile(np.array([500.0, 0.0, 9.81], np.float32), (32, 1))
    gyrs = np.zeros((32, 3), np.float32)
    s2j = jfus.fusion_correct(sj, jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs),
                              jnp.zeros(3), jlie.quat_identity(), jnp.array(False), pj)
    s2t = tfus.fusion_correct(st, _t(dts), _t(accs), _t(gyrs), torch.zeros(3),
                              torch.tensor([1.0, 0, 0, 0]), torch.tensor(False), pt)
    assert bool(s2t.failed) and not bool(s2t.initialized)
    assert int(s2t.reset_id) == int(st.reset_id) + 1 == int(s2j.reset_id)
    fresh = tfus.fusion_init(pt, device="cpu")
    for name in ("pos", "quat", "vel", "ba", "bg", "sqrt_info"):
        assert torch.equal(getattr(s2t, name), getattr(fresh, name)), name


def test_predict_imu_rate_matches_jax_and_dead_reckons():
    """tests/test_imu_fusion.py::test_config1_dead_reckoning through both."""
    traj = jsyn.figure8_trajectory(scale=3.0, period=30.0)
    t, w, f = jsyn.simulate_imu_stream(traj, 0.0, 5.0, rate=200.0)
    p0, q0 = _pose(traj, 0.0)
    v0 = (traj.pose(np.array([1e-4]))[0][0] - traj.pose(np.array([-1e-4]))[0][0]) / 2e-4
    sj = jfus.fusion_init(PJ)._replace(pos=jnp.asarray(p0), quat=jnp.asarray(q0),
                                       vel=jnp.asarray(v0, jnp.float32))
    st = convert.fusion_state_from_jax(sj, "cpu")
    dts = np.diff(t, prepend=t[0]).astype(np.float32)
    out_j = jfus.predict_imu_rate(sj, jnp.asarray(dts), jnp.asarray(f, jnp.float32),
                                  jnp.asarray(w, jnp.float32), PJ)
    out_t = tfus.predict_imu_rate(st, _t(dts), _t(f.astype(np.float32)),
                                  _t(w.astype(np.float32)), PT)
    # 1000 sequential f32 steps: rounding accumulates to ~1e-5 m
    for a, b, atol in zip(out_j, out_t, (1e-4, 1e-5, 1e-4)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0)
    err = np.linalg.norm(out_t[0].numpy() - traj.pose(t)[0], axis=1)
    assert err[-1] < 0.5 and err[: len(err) // 2].max() < 0.15


def test_transform_fusion_matches_jax():
    rng = np.random.default_rng(5)
    ts = rng.normal(size=(3, 3)).astype(np.float32)
    qs = rng.normal(size=(3, 4)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    args = [ts[0], qs[0], ts[1], qs[1], ts[2], qs[2]]
    tj, qj = jfus.transform_fusion(*map(jnp.asarray, args))
    tt, qt = tfus.transform_fusion(*map(_t, args))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-6)


@pytest.mark.slow
def test_jax_fusion_over_replay_anchor():
    """The JAX package's smoother on the CPU over `chip_smoke.py` phase 9b's
    90 corrections: the card's LIO replay poses (phase 3's trajectory,
    sha256 `12114c5d46c4c33b`, stored in `tests/data`), the same injected
    biases and noise seed. The end state's bias and position errors are
    `utils/anchors.FUSION_REPLAY` (prints them)."""
    import sys
    from pathlib import Path

    from lvislam_tpu_torch.utils import anchors

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke

    traj6 = np.load(root / "tests" / "data" / "lio_replay_trajectory.npy")
    settings, first, steps = chip_smoke.fusion_inputs(traj6)
    params = jfus.FusionParams(**settings)
    st = jfus.fusion_initialize(jfus.fusion_init(params), jnp.asarray(first[0]),
                                jnp.asarray(first[1]), params)
    failed = False
    for dts, accs, gyrs, pos, quat in steps:
        st = jfus.fusion_correct(st, jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs),
                                 jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(False), params)
        failed |= bool(st.failed)
    bg_err, ba_err, pos_err = chip_smoke.fusion_errors(np.asarray(st.bg), np.asarray(st.ba),
                                                       np.asarray(st.pos), traj6[-1, 3:6])
    got = {"poses_sha256": chip_smoke.sha256(traj6), "corrections": len(steps),
           "failed": failed, "bg_err_over_true": bg_err, "ba_err_over_true": ba_err,
           "pos_err_m": pos_err, "ba_est": [float(v) for v in np.asarray(st.ba)],
           "bg_est": [float(v) for v in np.asarray(st.bg)]}
    print("FUSION_REPLAY =", got)
    ref = anchors.FUSION_REPLAY
    for key, v in got.items():
        if isinstance(v, float):
            assert v == pytest.approx(ref[key], rel=1e-6), key
        elif isinstance(v, list):
            np.testing.assert_allclose(v, ref[key], rtol=1e-6, err_msg=key)
        else:
            assert v == ref[key], key
