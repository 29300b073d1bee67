"""The port's IMU preintegration and NavState propagation against the JAX
package on the CPU, on the same numpy arrays.

Tolerances: the deltas, the 15x15 Jacobian and the covariance within 1e-6 of
their scale after 32 midpoint steps (the two differ only in f32 rounding of
the 15x15 products: XLA on the CPU contracts multiply-adds into FMAs,
PyTorch does not; measured <= 2e-7). `navstate_predict` uses JAX's own
product tree and a prefix sum, and comes out within 1e-6 (measured: equal
bits on this input); against the port's sequential recursion it is held to
the JAX test's own tolerances."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.ops import preintegration as jpre
from lvislam_tpu_torch.ops import preintegration as tpre
from lvislam_tpu_torch.utils import convert

torch.set_num_threads(1)

NOISE = (0.1, 0.01, 0.001, 0.0001)
NJ = jpre.ImuNoise.create(*NOISE)
NT = tpre.ImuNoise.create(*NOISE, device="cpu")
J_PREINT = jax.jit(jpre.preintegrate)


def _t(a):
    return torch.from_numpy(np.array(a))


def _imu(seed, n=32, pad=0, dt=0.005):
    """Smooth IMU samples with noise; the last `pad` are dt = 0 repeats."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * dt
    gyr = np.stack([0.8 * np.sin(2 * t), 0.5 * np.cos(3 * t), 0.3 * np.sin(t + 0.5)], -1)
    acc = np.stack([0.5 * np.sin(t), 9.8 + 0.2 * np.cos(2 * t), np.sin(3 * t)], -1)
    gyr = (gyr + 0.01 * rng.normal(size=gyr.shape)).astype(np.float32)
    acc = (acc + 0.05 * rng.normal(size=acc.shape)).astype(np.float32)
    dts = np.full(n, dt, np.float32)
    if pad:
        dts[-pad:] = 0.0
        acc[-pad:] = acc[-pad - 1]
        gyr[-pad:] = gyr[-pad - 1]
    return dts, acc, gyr


def _both(seed, pad=0, ba=(0.0, 0.0, 0.0), bg=(0.0, 0.0, 0.0), n=32):
    dts, acc, gyr = _imu(seed, n=n, pad=pad)
    ba, bg = np.asarray(ba, np.float32), np.asarray(bg, np.float32)
    sj = J_PREINT(jpre.preint_init(acc[0], gyr[0], ba, bg), jnp.asarray(dts),
                  jnp.asarray(acc), jnp.asarray(gyr), NJ)
    st = tpre.preintegrate(tpre.preint_init(_t(acc[0]), _t(gyr[0]), _t(ba), _t(bg)),
                           _t(dts), _t(acc), _t(gyr), NT)
    return sj, st


def _assert_state_close(sj, st, rel=1e-6):
    for name in st._fields:
        a, b = np.asarray(getattr(sj, name)), getattr(st, name).numpy()
        assert a.shape == b.shape and b.dtype == np.float32, name
        np.testing.assert_allclose(b, a, atol=rel * max(np.abs(a).max(), 1.0), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["plain", "padded", "biased", "long"])
def test_preintegrate_matches_jax(case):
    kw = {"plain": {}, "padded": {"pad": 8}, "long": {"n": 64, "pad": 3},
          "biased": {"ba": (0.05, -0.02, 0.01), "bg": (0.002, 0.001, -0.003)}}[case]
    sj, st = _both(1, **kw)
    _assert_state_close(sj, st)
    assert float(st.sum_dt) > 0.1 and float(st.covariance[0, 0]) > 0


def test_noise_and_init_match_jax():
    np.testing.assert_array_equal(NT.diag18().numpy(), np.asarray(NJ.diag18()))
    _assert_state_close(jpre.preint_init(np.ones(3), np.zeros(3), np.zeros(3), np.ones(3)),
                        tpre.preint_init(torch.ones(3), torch.zeros(3), torch.zeros(3),
                                         torch.ones(3)), rel=0.0)
    _assert_state_close(NJ, convert.noise_from_jax(NJ, "cpu"), rel=0.0)


def test_padding_is_a_noop():
    """dt = 0 steps leave the deltas, the Jacobian and the covariance where
    they were (F = I, V = 0): the JAX test's tolerances, and the Jacobian and
    covariance exactly."""
    dts, acc, gyr = _imu(2, n=40)
    pad = lambda x: np.concatenate([x, np.repeat(x[-1:], 16, 0)])
    run = lambda d, a, g: tpre.preintegrate(
        tpre.preint_init(_t(a[0]), _t(g[0]), torch.zeros(3), torch.zeros(3)),
        _t(d), _t(a), _t(g), NT)
    s0 = run(dts, acc, gyr)
    s1 = run(np.concatenate([dts, np.zeros(16, np.float32)]), pad(acc), pad(gyr))
    np.testing.assert_allclose(s1.delta_p.numpy(), s0.delta_p.numpy(), atol=1e-6)
    np.testing.assert_allclose(s1.delta_q.numpy(), s0.delta_q.numpy(), atol=1e-6)
    assert torch.equal(s1.jacobian, s0.jacobian)
    assert torch.equal(s1.covariance, s0.covariance)
    assert torch.equal(s1.sum_dt, s0.sum_dt)


def test_windows_side_by_side_match_one_by_one():
    """W windows as one loop over (W, ...) tensors give what W loops give
    (batched 15x15 products round as single ones do to 1e-6 of scale)."""
    sets = [_imu(s, pad=s) for s in (3, 4, 5)]
    dts, acc, gyr = (np.stack(x) for x in zip(*sets))
    bg = np.array([0.01, 0.0, -0.01], np.float32)
    sb = tpre.preintegrate(tpre.preint_init(_t(acc[:, 0]), _t(gyr[:, 0]), torch.zeros(3), _t(bg)),
                           _t(dts), _t(acc), _t(gyr), NT)
    assert sb.jacobian.shape == (3, 15, 15) and sb.sum_dt.shape == (3,)
    for k, (d, a, g) in enumerate(sets):
        s1 = tpre.preintegrate(tpre.preint_init(_t(a[0]), _t(g[0]), torch.zeros(3), _t(bg)),
                               _t(d), _t(a), _t(g), NT)
        for name in s1._fields:
            x, y = getattr(s1, name).numpy(), getattr(sb, name)[k].numpy()
            np.testing.assert_allclose(y, x, atol=1e-6 * max(np.abs(x).max(), 1.0), rtol=0)


def test_repropagate_matches_jax():
    dts, acc, gyr = _imu(6, pad=4)
    ba, bg = np.array([0.03, 0.0, -0.02], np.float32), np.array([0.004, -0.002, 0.0], np.float32)
    sj, st = _both(6, pad=4)
    rj = jpre.repropagate(sj, jnp.asarray(dts), jnp.asarray(acc), jnp.asarray(gyr),
                          jnp.asarray(acc[0]), jnp.asarray(gyr[0]), jnp.asarray(ba),
                          jnp.asarray(bg), NJ)
    rt = tpre.repropagate(st, _t(dts), _t(acc), _t(gyr), _t(acc[0]), _t(gyr[0]), _t(ba),
                          _t(bg), NT)
    _assert_state_close(rj, rt)
    assert not np.allclose(rt.delta_p.numpy(), st.delta_p.numpy(), atol=1e-5)


def test_preint_compose_matches_jax():
    a_j, a_t = _both(7)
    b_j, b_t = _both(8, pad=5)
    _assert_state_close(jpre.preint_compose(a_j, b_j), tpre.preint_compose(a_t, b_t))
    # from one carried JAX pair
    _assert_state_close(jpre.preint_compose(a_j, b_j),
                        tpre.preint_compose(convert.preint_from_jax(a_j, "cpu"),
                                            convert.preint_from_jax(b_j, "cpu")))


def _nav_states(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    vals = dict(pos=rng.normal(size=(2, 3)), quat=q, vel=rng.normal(size=(2, 3)),
                ba=0.05 * rng.normal(size=(2, 3)), bg=0.01 * rng.normal(size=(2, 3)))
    return {k: v.astype(np.float32) for k, v in vals.items()}


def test_evaluate_matches_jax():
    sj, st = _both(9, ba=(0.02, 0.0, 0.01), bg=(0.001, 0.002, 0.0))
    x = _nav_states(9)
    G = np.array([0.0, 0.0, 9.81], np.float32)
    order = ("pos", "quat", "vel", "ba", "bg")
    args = [x[k][i] for i in (0, 1) for k in order]
    rj = jpre.evaluate(sj, *map(jnp.asarray, args), jnp.asarray(G))
    rt = tpre.evaluate(st, *map(_t, args), _t(G))
    # residuals of order 1..10: 1e-5 absolute is f32 rounding of the sums
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5, rtol=0)
    dj = jpre.bias_corrected_delta(sj, jnp.asarray(x["ba"][0]), jnp.asarray(x["bg"][0]))
    dt_ = tpre.bias_corrected_delta(st, _t(x["ba"][0]), _t(x["bg"][0]))
    for a, b in zip(dj, dt_):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


@pytest.mark.parametrize("prev", [False, True])
def test_navstate_predict_matches_jax_and_seq(prev):
    dts, acc, gyr = _imu(10, n=64, pad=14)
    x = _nav_states(10)
    nav_j = jpre.NavState(**{k: jnp.asarray(v[0]) for k, v in x.items()})
    nav_t = convert.navstate_from_jax(nav_j, "cpu")
    G = np.array([0.0, 0.0, -9.805], np.float32)
    kw_j = dict(prev_acc=jnp.asarray(acc[3]), prev_gyr=jnp.asarray(gyr[3])) if prev else {}
    kw_t = dict(prev_acc=_t(acc[3]), prev_gyr=_t(gyr[3])) if prev else {}
    a = jpre.navstate_predict(nav_j, jnp.asarray(dts), jnp.asarray(acc), jnp.asarray(gyr),
                              jnp.asarray(G), **kw_j)
    b = tpre.navstate_predict(nav_t, _t(dts), _t(acc), _t(gyr), _t(G), **kw_t)
    c = tpre.navstate_predict_seq(nav_t, _t(dts), _t(acc), _t(gyr), _t(G), **kw_t)
    for name in ("pos", "quat", "vel"):
        np.testing.assert_allclose(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                   atol=1e-6, rtol=0)
    # the JAX package's own parallel-vs-sequential tolerances
    np.testing.assert_allclose(b.quat.numpy(), c.quat.numpy(), atol=2e-6)
    np.testing.assert_allclose(b.vel.numpy(), c.vel.numpy(), atol=2e-4)
    np.testing.assert_allclose(b.pos.numpy(), c.pos.numpy(), atol=2e-4)
    cj = jpre.navstate_predict_seq(nav_j, jnp.asarray(dts), jnp.asarray(acc), jnp.asarray(gyr),
                                   jnp.asarray(G), **kw_j)
    np.testing.assert_allclose(c.pos.numpy(), np.asarray(cj.pos), atol=1e-5)


@pytest.mark.parametrize("fn", ["navstate_predict_np", "predict_imu_rate_np"])
def test_numpy_predictors_equal_jax_package(fn):
    """The port's copies of the float64 host functions: same numbers."""
    dts, acc, gyr = _imu(11, n=40, pad=6)
    x = _nav_states(11)
    args = (x["pos"][0], x["quat"][0] * 1.01, x["vel"][0], x["ba"][0], x["bg"][0], dts, acc,
            gyr, np.array([0.0, 0.0, -9.805]))
    for a, b in zip(getattr(jpre, fn)(*args), getattr(tpre, fn)(*args)):
        assert b.dtype == np.float64
        np.testing.assert_allclose(b, a, atol=1e-12, rtol=0)


def test_navstate_identity_and_empty_window():
    nav = tpre.navstate_identity(device="cpu")
    np.testing.assert_array_equal(nav.quat.numpy(), [1, 0, 0, 0])
    p, q, v = tpre.navstate_predict_np(np.ones(3), [1, 0, 0, 0], np.zeros(3), np.zeros(3),
                                       np.zeros(3), np.zeros(0), np.zeros((0, 3)),
                                       np.zeros((0, 3)), np.zeros(3))
    np.testing.assert_array_equal(p, np.ones(3))
