"""The port's visual-inertial initializer against the JAX package on the
CPU: a 7-frame window (W = 6, 0.15 s apart, 48 landmarks, 30 IMU samples an
interval padded to 36) on the figure-8 with real accelerometer excitation
(scale 1.5, period 8) and an injected gyro bias.

The alignment stages get JAX's SfM result as their input, so they compare at
f32 rounding of their (ill-conditioned: the scale column is /100, the system
x1000) normal equations. `global_sfm` and `visual_initialize` run whole in
both, with JAX's RANSAC draws: 4 rounds of PnP Gauss-Newton plus an 8-step
LM over 180 variables feed rounding back through ~50 solves, so poses and
points are held to 2e-3 (measured below 3e-4), far inside what the estimator
needs (the scale itself is only good to percents)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from lvislam_tpu.models.vio import feature_manager as jfm, initializer as jinit
from lvislam_tpu.ops import preintegration as jpre, ransac as jr
from lvislam_tpu.utils import synthetic as jsyn
from lvislam_tpu_torch.models.vio import initializer as tinit
from lvislam_tpu_torch.utils import convert

torch.set_num_threads(1)

W, F, M, DT_FRAME, T0 = 6, 48, 36, 0.15, 1.5
R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
QIC = np.roll(Rsc.from_matrix(R_BC).as_quat(), 1).astype(np.float32)
TIC = np.zeros(3, np.float32)
BG = np.array([0.01, -0.02, 0.015])
NOISE = (0.4, 0.15, 6.4e-3, 3.6e-3)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def jax_sampler(weights, n_hyp, k):
    w = jnp.asarray(weights.numpy())
    idx = jr._sample_indices(jax.random.PRNGKey(0), n_hyp, k, w.shape[0], w)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


@pytest.fixture(scope="module")
def window():
    rng = np.random.default_rng(0)
    traj = jsyn.figure8_trajectory(scale=1.5, period=8.0)
    ts = T0 + DT_FRAME * np.arange(W + 1)
    P, R = traj.pose(ts)
    Rc = R @ R_BC  # camera in the world
    mid = W // 2
    d = np.stack([rng.uniform(-0.6, 0.6, F), rng.uniform(-0.4, 0.4, F), np.ones(F)], 1)
    Xw = P[mid] + (d * rng.uniform(3, 8, (F, 1))) @ Rc[mid].T
    obs = np.zeros((F, W + 1, 2), np.float32)
    valid = np.zeros((F, W + 1), bool)
    for k in range(W + 1):
        Xc = (Xw - P[k]) @ Rc[k]
        obs[:, k] = Xc[:, :2] / np.maximum(Xc[:, 2:], 1e-3) + rng.normal(0, 2e-4, (F, 2))
        valid[:, k] = (Xc[:, 2] > 0.5) & (np.abs(obs[:, k]).max(1) < 1.5) & (rng.random(F) < 0.95)
    table = jfm.table_init(jfm.VioCaps(window=W, max_features=F, imu_buf=M, frame_features=F))
    table = table._replace(ids=jnp.arange(F, dtype=jnp.int32), obs=jnp.asarray(obs),
                           obs_valid=jnp.asarray(valid),
                           start_frame=jnp.asarray(np.argmax(valid, 1), jnp.int32))
    n = int(round(DT_FRAME * 200))
    dts = np.zeros((W, M), np.float32)
    accs, gyrs = np.zeros((W, M, 3), np.float32), np.zeros((W, M, 3), np.float32)
    for k in range(W):
        t = ts[k] + (np.arange(n) + 1) / 200.0
        w_, f_ = traj.imu(t)
        dts[k, :n] = 1.0 / 200.0
        accs[k, :n], gyrs[k, :n] = f_, w_ + BG
        accs[k, n:], gyrs[k, n:] = accs[k, n - 1], gyrs[k, n - 1]
    noise = jpre.ImuNoise.create(*NOISE)
    z3 = jnp.zeros(3)
    pints = jax.vmap(lambda d_, a, g: jpre.preintegrate(jpre.preint_init(a[0], g[0], z3, z3), d_, a, g, noise))(
        jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs))
    bufs = (jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs))
    sfm = jinit.global_sfm(table, W)
    return dict(table=table, pints=pints, bufs=bufs, noise=noise, sfm=sfm, P=P, R=R, ts=ts, traj=traj)


def _sfm_inputs(window):
    """Camera centres and body rotations of JAX's SfM result, as
    `visual_initialize` forms them, for both packages."""
    from lvislam_tpu.core import lie as jlie

    sfm = window["sfm"]
    Rwc = jax.vmap(lambda q: jlie.quat_to_matrix(q).T)(sfm.Qs)
    q_wc = jax.vmap(jlie.matrix_to_quat)(Rwc)
    p_c = -jnp.einsum("kij,kj->ki", Rwc, sfm.Ts)
    q_wb = jax.vmap(lambda q: jlie.quat_multiply(q, jlie.quat_conjugate(jnp.asarray(QIC))))(q_wc)
    return q_wc, p_c, q_wb


def test_find_reference_frame_matches_jax(window):
    lj, okj = jinit.find_reference_frame(window["table"], W)
    lt, okt = tinit.find_reference_frame(convert.table_from_jax(window["table"], "cpu"), W)
    assert int(lt) == int(lj)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.any()


def test_global_sfm_matches_jax(window):
    sj = window["sfm"]
    st = tinit.global_sfm(convert.table_from_jax(window["table"], "cpu"), W, sampler=jax_sampler)
    assert bool(sj.ok) and bool(st.ok) and int(st.ref_frame) == int(sj.ref_frame)
    np.testing.assert_array_equal(st.point_valid.numpy(), np.asarray(sj.point_valid))
    sign = np.sign(np.sum(np.asarray(sj.Qs) * st.Qs.numpy(), axis=1, keepdims=True))
    np.testing.assert_allclose(sign * st.Qs.numpy(), np.asarray(sj.Qs), atol=2e-3, rtol=0)
    np.testing.assert_allclose(st.Ts.numpy(), np.asarray(sj.Ts), atol=2e-3, rtol=0)
    np.testing.assert_allclose(st.points.numpy(), np.asarray(sj.points), atol=2e-3, rtol=2e-3)
    assert int(st.point_valid.sum()) > 30


def test_pnp_gn_batched_matches_jax_per_frame(window):
    sfm, table = window["sfm"], window["table"]
    k = 2
    qj, tj = jinit._pnp_gn(table.obs[:, k], table.obs_valid[:, k] & sfm.point_valid, sfm.points,
                           sfm.Qs[k] * 1.0, sfm.Ts[k] + 0.05)
    tt = convert.table_from_jax(table, "cpu")
    q, t = tinit._pnp_gn(tt.obs.transpose(0, 1), tt.obs_valid.transpose(0, 1) & _t(sfm.point_valid)[None],
                         _t(sfm.points), _t(sfm.Qs), _t(sfm.Ts) + 0.05)
    np.testing.assert_allclose(q[k].numpy(), np.asarray(qj), atol=1e-5)
    np.testing.assert_allclose(t[k].numpy(), np.asarray(tj), atol=1e-5)


def test_solve_gyro_bias_matches_jax(window):
    q_wc, _, _ = _sfm_inputs(window)
    bj = jinit.solve_gyro_bias(q_wc, window["pints"], jnp.asarray(QIC), W)
    bt = tinit.solve_gyro_bias(_t(q_wc), convert.preint_from_jax(window["pints"], "cpu"), _t(QIC), W)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6, rtol=0)
    np.testing.assert_allclose(bt.numpy(), BG, atol=3e-3)  # and it finds the injected bias


def test_linear_alignment_and_refine_gravity_match_jax(window):
    _, p_c, q_wb = _sfm_inputs(window)
    pj, pt = window["pints"], convert.preint_from_jax(window["pints"], "cpu")
    xj, sj, gj, okj = jinit.linear_alignment(p_c, q_wb, pj, jnp.asarray(TIC), W, 9.81)
    xt, st, gt, okt = tinit.linear_alignment(_t(p_c), _t(q_wb), pt, _t(TIC), W, 9.81)
    assert bool(okj) == bool(okt)
    # normal equations scaled x1000 with a /100 column, solved in f32
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-3)
    g2j, x2j, s2j = jinit.refine_gravity(p_c, q_wb, pj, jnp.asarray(TIC), W, 9.81, gj)
    g2t, x2t, s2t = tinit.refine_gravity(_t(p_c), _t(q_wb), pt, _t(TIC), W, 9.81, _t(gj))
    np.testing.assert_allclose(g2t.numpy(), np.asarray(g2j), atol=2e-3)
    np.testing.assert_allclose(x2t.numpy(), np.asarray(x2j), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(float(s2t), float(s2j), rtol=1e-3)
    assert abs(np.linalg.norm(g2t.numpy()) - 9.81) < 1e-3


def test_visual_initialize_matches_jax_and_the_truth(window):
    args_j = (window["table"], window["pints"], window["bufs"], jnp.asarray(TIC), jnp.asarray(QIC),
              W, 9.81, window["noise"])
    out_j = jinit.visual_initialize(*args_j)
    out_t = tinit.visual_initialize(
        convert.table_from_jax(window["table"], "cpu"), convert.preint_from_jax(window["pints"], "cpu"),
        tuple(_t(b) for b in window["bufs"]), _t(TIC), _t(QIC), W, 9.81,
        convert.noise_from_jax(window["noise"], "cpu"), sampler=jax_sampler)
    assert bool(out_j[5]) and bool(out_t[5])
    for a, b, atol in zip(out_j[:4], out_t[:4], (5e-3, 2e-3, 1e-2, 1e-5)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0)
    pj, pt = out_j[4], out_t[4]
    for name in pt._fields:
        a = np.asarray(getattr(pj, name))
        np.testing.assert_allclose(getattr(pt, name).numpy(), a, atol=1e-5 * max(np.abs(a).max(), 1), rtol=0)
    # metric scale from the IMU: frame-to-frame distances within 15%
    Ps = out_t[0].numpy()
    d_est = np.linalg.norm(np.diff(Ps, axis=0), axis=1).sum()
    d_true = np.linalg.norm(np.diff(window["P"], axis=0), axis=1).sum()
    assert abs(d_est / d_true - 1.0) < 0.15, (d_est, d_true)
