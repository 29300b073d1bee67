"""The port's geometry substrate against the JAX package: SO(3)/SE(3)
helpers, the closed-form 3x3 eigensystem and plane fit, the gyro deskew
table, the pose graph and ICP.

Tolerances: element-wise maths within 1e-5 absolute (f32 transcendental
functions differ by an ulp or two between XLA and PyTorch, and XLA on the
CPU contracts multiply-adds into FMAs, PyTorch does not); the deskew table is
bit-identical (same product tree as ``lax.associative_scan``); the plane fit
on well-conditioned neighbourhoods within 1e-3; solver outputs within the
tolerances stated at each test."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.core import lie as jl
from lvislam_tpu.ops import icp as jicp, posegraph as jpg, preintegration as jpre, smallmat as jsm
from lvislam_tpu_torch.core import lie as tl
from lvislam_tpu_torch.ops import icp as ticp, posegraph as tpg, preintegration as tpre, smallmat as tsm

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(j, t, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_lie_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(200, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.normal(size=(200, 4)).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    v = rng.normal(size=(200, 3)).astype(np.float32)
    ypr = rng.uniform(-170, 170, (200, 3)).astype(np.float32)
    J, T = jnp.asarray, _t
    _close(jl.quat_multiply(J(q), J(p)), tl.quat_multiply(T(q), T(p)))
    _close(jl.quat_rotate(J(q), J(v)), tl.quat_rotate(T(q), T(v)))
    _close(jl.quat_to_matrix(J(q)), tl.quat_to_matrix(T(q)))
    R = np.asarray(jl.quat_to_matrix(J(q)))
    qj, qt = jl.matrix_to_quat(J(R)), tl.matrix_to_quat(T(R))
    _close(qj, qt)
    _close(jl.ypr_to_matrix(J(ypr)), tl.ypr_to_matrix(T(ypr)))
    _close(jl.matrix_to_ypr(J(R)), tl.matrix_to_ypr(T(R)), atol=5e-4)  # degrees
    _close(jl.quat_log(J(q)), tl.quat_log(T(q)))
    _close(jl.so3_exp_quat(J(v * 0.3)), tl.so3_exp_quat(T(v * 0.3)))
    t = rng.random((200, 1)).astype(np.float32)
    _close(jl.quat_slerp(J(q), J(p), J(t)), tl.quat_slerp(T(q), T(p), T(t)))
    t1, t2 = rng.normal(size=(2, 3)).astype(np.float32)
    for jf, tf in [(jl.se3_compose, tl.se3_compose), (jl.se3_relative, tl.se3_relative)]:
        a, b = jf(J(t1), J(q[0]), J(t2), J(q[1])), tf(T(t1), T(q[0]), T(t2), T(q[1]))
        _close(a[0], b[0])
        _close(a[1], b[1])
    x6 = rng.uniform(-1, 1, 6).astype(np.float32)
    _close(jl.pose6_to_matrix(J(x6)), tl.pose6_to_matrix(T(x6)))


_RNG = np.random.default_rng(10)
_Q = _RNG.normal(size=(50, 4)).astype(np.float32)
_QU = _Q / np.linalg.norm(_Q, axis=1, keepdims=True)
_V = _RNG.normal(size=(50, 3)).astype(np.float32)
_V[:3] *= 1e-6  # the Taylor branches near zero angle
_T4 = np.tile(np.eye(4, dtype=np.float32), (50, 1, 1))
_T4[:, :3, :3] = np.asarray(jl.quat_to_matrix(jnp.asarray(_QU)))
_T4[:, :3, 3] = _V
# name -> (arguments, absolute tolerance); angles from matrix_to_ypr lose
# digits near gimbal lock, so the Euler outputs get 5e-5 rad
LIE_CASES = {
    "skew": ((_V,), 0.0),
    "g2R": ((_V + np.array([0, 0, 9.8], np.float32),), 1e-5),
    "so3_exp": ((_V,), 1e-5),
    "so3_log": ((_T4[:, :3, :3],), 1e-5),
    "quat_left": ((_Q,), 0.0),
    "quat_right": ((_Q,), 0.0),
    "quat_inverse": ((_Q,), 1e-6),
    "quat_to_rpy": ((_QU,), 5e-5),
    "se3_apply": ((_V[0], _QU[0], _V[1:]), 1e-5),
    "matrix_to_pose6": ((_T4,), 5e-5),
    "so3_right_jacobian": ((_V,), 1e-5),
    "so3_right_jacobian_inv": ((_V,), 1e-5),
}


@pytest.mark.parametrize("name", list(LIE_CASES))
def test_lie_additions_match_jax(name):
    args, atol = LIE_CASES[name]
    out_j = getattr(jl, name)(*map(jnp.asarray, args))
    out_t = getattr(tl, name)(*map(_t, args))
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    for a, b in zip(out_j, out_t):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        _close(a, b, atol=atol)


def test_gyro_rotation_table_bit_identical():
    rng = np.random.default_rng(1)
    for M in (64, 37):
        dts = np.full(M, 0.005, np.float32)
        dts[M // 2:] = 0.0  # padding samples are exact no-ops
        g = rng.normal(0, 0.7, (M, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(jpre.gyro_rotation_table(jnp.asarray(dts), jnp.asarray(g))),
            tpre.gyro_rotation_table(_t(dts), _t(g)).numpy())


def test_eigensystem_and_plane_fit_match_jax():
    rng = np.random.default_rng(2)
    # well-spread 5-point neighbourhoods (the corner covariance case)
    nb = rng.normal(size=(500, 5, 3)).astype(np.float32) * np.array([1.0, 0.4, 0.1], np.float32)
    cov = np.einsum("nki,nkj->nij", nb - nb.mean(1, keepdims=True),
                    nb - nb.mean(1, keepdims=True)).astype(np.float32) / 5
    lj = jsm.sym3x3_eigvals(jnp.asarray(cov))
    lt = tsm.sym3x3_eigvals(_t(cov))
    for a, b in zip(lj, lt):
        _close(a, b, atol=1e-5)
    vj = jsm.sym3x3_max_eigvec(jnp.asarray(cov), *lj)
    vt = tsm.sym3x3_max_eigvec(_t(cov), *lt)
    # the eigenvector is ill-conditioned where l1 ~ l2 (a few of 500 draws)
    _close(vj, vt, atol=5e-3)
    # thick planes near the origin: well conditioned (thin ones are not —
    # there f32 rounding alone moves the fitted normal by 1e-3..1e-2 in
    # either implementation, see tests/test_torch_scan2map.py)
    u = rng.normal(size=(500, 1, 3))
    w = rng.normal(size=(500, 1, 3))
    pts = (rng.normal(size=(500, 3))[:, None] * 2 + rng.uniform(-1, 1, (500, 5, 1)) * u
           + rng.uniform(-1, 1, (500, 5, 1)) * w + rng.normal(0, 0.3, (500, 5, 3))).astype(np.float32)
    nj, dj = jsm.plane_fit(jnp.asarray(pts))
    nt, dt = tsm.plane_fit(_t(pts))
    _close(nj, nt, atol=2e-3)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-3, atol=1e-3)
    A = rng.normal(size=(100, 3, 3)).astype(np.float32)
    b = rng.normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_allclose(tsm.solve3x3(_t(A), _t(b)).numpy(),
                               np.asarray(jsm.solve3x3(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-4)


def _loop_graph(mod, K=24, F=32, G=4, torch_side=False):
    """A drifting circle of K poses with odometry factors and one loop
    factor pulling the last pose onto the first (as tests/test_posegraph_icp
    builds it), on either side."""
    rng = np.random.default_rng(3)
    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    trans = np.stack([5 * np.cos(ang), 5 * np.sin(ang), np.zeros(K)], 1).astype(np.float32)
    trans += rng.normal(0, 0.05, trans.shape).astype(np.float32) * np.arange(K)[:, None] / K
    quat = np.stack([np.cos(ang / 2), np.zeros(K), np.zeros(K), np.sin(ang / 2)], 1).astype(np.float32)
    bf_i = np.zeros(F, np.int32)
    bf_j = np.zeros(F, np.int32)
    bf_t = np.zeros((F, 3), np.float32)
    bf_q = np.tile(np.array([1, 0, 0, 0], np.float32), (F, 1))
    bf_w = np.zeros((F, 6), np.float32)
    bf_v = np.zeros(F, bool)
    step = 2 * np.pi / K
    for f in range(K - 1):
        bf_i[f], bf_j[f] = f, f + 1
        c, s = np.cos(ang[f]), np.sin(ang[f])
        d = np.array([5 * np.cos(ang[f + 1]) - 5 * c, 5 * np.sin(ang[f + 1]) - 5 * s, 0.0])
        bf_t[f] = [c * d[0] + s * d[1], -s * d[0] + c * d[1], 0.0]
        bf_q[f] = [np.cos(step / 2), 0, 0, np.sin(step / 2)]
        bf_w[f] = jpg.ODOM_SQRTW
        bf_v[f] = True
    f = K
    bf_i[f], bf_j[f] = K - 1, 0
    d = np.array([5.0 - 5 * np.cos(ang[-1]), -5 * np.sin(ang[-1]), 0.0])
    c, s = np.cos(ang[-1]), np.sin(ang[-1])
    bf_t[f] = [c * d[0] + s * d[1], -s * d[0] + c * d[1], 0.0]
    bf_q[f] = [np.cos(step / 2), 0, 0, np.sin(step / 2)]
    bf_w[f] = 10.0
    bf_v[f] = True
    arrays = dict(
        trans=trans, quat=quat, node_valid=np.ones(K, bool), bf_i=bf_i, bf_j=bf_j,
        bf_trans=bf_t, bf_quat=bf_q, bf_sqrtw=bf_w, bf_valid=bf_v,
        up_k=np.zeros(G, np.int32), up_pos=np.zeros((G, 3), np.float32),
        up_sqrtw=np.zeros((G, 3), np.float32), up_valid=np.zeros(G, bool),
        prior_trans=trans[0], prior_quat=quat[0],
        prior_sqrtw=np.array(jpg.PRIOR_SQRTW, np.float32),
    )
    # one GPS factor on node 5
    arrays["up_k"][0] = 5
    arrays["up_pos"][0] = trans[5] + np.array([0.2, -0.1, 0.0], np.float32)
    arrays["up_sqrtw"][0] = 1.0
    arrays["up_valid"][0] = True
    if torch_side:
        return tpg.PoseGraph(**{k: _t(v) for k, v in arrays.items()})
    return jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()})


def test_posegraph_optimize_matches_jax():
    gj = jpg.optimize(_loop_graph(jpg), gn_iters=6, pcg_iters=96)
    gt = tpg.optimize(_loop_graph(tpg, torch_side=True), gn_iters=6, pcg_iters=96)
    # PCG in f32 over 24 nodes: positions to 2 mm, rotations to 1e-3
    np.testing.assert_allclose(gt.trans.numpy(), np.asarray(gj.trans), atol=2e-3)
    np.testing.assert_allclose(np.abs(gt.quat.numpy()), np.abs(np.asarray(gj.quat)), atol=1e-3)
    e0 = float(jpg.total_error(_loop_graph(jpg)))
    ej, et = float(jpg.total_error(gj)), float(tpg.total_error(gt))
    assert et < 0.01 * e0 and abs(et - ej) <= 0.05 * ej + 1e-3
    np.testing.assert_allclose(
        tpg.marginal_position_variance(gt, 5).numpy(),
        np.asarray(jpg.marginal_position_variance(gj, 5)), rtol=2e-2)


def test_icp_matches_jax():
    rng = np.random.default_rng(4)
    dst = rng.uniform(-5, 5, (1500, 3)).astype(np.float32)
    ang = 0.08
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    src = ((dst[:600] - np.array([0.2, -0.1, 0.05], np.float32)) @ R).astype(np.float32)
    sv = np.ones(600, bool)
    dv = np.ones(1500, bool)
    rj = jicp.icp_point2point(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(dst), jnp.asarray(dv),
                              jnp.zeros(3), jnp.array([1.0, 0, 0, 0]), iters=15)
    rt = ticp.icp_point2point(_t(src), _t(sv), _t(dst), _t(dv), torch.zeros(3),
                              torch.tensor([1.0, 0, 0, 0]), iters=15)
    np.testing.assert_allclose(rt.trans.numpy(), np.asarray(rj.trans), atol=1e-4)
    np.testing.assert_allclose(rt.quat.numpy(), np.asarray(rj.quat), atol=1e-4)
    np.testing.assert_allclose(float(rt.fitness), float(rj.fitness), rtol=1e-2, atol=1e-6)
    assert int(rt.num_corr) == int(rj.num_corr)
