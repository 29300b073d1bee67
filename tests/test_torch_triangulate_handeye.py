"""The port's triangulation, two-view relative pose and hand-eye rotation
calibration against the JAX package on the CPU.

`relative_pose` gets JAX's own RANSAC draws. The 3x3 SVD's U and Vᵀ have free
signs, which the four (R, ±t) candidates and the determinant fix absorb, so
only R and t after the cheirality vote are compared (2e-3: the essential
matrix is one noisy 8-point solve, as in tests/test_torch_ransac_depth.py).
The hand-eye null vector comes from `eigh`, whose sign is free: quaternions
are compared up to sign."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from lvislam_tpu.ops import handeye as jhe, ransac as jr, triangulate as jtri
from lvislam_tpu_torch.ops import handeye as the, triangulate as ttri

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_sampler(weights, n_hyp, k):
    w = jnp.asarray(weights.numpy())
    idx = jr._sample_indices(jax.random.PRNGKey(0), n_hyp, k, w.shape[0], w)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


def _two_view(seed, n=120, noise=5e-5, n_out=10):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 5.0])
    R = Rsc.from_euler("xyz", rng.uniform(-6, 6, 3), degrees=True).as_matrix()
    t = rng.uniform(-0.3, 0.3, 3) + np.array([0.3, 0, 0])
    X2 = X @ R.T + t
    x0 = X[:, :2] / X[:, 2:]
    x1 = X2[:, :2] / X2[:, 2:] + rng.normal(0, noise, (n, 2))
    x1[rng.choice(n, n_out, replace=False)] += rng.uniform(-0.2, 0.2, (n_out, 2))
    return x0.astype(np.float32), x1.astype(np.float32), rng.random(n) < 0.9, R, t, X


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relative_pose_with_jax_draws(seed):
    x0, x1, valid, R, t, _ = _two_view(seed)
    a = jtri.relative_pose(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(valid))
    b = ttri.relative_pose(_t(x0), _t(x1), _t(valid), sampler=jax_sampler)
    assert bool(a.ok) and bool(b.ok)
    np.testing.assert_array_equal(b.inliers.numpy(), np.asarray(a.inliers))
    np.testing.assert_allclose(b.R.numpy(), np.asarray(a.R), atol=2e-3, rtol=0)
    np.testing.assert_allclose(b.t.numpy(), np.asarray(a.t), atol=2e-3, rtol=0)
    np.testing.assert_allclose(b.R.numpy(), R, atol=2e-2)
    # the same draws through `idx`
    w = ttri.hypothesis_weights(_t(valid))
    c = ttri.relative_pose(_t(x0), _t(x1), _t(valid), idx=jax_sampler(w, 256, 8))
    assert torch.equal(c.R, b.R) and torch.equal(c.t, b.t)


def test_relative_pose_own_draws_are_repeatable_and_right():
    x0, x1, valid, R, t, _ = _two_view(3)
    a = ttri.relative_pose(_t(x0), _t(x1), _t(valid))
    b = ttri.relative_pose(_t(x0), _t(x1), _t(valid))
    assert bool(a.ok) and torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
    np.testing.assert_allclose(a.R.numpy(), R, atol=2e-2)
    np.testing.assert_allclose(a.t.numpy(), t / np.linalg.norm(t), atol=5e-2)


def test_triangulate_two_view_matches_jax():
    x0, x1, _, R, t, X = _two_view(4, noise=0.0, n_out=0)
    P0 = np.eye(3, 4, dtype=np.float32)
    P1 = np.c_[R, t].astype(np.float32)
    a = jtri.triangulate_two_view(jnp.asarray(P0), jnp.asarray(P1), jnp.asarray(x0), jnp.asarray(x1))
    b = ttri.triangulate_two_view(_t(P0), _t(P1), _t(x0), _t(x1))
    # inverse power iteration on a 4x4 in f32: 1e-3 of a 5 m depth
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-3, rtol=0)
    np.testing.assert_allclose(b.numpy(), X, atol=5e-2)


def test_triangulate_multiview_batched_matches_jax_per_feature():
    rng = np.random.default_rng(5)
    K, F = 5, 40
    Rs = Rsc.from_euler("xyz", rng.uniform(-5, 5, (K, 3)), degrees=True).as_matrix().astype(np.float32)
    ts = rng.uniform(-0.5, 0.5, (K, 3)).astype(np.float32)
    X = rng.uniform(-2, 2, (F, 3)) + np.array([0, 0, 6.0])
    Xc = np.einsum("kij,fj->fki", Rs, X) + ts[None]
    obs = (Xc[..., :2] / Xc[..., 2:]).astype(np.float32)
    valid = rng.random((F, K)) < 0.8
    valid[:, 0] = True
    pj, dj = jax.vmap(lambda o, v: jtri.triangulate_multiview(jnp.asarray(Rs), jnp.asarray(ts), o, v))(
        jnp.asarray(obs), jnp.asarray(valid))
    pt, dt_ = ttri.triangulate_multiview(_t(Rs)[None], _t(ts)[None], _t(obs), _t(valid))
    ok = valid.sum(1) >= 2
    np.testing.assert_allclose(pt.numpy()[ok], np.asarray(pj)[ok], atol=5e-3, rtol=0)
    np.testing.assert_allclose(dt_.numpy()[ok], np.asarray(dj)[ok], atol=5e-3, rtol=0)
    np.testing.assert_allclose(pt.numpy()[ok], X[ok], atol=5e-2)


def _hand_eye_pairs(seed, n_valid, excitation=0.2):
    rng = np.random.default_rng(seed)
    q_ic = Rsc.from_euler("xyz", rng.uniform(-60, 60, 3), degrees=True)
    q_imu = Rsc.from_rotvec(rng.normal(size=(24, 3)) * excitation)
    q_cam = q_ic.inv() * q_imu * q_ic
    wxyz = lambda r: np.roll(r.as_quat(), 1, axis=-1).astype(np.float32)
    valid = np.arange(24) < n_valid
    return wxyz(q_cam), wxyz(q_imu), valid, wxyz(q_ic)


@pytest.mark.parametrize("seed,n_valid,excitation,ok", [
    (0, 20, 0.2, True), (1, 24, 0.3, True), (2, 6, 0.2, False), (3, 20, 0.001, False)])
def test_calibrate_rotation_up_to_sign(seed, n_valid, excitation, ok):
    q_cam, q_imu, valid, q_ic = _hand_eye_pairs(seed, n_valid, excitation)
    q0 = np.array([1, 0, 0, 0], np.float32)
    a = jhe.calibrate_rotation(jnp.asarray(q_cam), jnp.asarray(q_imu), jnp.asarray(valid), jnp.asarray(q0))
    b = the.calibrate_rotation(_t(q_cam), _t(q_imu), _t(valid), _t(q0))
    assert bool(a.ok) == bool(b.ok) == ok
    np.testing.assert_allclose(float(b.sv2), float(a.sv2), atol=1e-4)
    if excitation > 0.01:  # with no excitation the null vector is free
        sign = np.sign(np.dot(np.asarray(a.q_ic), b.q_ic.numpy()))
        np.testing.assert_allclose(sign * b.q_ic.numpy(), np.asarray(a.q_ic), atol=1e-5)
        assert abs(np.dot(b.q_ic.numpy(), q_ic)) > 1 - 1e-4


def test_quat_left_right_layout_matches_jax():
    q = np.random.default_rng(6).normal(size=(7, 4)).astype(np.float32)
    np.testing.assert_array_equal(the._quat_L(_t(q)).numpy(), np.asarray(jhe._quat_L(jnp.asarray(q))))
    np.testing.assert_array_equal(the._quat_R(_t(q)).numpy(), np.asarray(jhe._quat_R(jnp.asarray(q))))
