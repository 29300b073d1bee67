"""The port's fundamental-matrix RANSAC and lidar depth association against
the JAX package on the CPU.

RANSAC is fed JAX's own hypothesis draws (`ransac._sample_indices` with
`PRNGKey(0)`, as the tracker calls it): inlier masks and counts must then be
identical, F within 2e-3 of its scale (the best model is one noisy 8-point
solve by inverse power iteration, which turns f32 rounding into up to 4e-4
of F's scale; measured). The port's own sampler (Gumbel top-k from a seeded
torch.Generator) is checked for what it promises instead: no error with
fewer than 8 valid points, valid points first, repeatable.

Depth association: the same features get a depth (mask identical) and the
depths agree within 1e-6 relative (XLA contracts the plane-intersection
multiply-adds into FMAs; measured ≤ 3 ulp)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from lvislam_tpu.core import lie as jlie
from lvislam_tpu.models.vio import feature_tracker as jft
from lvislam_tpu.ops import depth_assoc as jd
from lvislam_tpu.ops import ransac as jr
from lvislam_tpu_torch.models.vio import feature_tracker as tft
from lvislam_tpu_torch.ops import depth_assoc as td
from lvislam_tpu_torch.ops import ransac as tr

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _two_view(seed, n=120, n_out=25, noise=0.3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 3)) + np.array([0, 0, 5.0])
    R = Rsc.from_euler("xyz", [2, 5, 1], degrees=True).as_matrix()
    t = np.array([0.3, 0.05, 0.02])
    uv1 = X[:, :2] / X[:, 2:3] * 460.0 + [320, 240]
    X2 = X @ R.T + t
    uv2 = X2[:, :2] / X2[:, 2:3] * 460.0 + [320, 240]
    out = rng.choice(n, n_out, replace=False)
    uv2[out] += rng.uniform(-80, 80, size=(n_out, 2))
    uv2 += rng.normal(0, noise, uv2.shape)
    valid = rng.random(n) < 0.9
    return uv1.astype(np.float32), uv2.astype(np.float32), valid


@pytest.mark.parametrize("seed,n_hyp", [(0, 128), (1, 128), (2, 256)])
def test_fundamental_ransac_with_jax_draws(seed, n_hyp):
    uv1, uv2, valid = _two_view(seed)
    w = jnp.asarray(valid, jnp.float32)
    w = w / jnp.maximum(jnp.sum(w), 1.0)
    idx = np.asarray(jr._sample_indices(jax.random.PRNGKey(0), n_hyp, 8, len(valid), w))
    fj = jr.fundamental_ransac(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
                               threshold=1.0, n_hyp=n_hyp)
    ft = tr.fundamental_ransac(_t(uv1), _t(uv2), _t(valid), threshold=1.0, n_hyp=n_hyp,
                               idx=_t(idx).long())
    np.testing.assert_array_equal(ft.inliers.numpy(), np.asarray(fj.inliers))
    assert int(ft.n_inliers) == int(fj.n_inliers) > 60
    F = np.asarray(fj.F)
    np.testing.assert_allclose(ft.F.numpy(), F, atol=2e-3 * np.abs(F).max(), rtol=0)


def test_hypothesis_weights_match_jax():
    valid = np.random.default_rng(3).random(150) < 0.4
    w = jnp.asarray(valid, jnp.float32)
    np.testing.assert_array_equal(tr.hypothesis_weights(_t(valid)).numpy(),
                                  np.asarray(w / jnp.maximum(jnp.sum(w), 1.0)))


def test_min_eigvec_matches_jax():
    A = np.random.default_rng(4).normal(size=(64, 8, 9)).astype(np.float32)
    vj = np.asarray(jr._solve_min_eigvec(jnp.asarray(A)))
    vt = tr._solve_min_eigvec(_t(A)).numpy()
    np.testing.assert_allclose(np.abs(np.sum(vj * vt, axis=-1)), 1.0, atol=1e-5)


@pytest.mark.parametrize("n_valid", [0, 5, 150])
def test_port_sampler_never_fails(n_valid):
    valid = np.zeros(150, bool)
    valid[np.random.default_rng(n_valid).choice(150, n_valid, replace=False)] = True
    w = tr.hypothesis_weights(_t(valid))
    g = lambda: torch.Generator().manual_seed(0)
    idx = tr.sample_indices(w, 128, 8, g())
    assert idx.shape == (128, 8)
    assert torch.equal(idx, tr.sample_indices(w, 128, 8, g()))  # repeatable
    assert all(len(set(row)) == 8 for row in idx.tolist())  # no repeats
    # valid points are drawn first; the rest fill up in index order
    k = min(n_valid, 8)
    assert valid[idx[:, :k].numpy()].all()
    assert not valid[idx[:, k:].numpy()].any()
    res = tr.fundamental_ransac(_t(np.zeros((150, 2), np.float32)),
                                _t(np.zeros((150, 2), np.float32)), _t(valid), n_hyp=128)
    assert res.inliers.shape == (150,) and not bool((res.inliers & ~_t(valid)).any())


def test_port_sampler_draws_without_idx():
    uv1, uv2, valid = _two_view(5)
    res = tr.fundamental_ransac(_t(uv1), _t(uv2), _t(valid), threshold=1.0, n_hyp=128)
    again = tr.fundamental_ransac(_t(uv1), _t(uv2), _t(valid), threshold=1.0, n_hyp=128)
    assert torch.equal(res.inliers, again.inliers)  # the same mask draws the same hypotheses
    assert int(res.n_inliers) > 60


def _cloud(seed, P=20000):
    """A scene in the body frame (x forward): a slanted wall 8-14 m ahead,
    a floor 1.5 m below, and scattered clutter points."""
    rng = np.random.default_rng(seed)
    n_w, n_f = P // 2, P // 4
    y, z = rng.uniform(-8, 8, n_w), rng.uniform(-1.5, 3, n_w)
    wall = np.c_[11.0 + 0.2 * y, y, z]
    floor = np.c_[rng.uniform(2, 14, n_f), rng.uniform(-8, 8, n_f), np.full(n_f, -1.5)]
    clutter = np.c_[rng.uniform(2, 30, P - n_w - n_f), rng.uniform(-15, 15, (P - n_w - n_f, 2))]
    cloud = np.concatenate([wall, floor, clutter])[rng.permutation(P)].astype(np.float32)
    feats = rng.uniform(-0.6, 0.6, (150, 2)).astype(np.float32)
    return feats, rng.random(150) < 0.9, cloud, rng.random(P) < 0.95


def _assert_depths(got, ref):
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feature_depths(seed):
    feats, fv, cloud, cv = _cloud(seed)
    ref = np.asarray(jd.feature_depths(jnp.asarray(feats), jnp.asarray(fv),
                                       jnp.asarray(cloud), jnp.asarray(cv)))
    got = td.feature_depths(_t(feats), _t(fv), _t(cloud), _t(cv)).numpy()
    _assert_depths(got, ref)
    assert (got > 0).sum() > 30


def test_feature_depths_on_a_wall():
    """A wall at x = 10 m (body frame): every depth is 10 m, and the port
    gives exactly the features JAX gives a depth."""
    rng = np.random.default_rng(0)
    yz = rng.uniform(-4, 4, size=(4000, 2))
    cloud = np.concatenate([np.full((4000, 1), 10.0), yz], axis=1).astype(np.float32)
    feats = rng.uniform(-0.25, 0.25, size=(32, 2)).astype(np.float32)
    ref = np.asarray(jd.feature_depths(jnp.asarray(feats), jnp.ones(32, bool),
                                       jnp.asarray(cloud), jnp.ones(4000, bool)))
    got = td.feature_depths(_t(feats), torch.ones(32, dtype=torch.bool), _t(cloud),
                            torch.ones(4000, dtype=torch.bool)).numpy()
    _assert_depths(got, ref)
    assert (got > 0).sum() > 20
    np.testing.assert_allclose(got[got > 0], 10.0, atol=0.1)


def test_register_depth_matches_jax():
    feats, fv, cloud, cv = _cloud(3)
    trans = np.array([0.5, -0.2, 0.1], np.float32)
    quat = np.asarray(jlie.quat_normalize(jnp.array([0.98, 0.05, -0.1, 0.15])), np.float32)
    world = np.asarray(jlie.quat_rotate(jnp.asarray(quat)[None], jnp.asarray(cloud))) + trans
    ref = np.asarray(jft.register_depth(jnp.asarray(feats), jnp.asarray(fv),
                                        jnp.asarray(world), jnp.asarray(cv),
                                        jnp.asarray(trans), jnp.asarray(quat)))
    got = tft.register_depth(_t(feats), _t(fv), _t(world), _t(cv), _t(trans),
                             _t(quat)).numpy()
    # the cloud goes through one more rotation on each side: a bin can take
    # a neighbouring point, so only nearly all features must agree
    both = (got > 0) & (ref > 0)
    assert ((got > 0) == (ref > 0)).mean() >= 0.97 and both.sum() > 30
    np.testing.assert_allclose(got[both], ref[both], rtol=1e-4, atol=0)
