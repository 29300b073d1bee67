"""The port's scan-to-map registration and kernel K2's plain version against
the JAX package's XLA path.

Tolerances: K2's partials H and g within 2e-4 of their scale, on the case
and seed that `tests/test_pallas_gn.py` holds the TPU kernel to that bar
with (the final sums run in another order); the residual count exactly. The
surface plane fit on thin 5-point neighbourhoods is ill-conditioned in f32
and XLA on the CPU contracts multiply-adds into FMAs where PyTorch does not,
so on other seeds both the port and the TPU kernel in interpret mode move
past 2e-4 of the XLA path's sums (the TPU kernel by 4.5e-3 at seed 1). The solved pose within 2e-3
(`tests/test_pallas_gn.py`'s path-vs-path bar, far below one GN step's
convergence threshold)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.ops import scan2map as js2m, voxel_hash as jvh
from test_pallas_gn import _make_case as _pallas_gn_case, _xla_partials
from lvislam_tpu_torch.core import lie as tlie
from lvislam_tpu_torch.ops import gn_partials as gnp
from lvislam_tpu_torch.ops import scan2map as ts2m, voxel_hash as tvh

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", ["corner", "surf"])
def test_gn_partials_plain_matches_jax_xla_path(kind):
    """tests/test_pallas_gn.py's case and seed: line-like, plane-like,
    scattered and missing-neighbour neighbourhoods, so every gate fires both
    ways."""
    case = _pallas_gn_case(kind, np.random.default_rng(0))
    H0, g0, n0 = (np.asarray(a) for a in _xla_partials(kind, *case))
    pl_, valid, nbrs, has, x6 = (_t(a) for a in case[1:])
    par = gnp.pack_pose(tlie.x6_rotation(x6), x6[3:6], ts2m._euler_jac_mats(x6))
    H1, g1, n1 = gnp.gn_partials(gnp.pack_pts(pl_, valid), gnp.pack_nbrs(nbrs, has), par, kind)
    assert int(n1) == int(n0)
    np.testing.assert_allclose(H1.numpy(), H0, atol=2e-4 * np.abs(H0).max(), rtol=2e-4)
    np.testing.assert_allclose(g1.numpy(), g0, atol=2e-4 * np.abs(g0).max(), rtol=2e-4)
    assert gnp.LAUNCHES == 0


def test_euler_jacobians_and_solve_match_jax():
    rng = np.random.default_rng(1)
    x6 = rng.uniform(-0.6, 0.6, 6).astype(np.float32)
    np.testing.assert_allclose(ts2m._euler_jac_mats(_t(x6)).numpy(),
                               np.asarray(js2m._euler_jac_mats(jnp.asarray(x6))),
                               atol=1e-6)
    A = rng.normal(size=(40, 6)).astype(np.float32)
    H = A.T @ A * 10.0
    g = rng.normal(size=6).astype(np.float32)
    outj = js2m.gn_solve(jnp.asarray(x6), jnp.asarray(H), jnp.asarray(g),
                         jnp.int32(60), jnp.array(True), jnp.eye(6),
                         jnp.array(False), eigen_thresh=50.0)
    outt = ts2m.gn_solve(_t(x6), _t(H), _t(g), torch.tensor(60, dtype=torch.int32),
                         True, torch.eye(6), torch.tensor(False), eigen_thresh=50.0)
    np.testing.assert_allclose(outt[0].numpy(), np.asarray(outj[0]), atol=1e-5)
    np.testing.assert_allclose(outt[2].numpy(), np.asarray(outj[2]), atol=1e-5)
    assert bool(outt[3]) == bool(outj[3]) and bool(outt[1]) == bool(outj[1])


@pytest.mark.parametrize("k", [1, 5])
def test_exact_knn_matches_jax(k):
    rng = np.random.default_rng(2)
    ref = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    rv = rng.random(3000) > 0.1
    q = rng.uniform(-5, 5, (200, 3)).astype(np.float32)
    ij, dj = js2m.knn(jnp.asarray(q), jnp.ones(200, bool), jnp.asarray(ref), jnp.asarray(rv), k)
    it, dt = ts2m.knn(_t(q), torch.ones(200, dtype=torch.bool), _t(ref), _t(rv), k)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), rtol=1e-4, atol=1e-5)


def _registration_problem():
    """tests/test_pallas_gn.py's box world: three planes and an edge seen
    from a perturbed pose."""
    rng = np.random.default_rng(0)
    n = 4096
    g = rng.uniform(-8, 8, (n, 2)).astype(np.float32)
    planes = [np.stack([g[:, 0], g[:, 1], np.zeros(n)], -1),
              np.stack([g[:, 0], np.full(n, -8.0), g[:, 1] * 0.3 + 2], -1),
              np.stack([np.full(n, 8.0), g[:, 0], g[:, 1] * 0.3 + 2], -1)]
    edge_t = rng.uniform(-8, 8, n).astype(np.float32)
    map_surf = np.concatenate(planes).astype(np.float32)
    map_corner = np.stack([edge_t, np.full(n, -8.0), np.full(n, 5.0)], -1).astype(np.float32)
    ci = rng.choice(n, 256, replace=False)
    si = rng.choice(len(map_surf), 1024, replace=False)
    x6_true = np.array([0.02, -0.015, 0.03, 0.2, -0.15, 0.1], np.float32)
    Rm = np.asarray(js2m.lie.ypr_to_matrix(
        jnp.array([x6_true[2], x6_true[1], x6_true[0]]) * (180.0 / np.pi)))
    corner_scan = ((map_corner[ci] - x6_true[3:6]) @ Rm).astype(np.float32)
    surf_scan = ((map_surf[si] - x6_true[3:6]) @ Rm).astype(np.float32)
    return map_corner, map_surf, corner_scan, surf_scan, x6_true


FLAG_SETS = [
    dict(),
    dict(nn_refresh_every=2, use_pallas=True, gather_once=True),
    dict(nn_refresh_every=2, use_pallas=True, gather_once=True, use_pallas_gn=True),
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=["xla", "knn_gather_once", "knn_and_gn"])
def test_scan_to_map_hashed_matches_jax(flags):
    map_corner, map_surf, corner_scan, surf_scan, x6_true = _registration_problem()
    hj_c = jvh.build(jnp.asarray(map_corner), jnp.ones(len(map_corner), bool), 1.0, 1 << 12, 16)
    hj_s = jvh.build(jnp.asarray(map_surf), jnp.ones(len(map_surf), bool), 1.0, 1 << 13, 16)
    ht_c = tvh.build(_t(map_corner), torch.ones(len(map_corner), dtype=torch.bool), 1.0, 1 << 12, 16)
    ht_s = tvh.build(_t(map_surf), torch.ones(len(map_surf), dtype=torch.bool), 1.0, 1 << 13, 16)
    kw = dict(max_iters=12, eigen_thresh=25.0, **flags)
    jkw = dict(kw, pallas_interpret=True) if flags else kw
    stj = js2m.scan_to_map_hashed(
        jnp.zeros(6), jnp.asarray(corner_scan), jnp.ones(256, bool),
        jnp.asarray(surf_scan), jnp.ones(1024, bool), jnp.asarray(map_corner),
        jnp.asarray(map_surf), hj_c, hj_s, **jkw)
    stt = ts2m.scan_to_map_hashed(
        torch.zeros(6), _t(corner_scan), torch.ones(256, dtype=torch.bool),
        _t(surf_scan), torch.ones(1024, dtype=torch.bool), _t(map_corner),
        _t(map_surf), ht_c, ht_s, **kw)
    np.testing.assert_allclose(stt.x6.numpy(), np.asarray(stj.x6), atol=2e-3)
    np.testing.assert_allclose(stt.x6.numpy(), x6_true, atol=0.08)
    assert abs(int(stt.num_residuals) - int(stj.num_residuals)) <= 0.01 * int(stj.num_residuals)
