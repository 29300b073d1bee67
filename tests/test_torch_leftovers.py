"""The functions of already-ported JAX modules that the port lacked until now,
each against its JAX counterpart: `loam.select_edges` (the exact greedy
LOAM pick, and `frontend.extract_features(exact_selection=True)` /
`LioConfig(exact_loam_selection=True)` through it), `scan2map.{scan_to_map,
corner_coeffs, surf_coeffs}`, `pointcloud.{spherical_columns,
project_to_range_image, gather_compacted, remove_ego_points}`,
`posegraph.{dense_information, dense_marginal_covariance}` and
`synthetic.{circle_trajectory, landmark_points}`.

Tolerances: masks, indices and counts exact; coordinates as stated a test."""

import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from lvislam_tpu.models.lio import frontend as jfe, pipeline as jpl  # noqa: E402
from lvislam_tpu.ops import loam as jloam, pointcloud as jpc  # noqa: E402
from lvislam_tpu.ops import posegraph as jpg, scan2map as js2m  # noqa: E402
from lvislam_tpu.utils import synthetic as jsyn  # noqa: E402
from lvislam_tpu_torch.models.lio import frontend as tfe, pipeline as tpl  # noqa: E402
from lvislam_tpu_torch.ops import loam as tloam, pointcloud as tpc  # noqa: E402
from lvislam_tpu_torch.ops import posegraph as tpg, scan2map as ts2m  # noqa: E402
from lvislam_tpu_torch.utils import convert  # noqa: E402
from lvislam_tpu_torch.utils import synthetic as tsyn  # noqa: E402
from test_torch_frontend import H, N_SCAN, P, _unpack  # noqa: E402
from test_torch_geometry import _loop_graph  # noqa: E402
from test_torch_scan2map import _registration_problem  # noqa: E402

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def projections():
    """`project_scan` (JAX) of two synthetic scans packed as the LIO step
    packs them."""
    world = jsyn.default_world(seed=0)
    traj = jsyn.figure8_trajectory(scale=3.0, period=30.0)
    cfg = jpl.LioConfig(n_scan=N_SCAN, horizon=H, point_capacity=P)
    out = []
    for ts in (0.0, 0.7):
        scan = jsyn.simulate_lidar_scan(world, traj, ts, n_scan=N_SCAN, horizon=H,
                                        sweep_time=0.1)
        it = np.arange(ts - 0.005, ts + 0.11, 1 / 200.0)
        w, _ = traj.imu(it)
        _, R = traj.pose(np.array([ts]))
        rpy = Rsc.from_matrix(R[0]).as_euler("ZYX")[::-1]
        buf = jpl.pack_scan(cfg, scan, (it - ts).astype(np.float32), w.astype(np.float32),
                            np.array(rpy, np.float32))
        out.append(_unpack(buf, "jax"))
    return out


# ------------------------------------------------------------------ loam


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("thr, per_sector", [(1.0, 40), (0.1, 40), (0.1, 3)])
def test_select_edges_mask_equals_jax(projections, i, thr, per_sector):
    """The greedy pick on the same curvature, occlusion mask and sectors:
    the edge mask equals JAX's bit for bit (the rounds, the suppression
    reach, the ties to the higher index)."""
    pj = projections[i]
    r, c, v = pj.point_range, pj.point_col, pj.valid
    curv = jloam.curvature(r, v)
    occ = jloam.occlusion_mask(r, c, v)
    ej = jloam.select_edges(curv, c, occ, v, pj.start_ring_index, pj.end_ring_index, thr,
                            max_edges_per_sector=per_sector)
    et = tloam.select_edges(_t(curv), _t(c), _t(occ), _t(v), _t(pj.start_ring_index),
                            _t(pj.end_ring_index), thr, max_edges_per_sector=per_sector)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    assert int(et.sum()) > 10


def test_select_edges_ties_go_to_the_higher_index():
    """Equal curvatures in one sector: the pick order (and so the
    suppression) follows JAX's highest-index rule."""
    P_ = 64
    curv = np.zeros(P_, np.float32)
    curv[[10, 14, 20, 21, 30, 41]] = 5.0
    curv[[12, 33]] = 7.0
    col = np.arange(P_, dtype=np.int32)
    col[40:] += 30  # a column gap: suppression does not reach across it
    valid = np.ones(P_, bool)
    occ = np.zeros(P_, bool)
    start, end = np.array([2], np.int32), np.array([61], np.int32)
    ej = jloam.select_edges(jnp.asarray(curv), jnp.asarray(col), jnp.asarray(occ),
                            jnp.asarray(valid), jnp.asarray(start), jnp.asarray(end), 1.0,
                            n_sectors=2)
    et = tloam.select_edges(_t(curv), _t(col), _t(occ), _t(valid), _t(start), _t(end), 1.0,
                            n_sectors=2)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


@pytest.mark.parametrize("i", [0, 1])
def test_extract_features_exact_selection_equals_jax(projections, i):
    """`extract_features(exact_selection=True)` on the same projection:
    masks and counts exact, coordinates within 1e-5 m."""
    pj = projections[i]
    pt = tfe.ProjectionResult(*[_t(x) for x in pj])
    fj = jfe.extract_features(pj, max_corner=512, max_surf=2048, exact_selection=True)
    ft = tfe.extract_features(pt, max_corner=512, max_surf=2048, exact_selection=True)
    for name in ("corner_valid", "surf_valid", "num_corner", "num_surf"):
        np.testing.assert_array_equal(np.asarray(getattr(fj, name)),
                                      getattr(ft, name).numpy(), err_msg=name)
    for name in ("corner_xyz", "surf_xyz"):
        np.testing.assert_allclose(getattr(ft, name).numpy(), np.asarray(getattr(fj, name)),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_exact_loam_selection_config_runs():
    """`LioConfig(exact_loam_selection=True)` no longer raises: a short LIO
    replay on the CPU with the exact pick: finite poses, a keyframe."""
    caps = tpl.mapping.LioCaps(max_keyframes=8, kf_corner=128, kf_surf=512, sel_keyframes=4,
                               map_corner=1024, map_surf=4096, scan_corner=256,
                               scan_surf=1024, max_loops=2, max_gps=2, loop_submap=512,
                               icp_iters=2)
    cfg = tpl.LioConfig(n_scan=4, horizon=900, point_capacity=4096, caps=caps,
                        exact_loam_selection=True)
    pipe = tpl.LioPipeline(cfg, device="cpu")
    world = tsyn.default_world(seed=0)
    traj = tsyn.figure8_trajectory(scale=3.0, period=30.0)
    for k in range(3):
        ts = 0.05 + 0.1 * k
        scan = tsyn.simulate_lidar_scan(world, traj, ts, n_scan=4, horizon=900, sweep_time=0.1)
        it = np.arange(ts - 0.005, ts + 0.11, 1 / 200.0)
        w, _ = traj.imu(it)
        _, R = traj.pose(np.array([ts]))
        rpy = np.array(Rsc.from_matrix(R[0]).as_euler("ZYX")[::-1], np.float32)
        pipe.process_scan(scan, (it - ts).astype(np.float32), w.astype(np.float32), rpy)
    assert np.isfinite(pipe.state.x6.numpy()).all()
    assert int(pipe.state.kf_count) >= 1


# --------------------------------------------------------------- scan2map


def test_scan_to_map_equals_jax():
    """The brute-force registration of `tests/test_scan2map.py`'s kind on
    `test_torch_scan2map`'s box world: pose within 2e-3 of JAX's and 0.08 of
    the truth; residual counts within 1%."""
    map_corner, map_surf, corner_scan, surf_scan, x6_true = _registration_problem()
    args = (corner_scan, np.ones(256, bool), surf_scan, np.ones(1024, bool),
            map_corner, np.ones(len(map_corner), bool), map_surf, np.ones(len(map_surf), bool))
    stj = js2m.scan_to_map(jnp.zeros(6), *map(jnp.asarray, args), max_iters=12,
                           eigen_thresh=25.0)
    stt = ts2m.scan_to_map(torch.zeros(6), *map(_t, args), max_iters=12, eigen_thresh=25.0)
    np.testing.assert_allclose(stt.x6.numpy(), np.asarray(stj.x6), atol=2e-3)
    np.testing.assert_allclose(stt.x6.numpy(), x6_true, atol=0.08)
    assert int(stt.it) == int(stj.it) and bool(stt.converged) == bool(stj.converged)
    assert abs(int(stt.num_residuals) - int(stj.num_residuals)) <= 0.01 * int(stj.num_residuals)


def test_corner_and_surf_coeffs_equal_jax():
    """One correspondence step: the same kNN rows (some marked missing), the
    coefficient masks exact, normals and offsets within 1e-3 (a line's
    direction is the top eigenvector of a nearly rank-one 3x3, found in
    closed form: float32 rounding moves it by a few 1e-4)."""
    map_corner, map_surf, corner_scan, surf_scan, x6_true = _registration_problem()
    rng = np.random.default_rng(5)
    for pts, mp, fn in ((corner_scan, map_corner, "corner"), (surf_scan, map_surf, "surf")):
        w = (pts + x6_true[3:6] * 0.9).astype(np.float32)
        idx, d = js2m.knn(jnp.asarray(w), jnp.ones(len(w), bool), jnp.asarray(mp),
                          jnp.ones(len(mp), bool), 5)
        idx = np.asarray(idx).copy()
        idx[rng.random(idx.shape) < 0.02] = -1
        valid = rng.random(len(w)) > 0.05
        if fn == "corner":
            cj = js2m.corner_coeffs(jnp.asarray(w), jnp.asarray(valid), jnp.asarray(mp),
                                    jnp.asarray(idx), d)
            ct = ts2m.corner_coeffs(_t(w), _t(valid), _t(mp), _t(idx), _t(d))
        else:
            cj = js2m.surf_coeffs(jnp.asarray(w), jnp.asarray(pts), jnp.asarray(valid),
                                  jnp.asarray(mp), jnp.asarray(idx), d)
            ct = ts2m.surf_coeffs(_t(w), _t(pts), _t(valid), _t(mp), _t(idx), _t(d))
        np.testing.assert_array_equal(ct.valid.numpy(), np.asarray(cj.valid), err_msg=fn)
        assert int(ct.valid.sum()) > 50
        np.testing.assert_allclose(ct.normal.numpy(), np.asarray(cj.normal), atol=1e-3)
        np.testing.assert_allclose(ct.offset.numpy(), np.asarray(cj.offset), atol=1e-3)


# ------------------------------------------------------------- pointcloud


def test_spherical_columns_and_range_image_equal_jax():
    """Azimuth columns (round half to even) and the first-wins range image
    with them, on a cloud with colliding cells and exact half-step
    azimuths: indices exact, values within 1e-5."""
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-30, 30, (3000, 3)).astype(np.float32)
    az = np.deg2rad(np.array([90.0, 90.2, 90.3, 0.0, 180.0, -90.1]))
    xyz[:6, 0], xyz[:6, 1] = (5 * np.sin(az)).astype(np.float32), (5 * np.cos(az)).astype(np.float32)
    ring = rng.integers(0, 4, 3000).astype(np.int32)
    valid = rng.random(3000) > 0.05
    inten = rng.random(3000).astype(np.float32)
    for hs in (1800, 900):
        cj = jpc.spherical_columns(jnp.asarray(xyz), hs)
        ct = tpc.spherical_columns(_t(xyz), hs)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        for cols in (cj, None):
            oj = jpc.project_to_range_image(jnp.asarray(xyz), jnp.asarray(inten),
                                            jnp.asarray(ring), jnp.asarray(valid), 4, hs,
                                            1.0, 40.0, columns=cols, downsample_rate=1)
            ot = tpc.project_to_range_image(_t(xyz), _t(inten), _t(ring), _t(valid), 4, hs,
                                            1.0, 40.0, columns=None if cols is None else _t(cols))
            np.testing.assert_array_equal(ot[3].numpy(), np.asarray(oj[3]))
            np.testing.assert_array_equal(ot[4].numpy(), np.asarray(oj[4]))
            for k in (0, 1, 2):
                np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=1e-5, rtol=0)
    oj = jpc.project_to_range_image(jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(ring),
                                    jnp.asarray(valid), 4, 900, 1.0, 40.0, downsample_rate=2)
    ot = tpc.project_to_range_image(_t(xyz), _t(inten), _t(ring), _t(valid), 4, 900, 1.0, 40.0,
                                    downsample_rate=2)
    np.testing.assert_array_equal(ot[4].numpy(), np.asarray(oj[4]))


def test_gather_compacted_and_remove_ego_equal_jax():
    rng = np.random.default_rng(2)
    img = rng.random((4, 300)) > 0.3
    order_j, counts_j, _, _ = jpc.compact_rings(jnp.asarray(img), 300)
    order_t, counts_t, _, _ = tpc.compact_rings(_t(img), 300)
    for im in (rng.random((4, 300)).astype(np.float32),
               rng.random((4, 300, 3)).astype(np.float32)):
        oj, vj = jpc.gather_compacted(order_j, counts_j, jnp.asarray(im))
        ot, vt = tpc.gather_compacted(order_t, counts_t, _t(im))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    xyz = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    valid = rng.random(500) > 0.1
    np.testing.assert_array_equal(
        tpc.remove_ego_points(_t(xyz), _t(valid), 2.0).numpy(),
        np.asarray(jpc.remove_ego_points(jnp.asarray(xyz), jnp.asarray(valid), 2.0)))


# -------------------------------------------------------------- posegraph


def test_dense_information_and_marginal_equal_jax():
    """The exact dense information matrix and a node's marginal covariance
    of `test_torch_geometry`'s loop graph (a GPS factor on node 5, the
    carried JAX graph as input): within 1e-4 of JAX's relative to their
    largest entry (float32 Jacobians, float64 assembly)."""
    gj = jpg.optimize(_loop_graph(jpg), gn_iters=3, pcg_iters=48)
    gt = convert.posegraph_from_jax(gj, device="cpu")
    Hj, Ht = jpg.dense_information(gj), tpg.dense_information(gt)
    assert Ht.dtype == np.float64 and Ht.shape == Hj.shape
    np.testing.assert_allclose(Ht, Hj, atol=1e-4 * np.abs(Hj).max(), rtol=0)
    for node in (0, 5, 11):
        cj = jpg.dense_marginal_covariance(gj, node)
        ct = tpg.dense_marginal_covariance(gt, node)
        np.testing.assert_allclose(ct, cj, atol=1e-4 * np.abs(cj).max(), rtol=0)


# -------------------------------------------------------------- synthetic


def test_circle_trajectory_and_landmarks_equal_jax():
    t = np.linspace(0, 20, 401)
    for kw in ({}, dict(radius=5.0, period=12.0, z_amp=0.3)):
        a, b = jsyn.circle_trajectory(**kw), tsyn.circle_trajectory(**kw)
        for x, y in zip(a.pose(t), b.pose(t)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a.imu(t[1:-1]), b.imu(t[1:-1])):
            np.testing.assert_array_equal(x, y)
        p0, _ = b.pose(np.array([1.3]))
        p1, _ = b.pose(np.array([1.3 + kw.get("period", 8.0)]))
        np.testing.assert_allclose(p1, p0, atol=1e-9)  # the revisit: same pose a period on
    for seed, n in ((0, 500), (3, 37)):
        np.testing.assert_array_equal(
            tsyn.landmark_points(tsyn.default_world(seed=seed), n, seed),
            jsyn.landmark_points(jsyn.default_world(seed=seed), n, seed))
