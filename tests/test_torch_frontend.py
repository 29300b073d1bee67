"""The port's LIO front end against the JAX package: projection + deskew,
LOAM features and voxel downsampling on synthetic scans.

Tolerances: masks, counts and indices exact; coordinates within 1e-5 m (the
deskew rotation differs by an ulp or two between the frameworks). Feature
extraction is fed the same projection on both sides, so its masks and
indices must agree exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from lvislam_tpu.models.lio import frontend as jfe, pipeline as jpl
from lvislam_tpu.ops import loam as jloam, pointcloud as jpc
from lvislam_tpu.utils import synthetic as jsyn
from lvislam_tpu_torch.models.lio import frontend as tfe, pipeline as tpl
from lvislam_tpu_torch.ops import loam as tloam, pointcloud as tpc

torch.set_num_threads(1)

N_SCAN, H, P, M = 4, 900, 4096, 64


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def packed_scans():
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
        out.append(jpl.pack_scan(cfg, scan, (it - ts).astype(np.float32),
                                 w.astype(np.float32), np.array(rpy, np.float32)))
    return out


def _unpack(buf, xp):
    """The `lio_full_step` unpacking, on either side."""
    if xp == "jax":
        packed = jnp.asarray(buf)
        pts = packed[: P * 6].reshape(6, P)
        imu = jax.lax.bitcast_convert_type(packed[P * 6: P * 6 + M * 8].reshape(M, 4, 2), jnp.float32)
        misc = jax.lax.bitcast_convert_type(packed[P * 6 + M * 8:].reshape(24, 2), jnp.float32)
        rv = pts[4].astype(jnp.int32)
        return jfe.project_scan(
            pts[0:3].astype(jnp.float32).T * jpl.POS_SCALE, pts[3].astype(jnp.float32),
            rv % 256, pts[5].astype(jnp.float32) * jpl.TIME_SCALE, rv >= 256,
            imu[:, 0], imu[:, 1:4], misc[0].astype(jnp.int32), misc[1:4], misc[4] > 0.5,
            n_scan=N_SCAN, horizon=H)
    packed = torch.from_numpy(buf)
    pts = packed[: P * 6].reshape(6, P)
    imu = packed[P * 6: P * 6 + M * 8].view(torch.float32).reshape(M, 4)
    misc = packed[P * 6 + M * 8:].view(torch.float32)
    rv = pts[4].to(torch.int32)
    return tfe.project_scan(
        pts[0:3].float().T * tpl.POS_SCALE, pts[3].float(), rv % 256,
        pts[5].float() * tpl.TIME_SCALE, rv >= 256, imu[:, 0], imu[:, 1:4],
        misc[0].to(torch.int32), misc[1:4], misc[4] > 0.5, n_scan=N_SCAN, horizon=H)


@pytest.mark.parametrize("i", [0, 1])
def test_project_scan_matches_jax(packed_scans, i):
    pj = _unpack(packed_scans[i], "jax")
    pt = _unpack(packed_scans[i], "torch")
    for name in ("valid", "point_col", "start_ring_index", "end_ring_index",
                 "imu_available", "num_valid"):
        a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name
    for name in ("xyz", "point_range", "intensity", "imu_rpy_init"):
        np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("i", [0, 1])
def test_extract_features_matches_jax(packed_scans, i):
    pj = _unpack(packed_scans[i], "jax")
    pt = tfe.ProjectionResult(*[_t(x) for x in pj])  # the same projection
    fj = jfe.extract_features(pj, max_corner=512, max_surf=2048)
    ft = tfe.extract_features(pt, max_corner=512, max_surf=2048)
    for name in ("corner_valid", "surf_valid", "num_corner", "num_surf"):
        np.testing.assert_array_equal(np.asarray(getattr(fj, name)),
                                      getattr(ft, name).numpy(), err_msg=name)
    for name in ("corner_xyz", "surf_xyz"):
        np.testing.assert_allclose(getattr(ft, name).numpy(), np.asarray(getattr(fj, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert int(ft.num_corner) > 20 and int(ft.num_surf) > 200


def test_loam_stages_match_jax(packed_scans):
    pj = _unpack(packed_scans[1], "jax")
    r, c, v = pj.point_range, pj.point_col, pj.valid
    curv_j = jloam.curvature(r, v)
    curv_t = tloam.curvature(_t(r), _t(v))
    np.testing.assert_allclose(curv_t.numpy(), np.asarray(curv_j), rtol=1e-5, atol=1e-4)
    occ_j = jloam.occlusion_mask(r, c, v)
    np.testing.assert_array_equal(np.asarray(occ_j), tloam.occlusion_mask(_t(r), _t(c), _t(v)).numpy())
    sp_j, ep_j = jloam.sector_bounds(pj.start_ring_index, pj.end_ring_index)
    sp_t, ep_t = tloam.sector_bounds(_t(pj.start_ring_index), _t(pj.end_ring_index))
    np.testing.assert_array_equal(np.asarray(sp_j), sp_t.numpy())
    np.testing.assert_array_equal(np.asarray(ep_j), ep_t.numpy())
    e_j = jloam.select_edges_fast(curv_j, c, occ_j, v, pj.start_ring_index, pj.end_ring_index, 1.0)
    e_t = tloam.select_edges_fast(_t(curv_j), _t(c), _t(occ_j), _t(v), _t(pj.start_ring_index),
                                  _t(pj.end_ring_index), 1.0)
    np.testing.assert_array_equal(np.asarray(e_j), e_t.numpy())


def test_livox_columns_and_compact_rings_match_jax():
    rng = np.random.default_rng(0)
    ring = rng.integers(0, 4, 3000).astype(np.int32)
    valid = rng.random(3000) > 0.1
    np.testing.assert_array_equal(np.asarray(jpc.livox_columns(jnp.asarray(ring), jnp.asarray(valid), 4)),
                                  tpc.livox_columns(_t(ring), _t(valid), 4).numpy())
    img = rng.random((4, 300)) > 0.3
    for a, b in zip(jpc.compact_rings(jnp.asarray(img), 300), tpc.compact_rings(_t(img), 300)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_project_compact_general_path_matches_jax():
    """Colliding (spherical-style) columns take the scatter-min + compaction
    path."""
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-30, 30, (2000, 3)).astype(np.float32)
    ring = rng.integers(0, 4, 2000).astype(np.int32)
    valid = rng.random(2000) > 0.05
    cols = rng.integers(0, 600, 2000).astype(np.int32)
    inten = rng.random(2000).astype(np.float32)
    oj = jpc.project_compact(jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(ring),
                             jnp.asarray(valid), 4, 600, 1.0, 25.0, columns=jnp.asarray(cols))
    ot = tpc.project_compact(_t(xyz), _t(inten), _t(ring), _t(valid), 4, 600, 1.0, 25.0,
                             columns=_t(cols))
    fv = np.asarray(oj[4])
    np.testing.assert_array_equal(fv, ot[4].numpy())
    for k in (3, 5, 6, 7):
        np.testing.assert_array_equal(np.asarray(oj[k]), ot[k].numpy())
    for k in (0, 1, 2):
        np.testing.assert_allclose(ot[k].numpy()[fv], np.asarray(oj[k])[fv], atol=1e-5)


@pytest.mark.parametrize("n,center", [(1500, False), (6000, False), (6000, True)],
                         ids=["dense", "sort", "sort_center"])
def test_voxel_downsample_matches_jax(n, center):
    rng = np.random.default_rng(n)
    # points on a 1 cm lattice offset by a quarter cell: voxel membership
    # cannot hinge on the last bit of a coordinate
    xyz = ((rng.integers(-300, 300, (n, 3)) + 0.25) * 0.01).astype(np.float32)
    valid = rng.random(n) > 0.1
    inten = rng.random(n).astype(np.float32)
    cap = 1000 if n <= 4096 else 1200
    c = jnp.array([0.5, -0.5, 0.2]) if center else None
    oj = jpc.voxel_downsample(jnp.asarray(xyz), jnp.asarray(valid), 0.4, cap,
                              jnp.asarray(inten), center=c)
    ot = tpc.voxel_downsample(_t(xyz), _t(valid), 0.4, cap, _t(inten),
                              center=_t(c) if center else None)
    np.testing.assert_array_equal(np.asarray(oj[1]), ot[1].numpy())
    assert int(ot[1].sum()) == cap  # capacity overflow exercised
    np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=1e-5)
    np.testing.assert_allclose(ot[2].numpy(), np.asarray(oj[2]), atol=1e-5)
