"""The port's checkpoint and map export (``lvislam_tpu_torch.utils.checkpoint``)
against the JAX package's ``lvislam_tpu.utils.checkpoint``: the PCD and TUM
files byte for byte, ``save_map_service`` from one JAX keyframe map carried
across by ``utils/convert.py`` (the same files, bytes equal; world points
from the JAX and the port rotation may differ in f32 rounding, so the map
clouds are compared as numbers within 1e-5 m where their text differs),
and ``save_state`` / ``load_state`` round trips."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvislam_tpu.models.lio import mapping as jmapping
from lvislam_tpu.utils import checkpoint as jck
from lvislam_tpu_torch.models.lio import mapping as tmapping
from lvislam_tpu_torch.models.vio import estimator, feature_manager
from lvislam_tpu_torch.models.vio import feature_tracker as ft
from lvislam_tpu_torch.utils import checkpoint as tck
from lvislam_tpu_torch.utils import convert

torch.set_num_threads(1)

MAP_TOL_M = 1e-5


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("with_intensity", [False, True])
def test_write_pcd_bytes_equal_jax(tmp_path, with_intensity):
    rng = np.random.default_rng(0)
    xyz = (rng.normal(size=(57, 3)) * 20).astype(np.float32)
    inten = rng.random(57) * 255 if with_intensity else None
    tck.write_pcd(str(tmp_path / "t.pcd"), xyz, inten)
    jck.write_pcd(str(tmp_path / "j.pcd"), xyz, inten)
    assert read(tmp_path / "t.pcd") == read(tmp_path / "j.pcd")


def test_write_pcd_empty_cloud_equal_jax(tmp_path):
    tck.write_pcd(str(tmp_path / "t.pcd"), np.zeros((0, 3), np.float32))
    jck.write_pcd(str(tmp_path / "j.pcd"), np.zeros((0, 3), np.float32))
    assert read(tmp_path / "t.pcd") == read(tmp_path / "j.pcd")


def test_tum_text_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    ts = np.cumsum(rng.random(12)) + 100.0
    p = rng.normal(size=(12, 3))
    q = rng.normal(size=(12, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tck.save_trajectory_tum(str(tmp_path / "t.tum"), ts, p, q)
    jck.save_trajectory_tum(str(tmp_path / "j.tum"), ts, p, q)
    assert read(tmp_path / "t.tum") == read(tmp_path / "j.tum")


CAPS = dict(max_keyframes=8, kf_corner=64, kf_surf=128, sel_keyframes=4, map_corner=256,
            map_surf=512, scan_corner=32, scan_surf=64, max_loops=2, max_gps=2,
            loop_submap=128, icp_iters=2)


def jax_keyframe_map(n_kf=5, seed=3):
    """A JAX `LioMapState` holding `n_kf` keyframes of random clouds at
    random poses (half of each cloud's slots valid)."""
    rng = np.random.default_rng(seed)
    caps = jmapping.LioCaps(**CAPS)
    st = jmapping.lio_init(caps)
    K = caps.max_keyframes
    q = rng.normal(size=(K, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    f = lambda a: jnp.asarray(np.asarray(a, np.float32))
    return st._replace(
        kf_count=jnp.int32(n_kf), kf_trans=f(rng.normal(size=(K, 3)) * 5),
        kf_quat=f(q), kf_time=f(np.arange(K) * 0.5 + 10.0),
        kf_corner=f(rng.normal(size=(K, caps.kf_corner, 3)) * 8),
        kf_corner_valid=jnp.asarray(rng.random((K, caps.kf_corner)) > 0.5),
        kf_surf=f(rng.normal(size=(K, caps.kf_surf, 3)) * 8),
        kf_surf_valid=jnp.asarray(rng.random((K, caps.kf_surf)) > 0.5),
    )


def pcd_points(path):
    with open(path) as f:
        lines = f.read().splitlines()
    head = lines[:11]
    return head, np.array([[float(v) for v in ln.split()] for ln in lines[11:]]).reshape(-1, 3)


@pytest.mark.parametrize("resolution", [0.0, 2.0])
def test_save_map_service_equals_jax(tmp_path, resolution):
    jst = jax_keyframe_map()
    tst = convert.state_from_jax(jst, device="cpu")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jsum = jck.save_map_service(jst, str(jdir), resolution)
    tsum = tck.save_map_service(tst, str(tdir), resolution)
    assert tsum == jsum and tsum["n_keyframes"] == 5 and tsum["n_corner"] > 0
    port_files = sorted(os.listdir(tdir))
    assert port_files == sorted(os.listdir(jdir)) == [
        "CornerMap.pcd", "GlobalMap.pcd", "GlobalMap_topdown.ppm", "SurfMap.pcd",
        "trajectory.pcd", "transformations.txt", "viewer.html"]
    for name in ("trajectory.pcd", "transformations.txt"):
        assert read(tdir / name) == read(jdir / name), name
    same_map = read(tdir / "GlobalMap.pcd") == read(jdir / "GlobalMap.pcd")
    for name in ("CornerMap.pcd", "SurfMap.pcd", "GlobalMap.pcd"):
        if read(tdir / name) == read(jdir / name):
            continue
        (th, tp), (jh, jp) = pcd_points(tdir / name), pcd_points(jdir / name)
        assert th == jh and tp.shape == jp.shape, name
        np.testing.assert_allclose(tp, jp, atol=MAP_TOL_M, rtol=0, err_msg=name)
    # the viewer artifacts are drawn from the same map: byte-equal where the
    # map's text is, else the same size and header
    for name in ("GlobalMap_topdown.ppm", "viewer.html"):
        t_b, j_b = (tdir / name).read_bytes(), (jdir / name).read_bytes()
        if same_map:
            assert t_b == j_b, name
        else:
            assert t_b[:20] == j_b[:20], name


def test_global_map_points_empty_map():
    st = tmapping.lio_init(tmapping.LioCaps(**CAPS), device="cpu")
    corner, surf = tck.global_map_points(st)
    assert corner.shape == surf.shape == (0, 3)


def assert_trees_equal(a, b):
    fa, fb = tck._flatten(a), tck._flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_state_round_trip_lio_map(tmp_path):
    st = convert.state_from_jax(jax_keyframe_map(), device="cpu")
    path = str(tmp_path / "lio.pt")
    tck.save_state(path, st)
    template = tmapping.lio_init(tmapping.LioCaps(**CAPS), device="cpu")
    back = tck.load_state(path, template, device="cpu")
    assert type(back) is type(st) and type(back.graph) is type(st.graph)
    assert_trees_equal(back, st)


def test_state_round_trip_tuple_fields(tmp_path):
    """States with tuple fields: the VIO state's raw IMU buffers and the
    tracker's pyramid."""
    caps = feature_manager.VioCaps(window=3, max_features=16, imu_buf=8, frame_features=8)
    vio = estimator.vio_init(caps, estimator.VioParams(), device="cpu")
    vio = vio._replace(imu_bufs=tuple(torch.rand_like(b) for b in vio.imu_bufs))
    tr = ft.tracker_init(24, 32, ft.TrackerParams(max_cnt=8, klt_levels=2), device="cpu")
    tr = tr._replace(prev_pyr=tuple(torch.rand_like(p) for p in tr.prev_pyr))
    for name, st in (("vio", vio), ("tracker", tr)):
        path = str(tmp_path / f"{name}.pt")
        tck.save_state(path, st)
        assert_trees_equal(tck.load_state(path, st, device="cpu"), st)


def test_load_state_checks_shapes_and_device(tmp_path):
    st = tmapping.lio_init(tmapping.LioCaps(**CAPS), device="cpu")
    path = str(tmp_path / "lio.pt")
    tck.save_state(path, st)
    other = tmapping.lio_init(tmapping.LioCaps(**dict(CAPS, max_keyframes=4)), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tck.load_state(path, other, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tck.load_state(path, st)
