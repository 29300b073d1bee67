"""The ported LIO slice as a whole against the JAX package, plus the port's
import and device contracts.

On tolerances for whole-step comparisons: the scan-to-map plane fits run in
f32 on nearly collinear neighbourhoods, where a one-ulp change of an input
moves the fitted normal by 1e-4..1e-1 (measured against a float64 fit), and
XLA on the CPU contracts multiply-adds into FMAs where PyTorch does not. So
no second implementation reproduces the JAX trajectory bit for bit: the JAX
replay itself, fed a gyro stream changed by one ulp, moves by 11.4 mm and
1.9 mrad within 10 scans (small config below). The replay test holds the
port to the JAX replay within 25 mm and 2 mrad per scan with the same
keyframe count, and to its ATE within 5 mm; a single map step from a shared
state within 1 cm and 2 mrad."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsc

from lvislam_tpu.models.lio import frontend as jfe, mapping as jmap, pipeline as jpl
from lvislam_tpu.utils import metrics as jmetrics, synthetic as jsyn
from lvislam_tpu_torch.models.lio import frontend as tfe, mapping as tmap, pipeline as tpl
from lvislam_tpu_torch.utils import convert, metrics as tmetrics, synthetic as tsyn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_lio_integration.py's small configuration
SMALL_CAPS = jmap.LioCaps(
    max_keyframes=64, kf_corner=256, kf_surf=1024, sel_keyframes=16,
    map_corner=4096, map_surf=16384, scan_corner=512, scan_surf=2048,
    max_loops=8, max_gps=8, loop_submap=4096, icp_iters=10,
)
SMALL_PARAMS = jmap.LioParams(
    surroundingKeyframeSearchRadius=50.0, keyframeAddingDistThreshold=0.3,
    keyframeAddingAngleThreshold=0.1, livox_keyframe_interval=0.5,
    degeneracyEigenThreshold=25.0,
)
JCFG = jpl.LioConfig(n_scan=4, horizon=900, point_capacity=4096, caps=SMALL_CAPS,
                     params=SMALL_PARAMS, loop_every_n_scans=20)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scans(n, world_mod):
    world = world_mod.default_world(seed=0)
    traj = world_mod.figure8_trajectory(scale=3.0, period=30.0)
    out = []
    for i in range(n):
        ts = i / 10.0
        scan = world_mod.simulate_lidar_scan(world, traj, ts, n_scan=4, horizon=900,
                                             sweep_time=0.1)
        it = np.arange(ts - 0.005, ts + 0.11, 1 / 200.0)
        w, _ = traj.imu(it)
        _, R = traj.pose(np.array([ts]))
        rpy = Rsc.from_matrix(R[0]).as_euler("ZYX")[::-1]
        out.append((scan, (it - ts).astype(np.float32), w.astype(np.float32),
                    np.array(rpy, np.float32)))
    return out


@pytest.fixture(scope="module")
def scans():
    return _scans(10, jsyn)


@pytest.fixture(scope="module")
def jax_replay(scans):
    pipe = jpl.LioPipeline(JCFG)
    states = []
    for s in scans:
        states.append(pipe.state)
        pipe.process_scan(*s)
    return pipe, states


def test_synthetic_scan_bit_identical():
    wj, wt = jsyn.default_world(seed=3), tsyn.default_world(seed=3)
    for f in dataclasses.fields(wj):
        np.testing.assert_array_equal(getattr(wj, f.name), getattr(wt, f.name))
    tj = jsyn.figure8_trajectory(scale=3.0, period=40.0)
    tt = tsyn.figure8_trajectory(scale=3.0, period=40.0)
    for ts in (0.0, 0.35):
        sj = jsyn.simulate_lidar_scan(wj, tj, ts, n_scan=4, horizon=1200, sweep_time=0.1)
        st = tsyn.simulate_lidar_scan(wt, tt, ts, n_scan=4, horizon=1200, sweep_time=0.1)
        assert sj.keys() == st.keys()
        for k in sj:
            np.testing.assert_array_equal(np.asarray(sj[k]), np.asarray(st[k]), err_msg=k)
    t = np.linspace(0, 3, 50)
    for a, b in zip(tj.imu(t), tt.imu(t)):
        np.testing.assert_array_equal(a, b)


def test_pack_scan_byte_identical_and_metrics(scans):
    ext = (0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0)
    jc = dataclasses.replace(JCFG, ext_rot=ext, ext_rpy=ext)
    tc = convert.config_from_jax(jc)
    odom = dict(trans=np.array([0.1, 0.2, 0.3]), quat=np.array([1.0, 0, 0, 0]), reset_id=2)
    gps = dict(pos=np.array([1.0, 2.0, 0.5]), noise=np.array([0.5, 0.5, 1.0]),
               use_elevation=True)
    s = scans[3]
    for kw in (dict(), dict(odom=odom, gps=gps, do_loop=True)):
        np.testing.assert_array_equal(jpl.pack_scan(jc, *s, **kw), tpl.pack_scan(tc, *s, **kw))
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    assert jmetrics.ate_rmse(a, b) == tmetrics.ate_rmse(a, b)


def test_convert_carries_state_and_config(jax_replay):
    pipe, states = jax_replay
    st = convert.state_from_jax(states[-1])
    flat = convert.to_numpy(st)
    assert flat["corner_hash.rel"].dtype == np.int16
    np.testing.assert_array_equal(flat["map_surf"], np.asarray(states[-1].map_surf))
    np.testing.assert_array_equal(flat["graph.bf_i"], np.asarray(states[-1].graph.bf_i))
    tc = convert.config_from_jax(JCFG)
    assert dataclasses.asdict(tc.caps) == dataclasses.asdict(JCFG.caps)
    assert dataclasses.asdict(tc.params) == dataclasses.asdict(JCFG.params)
    assert tc.horizon == JCFG.horizon and tc.point_capacity == JCFG.point_capacity


def _features(buf):
    P, M = JCFG.point_capacity, JCFG.imu_capacity
    packed = jnp.asarray(buf)
    pts = packed[: P * 6].reshape(6, P)
    imu = jax.lax.bitcast_convert_type(packed[P * 6: P * 6 + M * 8].reshape(M, 4, 2), jnp.float32)
    misc = jax.lax.bitcast_convert_type(packed[P * 6 + M * 8:].reshape(24, 2), jnp.float32)
    rv = pts[4].astype(jnp.int32)
    proj = jfe.project_scan(
        pts[0:3].astype(jnp.float32).T * jpl.POS_SCALE, pts[3].astype(jnp.float32), rv % 256,
        pts[5].astype(jnp.float32) * jpl.TIME_SCALE, rv >= 256, imu[:, 0], imu[:, 1:4],
        misc[0].astype(jnp.int32), misc[1:4], misc[4] > 0.5, n_scan=4, horizon=900)
    feats = jfe.extract_features(proj, max_corner=512, max_surf=2048)
    info = dict(stamp=misc[5], imu_available=proj.imu_available, imu_rpy_init=proj.imu_rpy_init,
                odom_available=misc[6] > 0.5, odom_trans=misc[7:10], odom_quat=misc[10:14],
                odom_reset_id=misc[14].astype(jnp.int32), gps_available=misc[16] > 0.5,
                gps_pos=misc[17:20], gps_noise=misc[20:23], gps_use_elevation=misc[23] > 0.5)
    return feats, info


@pytest.mark.parametrize("i", [4, 7])
def test_map_step_from_carried_state(scans, jax_replay, i):
    """One `map_step` from the JAX state before scan i, on the JAX
    features, on both sides."""
    _, states = jax_replay
    feats, info = _features(jpl.pack_scan(JCFG, *scans[i]))
    sj, oj = jmap.map_step(states[i], info, feats, JCFG.caps, JCFG.params)
    tcfg = convert.config_from_jax(JCFG)
    st, ot = tmap.map_step(convert.state_from_jax(states[i]), {k: _t(v) for k, v in info.items()},
                           tfe.FeatureResult(*[_t(x) for x in feats]), tcfg.caps, tcfg.params)
    assert bool(ot.is_keyframe) == bool(oj.is_keyframe)
    assert int(st.kf_count) == int(sj.kf_count)
    assert abs(int(ot.num_residuals) - int(oj.num_residuals)) <= 0.01 * int(oj.num_residuals)
    np.testing.assert_allclose(ot.x6.numpy()[3:], np.asarray(oj.x6)[3:], atol=1e-2)
    np.testing.assert_allclose(ot.x6.numpy()[:3], np.asarray(oj.x6)[:3], atol=2e-3)
    for name in ("map_corner_n", "map_surf_n", "kf_since_rebuild", "last_imu_valid"):
        assert int(getattr(st, name)) == int(getattr(sj, name)), name


def test_loop_closure_and_graph_solve_match_jax(jax_replay):
    """`loop_closure_step` from the replay's last state, keyframe 0 made
    100 s older so the time gate opens: ICP verifies the newest keyframe
    against it, a loop factor is added, and the pose-graph solve runs.
    Measured differences: fitness 4e-5 relative, factor 3e-7 m, solved
    poses 1e-8 m; held to 1e-3 relative and 1e-5 m."""
    pipe, _ = jax_replay
    s0 = pipe.state._replace(kf_time=pipe.state.kf_time.at[0].add(-100.0))
    tcfg = convert.config_from_jax(JCFG)
    sj, rj = jmap.loop_closure_step(s0, JCFG.caps, JCFG.params)
    st, rt = tmap.loop_closure_step(convert.state_from_jax(s0), tcfg.caps, tcfg.params)
    assert bool(rj.found) and bool(rt.found)
    assert (int(rt.kf_from), int(rt.kf_to)) == (int(rj.kf_from), int(rj.kf_to)) == (2, 0)
    np.testing.assert_allclose(float(rt.fitness), float(rj.fitness), rtol=1e-3)
    f = JCFG.caps.max_keyframes  # the first loop-factor slot
    for name, tol in (("bf_trans", 1e-5), ("bf_quat", 1e-5)):
        np.testing.assert_allclose(getattr(st.graph, name)[f].numpy(),
                                   np.asarray(getattr(sj.graph, name)[f]), atol=tol)
    np.testing.assert_allclose(st.graph.bf_sqrtw[f].numpy(), np.asarray(sj.graph.bf_sqrtw[f]),
                               rtol=1e-3)
    for name in ("n_loops", "loop_pending", "last_loop_kf"):
        assert int(getattr(st, name)) == int(getattr(sj, name)), name
    for name in ("pose_cov_xy", "yaw_var", "pose_cov_cross"):
        np.testing.assert_allclose(float(getattr(st, name)), float(getattr(sj, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    sj, st = jmap._maybe_optimize(sj), tmap._optimize_graph(st, 2)
    np.testing.assert_allclose(st.kf_trans[:3].numpy(), np.asarray(sj.kf_trans[:3]), atol=1e-5)
    np.testing.assert_allclose(st.x6.numpy(), np.asarray(sj.x6), atol=1e-5)
    assert not bool(st.loop_pending)


@pytest.mark.parametrize("use_elevation", [False, True])
def test_gps_factor_and_graph_solve_match_jax(jax_replay, use_elevation):
    """`add_gps_factor` on the replay's last state, keyframe 0 moved 10 m
    so the 5 m settling gate opens, then the solve the factor triggers. The
    factor matches exactly; the f32 PCG solves within 5e-4 m (measured
    5.6e-5 m)."""
    pipe, _ = jax_replay
    s = pipe.state
    s0 = s._replace(kf_trans=s.kf_trans.at[0].add(jnp.array([10.0, 0.0, 0.0])))
    pos = np.asarray(s.kf_trans[2]) + np.array([0.3, -0.2, 0.4], np.float32)
    noise = np.array([0.5, 0.7, 1.5], np.float32)
    tcfg = convert.config_from_jax(JCFG)
    sj = jmap.add_gps_factor(s0, jnp.asarray(pos), jnp.asarray(noise), use_elevation,
                             JCFG.caps, JCFG.params)
    st = tmap.add_gps_factor(convert.state_from_jax(s0), _t(pos), _t(noise), use_elevation,
                             tcfg.caps, tcfg.params)
    assert int(st.n_gps) == int(sj.n_gps) == 1 and bool(st.loop_pending)
    for name in ("up_k", "up_valid", "up_pos", "up_sqrtw"):
        np.testing.assert_allclose(getattr(st.graph, name).numpy(),
                                   np.asarray(getattr(sj.graph, name)), rtol=1e-6, err_msg=name)
    for name in ("pose_cov_xy", "yaw_var", "last_gps_pos"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                   rtol=1e-6, err_msg=name)
    sj, st = jmap._maybe_optimize(sj), tmap._optimize_graph(st, 2)
    np.testing.assert_allclose(st.kf_trans[:3].numpy(), np.asarray(sj.kf_trans[:3]), atol=5e-4)
    np.testing.assert_allclose(st.x6.numpy(), np.asarray(sj.x6), atol=5e-4)


def test_incremental_map_update_matches_jax(jax_replay):
    """The bench path's map growth (`mapRebuildEvery` > 1): a tracked full
    rebuild before the newest keyframe, then `_incremental_map_update`
    folds that keyframe in. Counts, masks, leaf bookkeeping and both hash
    tables exact; centroids and sums within 1e-5 (measured 4e-6)."""
    pipe, _ = jax_replay
    s = pipe.state
    k = int(s.kf_count) - 1
    rebuild = jax.jit(jmap._full_map_rebuild, static_argnums=(1, 2, 4))
    s0 = rebuild(s._replace(kf_count=s.kf_count - 1), JCFG.caps, JCFG.params,
                 s.kf_time[k - 1], True)._replace(kf_count=s.kf_count)
    tcfg = convert.config_from_jax(JCFG)
    sj = jax.jit(jmap._incremental_map_update, static_argnums=(1, 2))(s0, JCFG.caps, JCFG.params)
    st = tmap._incremental_map_update(convert.state_from_jax(s0), tcfg.caps, tcfg.params, k)
    assert int(st.map_surf_n) == int(sj.map_surf_n) > int(s0.map_surf_n)
    for name in ("map_corner_n", "map_corner_valid", "map_surf_valid", "map_corner_cnt",
                 "map_surf_cnt", "leaf_occ_corner", "leaf_occ_surf", "leaf_row_corner",
                 "leaf_row_surf", "kf_since_rebuild"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                      err_msg=name)
    for name in ("map_corner", "map_surf", "map_corner_accum", "map_surf_accum"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                   atol=1e-5, err_msg=name)
    for h in ("corner_hash", "surf_hash"):
        for name in ("rel", "cnt", "idx"):
            np.testing.assert_array_equal(getattr(getattr(st, h), name).numpy(),
                                          np.asarray(getattr(getattr(sj, h), name)))


def test_replay_matches_jax(scans, jax_replay):
    """10 scans through both `LioPipeline`s; the JAX side on its XLA path,
    the port with kernels K1 and K2 switched on (their plain versions on
    the CPU) and the gather-once re-scoring, as the slice runs on the card."""
    pipe_j, _ = jax_replay
    tcfg = convert.config_from_jax(JCFG)
    tcfg = dataclasses.replace(
        tcfg, caps=dataclasses.replace(tcfg.caps, pallas_knn=True, pallas_gn=True),
        params=dataclasses.replace(tcfg.params, gatherOncePerScan=True))
    pipe_t = tpl.LioPipeline(tcfg, device="cpu")
    for s in scans:
        pipe_t.process_scan(*s)
    tj, tt = pipe_j.trajectory_array(), pipe_t.trajectory_array()
    assert int(pipe_t.state.kf_count) == int(pipe_j.state.kf_count) > 1
    np.testing.assert_allclose(tt[:, 3:], tj[:, 3:], atol=25e-3, rtol=0)
    np.testing.assert_allclose(tt[:, :3], tj[:, :3], atol=2e-3, rtol=0)
    gt = np.stack([s[0]["true_pos"] for s in scans])
    ate_j = jmetrics.ate_rmse(tj[:, 3:6].astype(np.float64), gt)
    ate_t = tmetrics.ate_rmse(tt[:, 3:6].astype(np.float64), gt)
    assert abs(ate_t - ate_j) < 5e-3, (ate_t, ate_j)


def _run_python(code_or_args, cwd):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, lvislam_tpu_torch\n"
        "for m in pkgutil.walk_packages(lvislam_tpu_torch.__path__, 'lvislam_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lvislam_tpu', 'yaml', 'PIL')]\n"
        "assert not bad, bad\n"
        "need = ['ops.preintegration', 'ops.triangulate', 'ops.handeye', 'ops.ba', 'ops.dense',\n"
        "        'models.lio.imu_fusion', 'models.vio.feature_manager', 'models.vio.initializer',\n"
        "        'models.vio.estimator', 'models.vio.pipeline', 'utils.convert', 'utils.anchors',\n"
        "        'utils.bus', 'utils.metrics', 'ops.brief', 'ops.ransac', 'models.loop.loop_detector',\n"
        "        'models.vio.frame_step', 'models.pipeline', 'core.config', 'core.yamlite',\n"
        "        'utils.bag', 'utils.jpeg', 'utils.checkpoint', 'utils.bag_writer',\n"
        "        'scripts.run_rosbag_lvi', 'core.messages', 'utils.profiling', 'utils.png',\n"
        "        'utils.debugviz', 'utils.native', 'ops.chessboard', 'ops.calibration',\n"
        "        'scripts.run_euroc_vio', 'scripts.run_synthetic_lvi', 'parallel.mesh',\n"
        "        'parallel.sharded_knn', 'parallel.sharded_scan2map', 'parallel.batch_replay',\n"
        "        'models.replay', 'scripts.bench', 'scripts.bench_inputs', 'scripts.profile',\n"
        "        'scripts.train_vocab']\n"
        "missing = [m for m in need if 'lvislam_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('clean', len([m for m in sys.modules if m.startswith('lvislam_tpu_torch')]))\n"
    )
    r = _run_python(["-c", code], cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("clean")


def test_chip_smoke_has_no_cpu_path():
    """Without a GPU the smoke run must fail and print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke run would use it")
    r = _run_python([os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
