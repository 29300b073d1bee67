"""The LIO batched-upload transport of the port (``LioConfig.upload_batch``,
``lio_full_step_row``, ``lio_batch_step``) and ``lio_full_step``'s
`odom_override`: the counterpart of
``tests/test_lio_integration.py::test_lio_batched_upload_equivalence`` on the
port, and the override against the JAX step from one carried state."""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from lvislam_tpu.models.lio import pipeline as jpl  # noqa: E402
from lvislam_tpu_torch.models.lio import pipeline as tpl  # noqa: E402
from lvislam_tpu_torch.utils import convert  # noqa: E402
from lvislam_tpu_torch.utils import synthetic as tsyn  # noqa: E402

from test_torch_lio_slice import JCFG, _scans  # noqa: E402

torch.set_num_threads(1)

N_SCANS, BATCH = 15, 4  # 3 full batches of 4 + a 3-row partial flush


@pytest.fixture(scope="module")
def scans():
    return _scans(N_SCANS, tsyn)


def _run(scans, **kw):
    pipe = tpl.LioPipeline(dataclasses.replace(convert.config_from_jax(JCFG), **kw),
                           device="cpu")
    outs = [pipe.process_scan(*s) for s in scans]
    return pipe, outs


@pytest.fixture(scope="module")
def per_scan(scans):
    pipe, outs = _run(scans)
    assert all(o is not None for o in outs) and pipe.uploads == N_SCANS
    return pipe.trajectory_array(), pipe.state


def test_batched_upload_bit_equal_to_per_scan(scans, per_scan):
    """15 scans at `upload_batch` = 4 give the trajectory and final state of
    per-scan uploads bit for bit (the JAX package's dispatch flags select
    nothing here: there is one path): `process_scan` returns None while it
    stages, one upload a batch (the trailing 3-row batch padded in its one
    upload), the batch entries flattened in order by `trajectory_array`;
    `pose_matrix` flushes first."""
    ref, ref_state = per_scan
    pipe, outs = _run(scans, upload_batch=BATCH)
    assert all(o is None for o in outs)
    mat = pipe.pose_matrix()  # flushes: the staged scans run first
    assert pipe.uploads == math.ceil(N_SCANS / BATCH)
    assert [len(st) if isinstance(st, tuple) else 1 for st, _ in pipe.trajectory] == \
        [BATCH] * (N_SCANS // BATCH) + [1] * (N_SCANS % BATCH)
    np.testing.assert_array_equal(pipe.trajectory_array(), ref)
    a, b = convert.to_numpy(pipe.state), convert.to_numpy(ref_state)
    for name in b:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    np.testing.assert_array_equal(mat, pipe.pose_matrix(ref[-1]))


def _step_kw(cfg):
    return dict(n_scan=cfg.n_scan, horizon=cfg.horizon, min_range=cfg.min_range,
                max_range=cfg.max_range, edge_threshold=cfg.edge_threshold,
                surf_threshold=cfg.surf_threshold, surf_leaf=cfg.odometry_surf_leaf,
                caps=cfg.caps, params=cfg.params, point_capacity=cfg.point_capacity,
                imu_capacity=cfg.imu_capacity, exact_selection=cfg.exact_loam_selection)


def test_odom_override(scans, per_scan):
    """`odom_override=None` is the step without it bit for bit; an override
    equal to the packed odom fields gives the step with them packed bit for
    bit; and the port's override against the JAX step's from one carried
    state (after 6 scans) with the same override: the pose within the
    carried-state bounds of `test_torch_lio_slice` (1e-2 m, 2e-3 rad),
    keyframe flag and count equal."""
    jpipe = jpl.LioPipeline(JCFG)
    for s in scans[:6]:
        jpipe.process_scan(*s)
    tcfg = convert.config_from_jax(JCFG)
    state = convert.state_from_jax(jpipe.state)
    kw = _step_kw(tcfg)
    odom = dict(trans=np.array([0.21, -0.05, 0.02], np.float32),
                quat=np.array([0.999, 0.0, 0.0, 0.0447], np.float32), reset_id=0)
    plain = tpl.pack_scan(tcfg, *scans[6])
    packed = tpl.pack_scan(tcfg, *scans[6], odom=odom)
    s0, o0 = tpl.lio_full_step(state, torch.from_numpy(plain), **kw)
    s1, o1 = tpl.lio_full_step(state, torch.from_numpy(plain), None, **kw)
    assert torch.equal(o0.x6, o1.x6) and torch.equal(s0.map_surf, s1.map_surf)
    override = (torch.tensor(True), torch.from_numpy(odom["trans"]),
                torch.from_numpy(odom["quat"]), torch.tensor(0.0))
    s2, o2 = tpl.lio_full_step(state, torch.from_numpy(packed), **kw)
    s3, o3 = tpl.lio_full_step(state, torch.from_numpy(plain), override, **kw)
    assert torch.equal(o2.x6, o3.x6)
    a, b = convert.to_numpy(s2), convert.to_numpy(s3)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    joverride = (jnp.asarray(True), jnp.asarray(odom["trans"]), jnp.asarray(odom["quat"]),
                 jnp.float32(0.0))
    sj, oj = jpl.lio_full_step(jpipe.state, jnp.asarray(plain), joverride, **_step_kw(JCFG))
    assert bool(o3.is_keyframe) == bool(oj.is_keyframe)
    assert int(s3.kf_count) == int(sj.kf_count)
    np.testing.assert_allclose(o3.x6.numpy()[3:], np.asarray(oj.x6)[3:], atol=1e-2)
    np.testing.assert_allclose(o3.x6.numpy()[:3], np.asarray(oj.x6)[:3], atol=2e-3)


def test_row_and_batch_steps(scans, per_scan):
    """`lio_batch_step` over a staged (K, L) batch is K `lio_full_step`s bit
    for bit (its (K, 6) poses are theirs), and `lio_full_step_row` on row k
    is the step on that row."""
    tcfg = convert.config_from_jax(JCFG)
    kw = _step_kw(tcfg)
    pipe, _ = _run(scans[:2])
    rows = [tpl.pack_scan(tcfg, *s) for s in scans[2:5]]
    arr = torch.from_numpy(np.stack(rows))
    sb, x6s = tpl.lio_batch_step(pipe.state, arr, **kw)
    st = pipe.state
    for k in range(3):
        st, out = tpl.lio_full_step_row(st, arr, k, **kw)
        assert torch.equal(out.x6, x6s[k])
    assert x6s.shape == (3, 6) and torch.equal(st.x6, sb.x6)
