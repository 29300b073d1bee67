"""The port's multi-device part (``lvislam_tpu_torch.parallel``) against
``lvislam_tpu.parallel`` on the inputs of ``tests/test_parallel.py``: JAX on
the 8 virtual CPU devices of ``tests/conftest.py``, the port on meshes of
``"cpu"`` repeated. Sharded results are held to JAX's own bounds (sorted
distances 1e-4, 98% equal neighbour sets, x6 5e-4, residual counts within
2), because a shard's distance matmul may round otherwise than the whole
map's; the batched LIO step to slice 1's bounds of JAX's batched step and
bit for bit to the port's unbatched steps."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, str(Path(__file__).resolve().parent))

from lvislam_tpu.core import lie as jlie  # noqa: E402
from lvislam_tpu.models.lio import mapping as jmap  # noqa: E402
from lvislam_tpu.ops import scan2map as js2m  # noqa: E402
from lvislam_tpu.parallel import batch_replay as jbr  # noqa: E402
from lvislam_tpu.parallel import mesh as jmesh  # noqa: E402
from lvislam_tpu.parallel import sharded_knn as jsk  # noqa: E402
from lvislam_tpu.parallel import sharded_scan2map as jss  # noqa: E402
from lvislam_tpu_torch.models.lio import frontend as tfe  # noqa: E402
from lvislam_tpu_torch.models.lio import mapping as tmap  # noqa: E402
from lvislam_tpu_torch.ops import scan2map as ts2m  # noqa: E402
from lvislam_tpu_torch.parallel import batch_replay as tbr  # noqa: E402
from lvislam_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from lvislam_tpu_torch.parallel import sharded_knn as tsk  # noqa: E402
from lvislam_tpu_torch.parallel import sharded_scan2map as tss  # noqa: E402
from lvislam_tpu_torch.utils import convert  # noqa: E402

from test_torch_lio_slice import JCFG, _features, _scans  # noqa: E402

torch.set_num_threads(1)

MAPS = [1, 2, 4]


def jax_mesh(map_par, n=8):
    return jmesh.make_mesh(n, map_parallel=map_par, devices=jax.devices("cpu")[:n])


def port_mesh(map_par, n=8):
    return tmesh.make_mesh(map_parallel=map_par, devices=["cpu"] * n)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _same_sets(a, b):
    return np.mean([set(x) == set(y) for x, y in zip(np.asarray(a), np.asarray(b))])


@pytest.mark.parametrize("k", [1, 5])
def test_knn_blocked_equals_one_block(k):
    """`knn` in query blocks of at most `block_elems` distances gives the
    one-block result bit for bit (idx and distances); a block boundary that
    does not divide Q included."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(301, 3)).astype(np.float32))
    m = torch.from_numpy(rng.normal(size=(1000, 3)).astype(np.float32))
    qv = torch.ones(301, dtype=torch.bool)
    mv = torch.from_numpy(rng.random(1000) > 0.1)
    i1, d1 = ts2m.knn(q, qv, m, mv, k=k, block_elems=1 << 30)
    i2, d2 = ts2m.knn(q, qv, m, mv, k=k, block_elems=64 * 1000)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    ij, dj = js2m.knn(jnp.asarray(q.numpy()), jnp.asarray(qv.numpy()), jnp.asarray(m.numpy()),
                      jnp.asarray(mv.numpy()), k=k, block_elems=64 * 1000)
    np.testing.assert_allclose(d2.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)
    assert _same_sets(i2.numpy(), ij) > 0.98


def test_make_mesh_and_put():
    """Axes and shape as JAX's, `put` shards dim 0 one a slot (each slot's
    device) and asserts divisibility; a replicated placement is the tensor."""
    mesh = port_mesh(2)
    jm = jax_mesh(2)
    assert mesh.shape == dict(jm.shape) == {"batch": 4, "map": 2}
    assert mesh.axis_names == tuple(jm.axis_names)
    x = torch.arange(12.0).reshape(4, 3)
    sh = tmesh.put(x, mesh, tmesh.Placement("map"))
    assert len(sh.shards) == 2 and torch.equal(torch.cat(sh.shards), x)
    assert torch.equal(tmesh.gather(tmesh.put(x, mesh, tmesh.batch_sharding(mesh))), x)
    assert tmesh.put(x, mesh, tmesh.replicated(mesh)) is x
    y = torch.arange(8.0).reshape(2, 4)  # JAX's P(None, "map"): dim 1
    ym = tmesh.put(y, mesh, tmesh.map_sharding(mesh))
    assert ym.shards[0].shape == (2, 2) and torch.equal(tmesh.gather(ym), y)
    with pytest.raises(AssertionError):
        tmesh.put(torch.zeros(3, 2), mesh, tmesh.batch_sharding(mesh))


@pytest.mark.parametrize("n_map", MAPS)
def test_sharded_knn_matches_jax_and_exact(rng, n_map):
    """`tests/test_parallel.py:test_sharded_knn_matches_exact`'s inputs on
    meshes with `map` = 1, 2, 4: the port's sharded kNN against JAX's and
    against the port's unsharded `knn`."""
    Q, M = 128, 1024
    q = rng.normal(size=(Q, 3)).astype(np.float32)
    m = rng.normal(size=(M, 3)).astype(np.float32)
    qv = np.ones(Q, bool)
    mv = rng.random(M) > 0.1
    jm = jax_mesh(n_map)
    sh = NamedSharding(jm, P("map"))
    with jm:
        ij, dj = jax.jit(jsk.sharded_knn(jm, k=5, chunk=256))(
            jnp.asarray(q), jnp.asarray(qv), jax.device_put(jnp.asarray(m), sh),
            jax.device_put(jnp.asarray(mv), sh))
    mesh = port_mesh(n_map)
    fn = tsk.sharded_knn(mesh, k=5, chunk=256)
    it, dt = fn(_t(q), _t(qv), tmesh.put(_t(m), mesh, tmesh.Placement("map")),
                tmesh.put(_t(mv), mesh, tmesh.Placement("map")))
    ir, dr = ts2m.knn(_t(q), _t(qv), _t(m), _t(mv), k=5)
    for i_ref, d_ref in ((np.asarray(ij), np.asarray(dj)), (ir.numpy(), dr.numpy())):
        np.testing.assert_allclose(np.sort(dt.numpy(), 1), np.sort(d_ref, 1),
                                   rtol=1e-4, atol=1e-4)
        assert _same_sets(it.numpy(), i_ref) > 0.98
    # a whole tensor is split on the way in
    i2, d2 = fn(_t(q), _t(qv), _t(m), _t(mv))
    assert torch.equal(i2, it) and torch.equal(d2, dt)


def test_sharded_knn_ties_go_to_the_lowest_index():
    """Equal distances across shards: the merge keeps the lowest global
    index, as `lax.top_k` over the shard-major concatenation."""
    m = torch.zeros(8, 3)
    m[:, 0] = torch.tensor([1.0, 5, 5, 5, 1, 5, 5, 5])
    got, d = tsk.sharded_knn(port_mesh(2, n=2), k=2)(
        torch.zeros(1, 3), torch.ones(1, dtype=torch.bool), m, torch.ones(8, dtype=torch.bool))
    assert got.tolist() == [[0, 4]] and d.tolist() == [[1.0, 1.0]]


def _structured_world(rng):
    """`tests/test_parallel.py:test_sharded_scan_to_map_matches_single_device`'s
    world: corner points on vertical lines, surf points on planes, a scan
    observed from a small offset pose."""
    C, S, Mc, Ms = 192, 256, 1536, 2048
    lines = rng.uniform(-6, 6, (8, 2))
    mc = np.stack([
        np.repeat(lines[:, 0], Mc // 8), np.repeat(lines[:, 1], Mc // 8),
        np.tile(np.linspace(-2, 2, Mc // 8), 8),
    ], 1) + rng.normal(0, 0.01, (Mc, 3))
    z0 = rng.uniform(-1, 1, 4)
    ms = np.concatenate([
        np.stack([
            rng.uniform(-8, 8, Ms // 4), rng.uniform(-8, 8, Ms // 4),
            np.full(Ms // 4, z) + rng.normal(0, 0.01, Ms // 4),
        ], 1) for z in z0
    ])
    true_x6 = np.array([0.02, -0.01, 0.03, 0.2, -0.1, 0.05], np.float32)
    Rm = np.asarray(jlie.ypr_to_matrix(jnp.array(
        [true_x6[2], true_x6[1], true_x6[0]]) * (180.0 / np.pi)))
    ci = rng.integers(0, Mc, C)
    cp = (mc[ci] + rng.normal(0, 0.005, (C, 3)) - true_x6[3:6]) @ Rm
    si = rng.integers(0, Ms, S)
    sp = (ms[si] + rng.normal(0, 0.005, (S, 3)) - true_x6[3:6]) @ Rm
    f32 = lambda a: np.asarray(a, np.float32)
    return true_x6, (np.zeros(6, np.float32), f32(cp), np.ones(C, bool), f32(sp),
                     np.ones(S, bool), f32(mc), np.ones(Mc, bool), f32(ms), np.ones(Ms, bool))


@pytest.mark.parametrize("n_map", MAPS)
def test_sharded_scan_to_map_matches_jax_and_single_device(rng, n_map):
    """The map-sharded GN on meshes with `map` = 1, 2, 4 against JAX's
    sharded solve and against the port's unsharded `scan_to_map`: x6 within
    5e-4, residual counts within 2, `converged` equal (the bounds of
    `tests/test_parallel.py`); the pose recovered."""
    true_x6, args = _structured_world(rng)
    jm = jax_mesh(n_map)
    sh = NamedSharding(jm, P("map"))
    jargs = [jnp.asarray(a) for a in args]
    jargs[5:] = [jax.device_put(a, sh) for a in jargs[5:]]
    with jm:
        gj = jss.sharded_scan_to_map(jm, max_iters=10, eigen_thresh=10.0)(*jargs)
    mesh = port_mesh(n_map)
    targs = [_t(a) for a in args]
    ref = ts2m.scan_to_map(*targs, max_iters=10, eigen_thresh=10.0)
    targs[5:] = [tmesh.put(a, mesh, tmesh.Placement("map")) for a in targs[5:]]
    got = tss.sharded_scan_to_map(mesh, max_iters=10, eigen_thresh=10.0)(*targs)
    assert float(np.linalg.norm(got.x6.numpy() - true_x6)) < 0.02
    for x6, n_res, conv in ((np.asarray(gj.x6), int(gj.num_residuals), bool(gj.converged)),
                            (ref.x6.numpy(), int(ref.num_residuals), bool(ref.converged))):
        np.testing.assert_allclose(got.x6.numpy(), x6, rtol=0, atol=5e-4)
        assert abs(int(got.num_residuals) - n_res) <= 2
        assert bool(got.converged) == conv


# ---- the batched LIO step ----

# 6 steps give each sequence two keyframes, so the loop test has a
# candidate; poses are held to slice 1's bounds over the first 3 (POSE_STEPS):
# later ones drift by rounding as slice 1's replay does (ROADMAP.md, Queue 3)
B, STEPS, POSE_STEPS, STARTS = 2, 6, 3, (0, 4)


@pytest.fixture(scope="module")
def batch_inputs():
    """Per step, the B sequences' scan info and features (the JAX front
    end's, on the scans `tests/test_torch_lio_slice.py` feeds; sequence b
    starts at scan STARTS[b])."""
    scans = _scans(max(STARTS) + STEPS, __import__("lvislam_tpu.utils.synthetic",
                                                     fromlist=["x"]))
    from lvislam_tpu.models.lio import pipeline as jpl

    steps = []
    for i in range(STEPS):
        per = [_features(jpl.pack_scan(JCFG, *scans[s + i])) for s in STARTS]
        feats = jax.tree.map(lambda *xs: jnp.stack(xs), *[f for f, _ in per])
        info = {k: jnp.stack([inf[k] for _, inf in per]) for k in per[0][1]}
        steps.append((info, feats))
    return steps


def port_cfg():
    tcfg = convert.config_from_jax(JCFG)
    return (dataclasses.replace(tcfg.caps, pallas_knn=True, pallas_gn=True),
            dataclasses.replace(tcfg.params, gatherOncePerScan=True))


@pytest.fixture(scope="module")
def jax_batched(batch_inputs):
    jm = jmesh.make_mesh(B, map_parallel=1, devices=jax.devices("cpu")[:B])
    state = jbr.batched_lio_init(JCFG.caps, B, jm)
    step = jbr.make_batched_step(JCFG.caps, JCFG.params, jm)
    outs = []
    with jm:
        for info, feats in batch_inputs:
            state, out = step(state, info, feats)
            outs.append(out)
    return state, outs


@pytest.fixture(scope="module")
def port_batched(batch_inputs):
    caps, params = port_cfg()
    mesh = tmesh.make_mesh(devices=["cpu"] * B)
    state = tbr.batched_lio_init(caps, B, mesh)
    step = tbr.make_batched_step(caps, params, mesh)
    outs = []
    for info, feats in batch_inputs:
        state, out = step(state, {k: _t(v) for k, v in info.items()},
                          tfe.FeatureResult(*[_t(x) for x in feats]))
        outs.append(out)
    return state, outs


def test_batched_step_bit_equal_to_unbatched_steps(batch_inputs, port_batched):
    """Each sequence of the port's batched step (sharded over a (batch 2,
    map 1) mesh) equals its own unbatched `map_step` run bit for bit: every
    state leaf and every output."""
    caps, params = port_cfg()
    state, outs = port_batched
    whole = tmesh.tree_map(tmesh.gather, state)
    for b in range(B):
        s = tmap.lio_init(caps, "cpu")
        for i, (info, feats) in enumerate(batch_inputs):
            s, out = tmap.map_step(s, {k: _t(v[b]) for k, v in info.items()},
                                   tfe.FeatureResult(*[_t(x[b]) for x in feats]), caps, params)
            for name, a, c in zip(out._fields, out, tmesh.tree_map(tmesh.gather, outs[i])):
                assert torch.equal(a, c[b]), (b, i, name)
        for name, a in convert.to_numpy(s).items():
            np.testing.assert_array_equal(a, convert.to_numpy(whole)[name][b], err_msg=name)


def test_batched_step_matches_jax(jax_batched, port_batched):
    """Each sequence within slice 1's bounds of JAX's batched step (25 mm,
    2 mrad) over the first 3 steps, with the keyframe flags at every step
    and the keyframe counts equal; the sequences' stored keyframe clouds
    differ."""
    (sj, oj), (st, ot) = jax_batched, port_batched
    for i, (a, b) in enumerate(zip(oj, ot)):
        b = tmesh.tree_map(tmesh.gather, b)
        np.testing.assert_array_equal(b.is_keyframe.numpy(), np.asarray(a.is_keyframe))
        if i < POSE_STEPS:
            np.testing.assert_allclose(b.x6.numpy()[:, 3:], np.asarray(a.x6)[:, 3:], atol=25e-3)
            np.testing.assert_allclose(b.x6.numpy()[:, :3], np.asarray(a.x6)[:, :3], atol=2e-3)
    kf = tmesh.gather(st.kf_count)
    np.testing.assert_array_equal(kf.numpy(), np.asarray(sj.kf_count))
    surf = tmesh.gather(st.kf_surf)
    assert not torch.allclose(surf[0, 0], surf[1, 0])


def test_batched_loop_step_matches_jax(jax_batched, port_batched):
    """`make_batched_loop_step` on the batched state, keyframe 0 of every
    sequence made 100 s older so the time gate opens: each sequence's loop
    result and loop bookkeeping as JAX's, and as the port's unbatched
    `loop_closure_step`."""
    caps, params = port_cfg()
    sj = jax_batched[0]
    sj = sj._replace(kf_time=sj.kf_time.at[:, 0].add(-100.0))
    sj2, rj = jax.jit(jbr.make_batched_loop_step(JCFG.caps, JCFG.params))(sj)
    mesh = tmesh.make_mesh(devices=["cpu"] * B)
    st = convert.batched_state_from_jax(sj, "cpu")
    st2, rt = tbr.make_batched_loop_step(caps, params)(
        tmesh.put_tree(st, mesh, tmesh.batch_sharding(mesh)))
    rt = tmesh.tree_map(tmesh.gather, rt)
    st2 = tmesh.tree_map(tmesh.gather, st2)
    np.testing.assert_array_equal(rt.found.numpy(), np.asarray(rj.found))
    np.testing.assert_array_equal(rt.kf_from.numpy(), np.asarray(rj.kf_from))
    np.testing.assert_array_equal(rt.kf_to.numpy(), np.asarray(rj.kf_to))
    ok = np.asarray(rj.found)
    assert ok.any()
    np.testing.assert_allclose(rt.fitness.numpy()[ok], np.asarray(rj.fitness)[ok], rtol=1e-3)
    for name in ("n_loops", "loop_pending", "last_loop_kf"):
        np.testing.assert_array_equal(getattr(st2, name).numpy(),
                                      np.asarray(getattr(sj2, name)), err_msg=name)
    for b in range(B):
        s1 = tmesh.tree_map(lambda x: x[b], st)
        s2, r = tmap.loop_closure_step(s1, caps, params)
        assert bool(r.found) == bool(rt.found[b])
        assert torch.equal(s2.graph.bf_trans, st2.graph.bf_trans[b])
