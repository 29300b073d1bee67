"""The visual loop detector's modules against the JAX package's: BRIEF
descriptors, Hamming matching and BoW scoring on rendered frames, PnP RANSAC
with JAX's draws, `add_and_detect` over the revisit scene of
`tests/test_loop_detector.py`, the trained vocabulary, and the lidar side of
an external loop (`mapping.loop_closure_external`)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.models.lio import mapping as jmap
from lvislam_tpu.models.loop import loop_detector as jld
from lvislam_tpu.ops import brief as jb, gftt as jg, ransac as jr
from lvislam_tpu.utils import synthetic as jsyn
from lvislam_tpu_torch.models.lio import mapping as tmap
from lvislam_tpu_torch.models.loop import loop_detector as tld
from lvislam_tpu_torch.ops import brief as tb, ransac as tr
from lvislam_tpu_torch.utils import anchors, convert, synthetic as tsyn

torch.set_num_threads(1)

# tests/test_loop_detector.py's capacities
JCAPS = jld.LoopCaps(max_keyframes=64, window_points=48, extra_points=128,
                     recent_exclude=3, min_loop_matches=15)
TCAPS = convert.loop_caps_from_jax(JCAPS)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def jax_sampler(key_seed):
    """JAX's draws (`ransac._sample_indices` under PRNGKey(key_seed)) for
    the weights the port computed."""
    def sample(weights, n_hyp, k):
        w = jnp.asarray(weights.numpy())
        idx = jr._sample_indices(jax.random.PRNGKey(key_seed), n_hyp, k, w.shape[0], w)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))
    return sample


def test_brief_on_rendered_frames():
    """Descriptors, Hamming tables, match indices, BoW word histograms and
    scores equal to JAX's on two rendered 320x240 frames (the bags within
    1e-6: a float sum normalizes them)."""
    world = jsyn.default_world(seed=3)
    traj = jsyn.figure8_trajectory(scale=3.0, period=30.0)
    imgs = [jsyn.render_camera_image(world, traj, t, width=320, height=240, f=200.0)
            for t in (1.0, 1.02, 2.5)]
    kp, ok = jg.detect(jnp.array(imgs[0]), jnp.zeros((1, 2)), jnp.zeros(1, bool),
                       max_pts=64, cell=16, border=16)
    vocab, idf = jb.load_vocabulary(str(anchors_root() / "configs" / "brief_vocab.npz"))
    tv, ti = tb.load_vocabulary(str(anchors_root() / "configs" / "brief_vocab.npz"))
    np.testing.assert_array_equal(vocab, tv)
    np.testing.assert_array_equal(idf, ti)
    dj = [jb.describe(jnp.array(im), kp, ok) for im in imgs]
    dt = [tb.describe(_t(im), _t(kp), _t(ok)) for im in imgs]
    for a, b in zip(dj, dt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tb.hamming_matmul(dt[0], dt[1]).numpy(),
                                  np.asarray(jb.hamming_matmul(dj[0], dj[1])))
    v2 = np.asarray(ok).copy()
    v2[::5] = False
    mj = jb.match(dj[0], ok, dj[2], jnp.asarray(v2))
    mt = tb.match(dt[0], _t(ok), dt[2], _t(v2))
    np.testing.assert_array_equal(mt[0].numpy(), np.asarray(mj[0]))
    np.testing.assert_array_equal(mt[1].numpy(), np.asarray(mj[1]))
    bags_j = [jb.bow_vector(d, ok, jnp.asarray(vocab), jnp.asarray(idf)) for d in dj]
    bags_t = [tb.bow_vector(d, _t(ok), _t(vocab), _t(idf)) for d in dt]
    for a, b in zip(bags_j, bags_t):
        np.testing.assert_array_equal(b.numpy() > 0, np.asarray(a) > 0)  # the same words
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    raw_j = jb.bow_vector(dj[1], ok, jnp.asarray(vocab))
    raw_t = tb.bow_vector(dt[1], _t(ok), _t(vocab))
    np.testing.assert_array_equal(raw_t.numpy() * int(np.sum(np.asarray(ok))),
                                  np.asarray(raw_j) * int(np.sum(np.asarray(ok))))
    sj = jb.bow_scores(bags_j[0], jnp.stack(bags_j))
    st = tb.bow_scores(bags_t[0], torch.stack(bags_t))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)


def anchors_root():
    from pathlib import Path
    return Path(anchors.__file__).resolve().parents[2]


def test_vocabulary_training_and_files(tmp_path):
    """`train_vocabulary` (host numpy) and the vocabulary file round trip
    give JAX's words and weights exactly."""
    rng = np.random.default_rng(1)
    desc = np.where(rng.random((300, 256)) > 0.5, 1.0, -1.0).astype(np.float32)
    ids = np.arange(300) % 7
    vj, ij = jb.train_vocabulary(desc, n_words=32, iters=4, image_ids=ids)
    vt, it = tb.train_vocabulary(desc, n_words=32, iters=4, image_ids=ids)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(it, ij)
    vj2, _ = jb.train_vocabulary(desc[:20], n_words=32, iters=2)
    vt2, _ = tb.train_vocabulary(desc[:20], n_words=32, iters=2)
    np.testing.assert_array_equal(vt2, vj2)
    np.testing.assert_array_equal(tb.make_vocabulary(64), np.asarray(jb.make_vocabulary(64)))
    p = str(tmp_path / "v.npz")
    tb.save_vocabulary(p, vt, it)
    v3, i3 = jb.load_vocabulary(p)
    np.testing.assert_array_equal(v3, vj)
    np.testing.assert_array_equal(i3, ij)


@pytest.mark.parametrize("seed", [0, 3])
def test_pnp_ransac_with_jax_draws(seed):
    """Identical inlier masks and counts, pose within 1e-4, on 60 points of
    which 15 are outliers and 5 invalid."""
    rng = np.random.default_rng(seed)
    N = 60
    X = rng.uniform([-3, -2, 4], [3, 2, 10], (N, 3)).astype(np.float32)
    from scipy.spatial.transform import Rotation as Rsc

    R = Rsc.from_rotvec(rng.normal(0, 0.2, 3)).as_matrix()
    t = rng.normal(0, 0.5, 3)
    Xc = X @ R.T + t
    uv = (Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 1e-3, (N, 2))).astype(np.float32)
    uv[:15] += rng.uniform(-0.3, 0.3, (15, 2)).astype(np.float32)
    valid = np.ones(N, bool)
    valid[50:55] = False
    rj = jr.pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), seed=seed)
    w = jnp.asarray(valid, jnp.float32)
    w = w / jnp.maximum(jnp.sum(w), 1.0)
    idx = jr._sample_indices(jax.random.PRNGKey(seed + 1), 128, 6, N, w)
    rt = tr.pnp_ransac(_t(X), _t(uv), _t(valid), idx=_t(np.asarray(idx).astype(np.int64)))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 35
    np.testing.assert_allclose(rt.trans.numpy(), np.asarray(rj.trans), atol=1e-4)
    q_t, q_j = rt.quat.numpy(), np.asarray(rj.quat)
    np.testing.assert_allclose(q_t * np.sign(q_t[0]), q_j * np.sign(q_j[0]), atol=1e-4)
    np.testing.assert_allclose(q_j[1:] * np.sign(q_j[0]),
                               Rsc.from_matrix(R).as_quat()[:3] * np.sign(
                                   Rsc.from_matrix(R).as_quat()[3]), atol=5e-3)


def _revisit(add_and_detect, db, to, sampler=None):
    """Run the revisit scene through one package's `add_and_detect`;
    returns (db, [(frame, old slot)] of accepted loops, [(frame, old slot,
    PnP inliers)] of every verified candidate)."""
    world, traj, times, imgs = tsyn.loop_scene()
    found, verified = [], []
    for i, (t, img) in enumerate(zip(times, imgs)):
        kp, ok = jg.detect(jnp.array(img), jnp.zeros((1, 2)), jnp.zeros(1, bool),
                           max_pts=JCAPS.window_points, cell=20, border=16)
        pts, hit = tsyn.ray_points(world, traj, t, np.asarray(kp))
        norm = ((np.asarray(kp) - [160, 120]) / 200.0).astype(np.float32)
        valid = np.asarray(ok) & hit
        kw = {} if sampler is None else {"sampler": sampler}
        db, cand = add_and_detect(db, to(img), to(np.asarray(kp)), to(norm), to(pts),
                                  to(valid), t, focal=200.0, **kw)
        if int(cand.old_index) >= 0:
            verified.append((i, int(cand.old_index), int(cand.n_matches)))
        if bool(cand.found):
            found.append((i, int(cand.old_index)))
    return db, found, verified


@pytest.fixture(scope="module")
def jax_revisit():
    return _revisit(lambda db, *a, **kw: jld.add_and_detect(db, *a[:-1], jnp.float32(a[-1]),
                                                            JCAPS, **kw),
                    jld.db_init(JCAPS), jnp.asarray)


def test_add_and_detect_revisit_matches_jax(jax_revisit):
    """Over the revisit scene, with JAX's PnP draws: the same accepted
    (cur, old) pairs with the same PnP inlier counts, verification on the
    same frames, and the database's integer fields equal (bags within 1e-6).
    Verified candidates that are not accepted may differ: at frame 16 slots
    2 and 6 tie at a score of 0.1398602 in JAX and the port's sum order puts
    slot 2 one ulp lower, so another slot is verified; and a PnP on the 1-3
    matches of a wrong candidate is degenerate. The JAX run's pairs are the
    ones `utils/anchors.LOOP_SCENE` stores for the card."""
    dbj, found_j, ver_j = jax_revisit
    dbt, found_t, ver_t = _revisit(
        lambda db, *a, **kw: tld.add_and_detect(db, *a, TCAPS, **kw),
        tld.db_init(TCAPS, device="cpu"), _t, sampler=jax_sampler(1))
    assert found_j, "the JAX run found no loop on the revisit"
    assert found_t == found_j
    assert [v[0] for v in ver_t] == [v[0] for v in ver_j]
    acc_j = [v for v in ver_j if tuple(v[:2]) in found_j]
    assert [v for v in ver_t if tuple(v[:2]) in found_t] == acc_j
    assert [list(p) for p in found_j] == anchors.LOOP_SCENE["pairs"]
    assert [list(v) for v in ver_j] == anchors.LOOP_SCENE["verified"]
    for name in ("count", "seq", "kp_valid", "kp_desc", "kp_norm", "stamps"):
        np.testing.assert_array_equal(getattr(dbt, name).numpy(), np.asarray(getattr(dbj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(dbt.bags.numpy(), np.asarray(dbj.bags), atol=1e-6)


def test_loop_detector_own_draws_on_revisit(jax_revisit):
    """With the port's own draws the same pairs are accepted on the CPU
    (the card's phase 13 gates on this)."""
    _, found_j, _ = jax_revisit
    _, found_t, ver_t = _revisit(
        lambda db, *a, **kw: tld.add_and_detect(db, *a, TCAPS, **kw),
        tld.db_init(TCAPS, device="cpu"), _t)
    assert found_t == found_j, ver_t


# tests/test_torch_lio_slice.py's small LIO configuration
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


@pytest.fixture(scope="module")
def lio_state():
    """A JAX LIO state with 3 keyframes after 8 scans of the figure-8."""
    from lvislam_tpu.models.lio import pipeline as jpl
    from scipy.spatial.transform import Rotation as Rsc

    cfg = jpl.LioConfig(n_scan=4, horizon=900, point_capacity=4096, caps=SMALL_CAPS,
                        params=SMALL_PARAMS, loop_every_n_scans=1000)
    pipe = jpl.LioPipeline(cfg)
    world = jsyn.default_world(seed=0)
    traj = jsyn.figure8_trajectory(scale=3.0, period=30.0)
    for i in range(8):
        ts = i / 10.0
        scan = jsyn.simulate_lidar_scan(world, traj, ts, n_scan=4, horizon=900, sweep_time=0.1)
        it = np.arange(ts - 0.005, ts + 0.11, 1 / 200.0)
        w, _ = traj.imu(it)
        _, R = traj.pose(np.array([ts]))
        rpy = Rsc.from_matrix(R[0]).as_euler("ZYX")[::-1]
        pipe.process_scan(scan, (it - ts).astype(np.float32), w.astype(np.float32),
                          np.array(rpy, np.float32))
    return pipe.state


@pytest.mark.parametrize("pair", [(2, 0), (1, 1), (2, 5)])
def test_loop_closure_external_matches_jax(lio_state, pair):
    """`loop_closure_external` from a carried JAX state: the same `found`,
    `kf_to` and loop count, the factor within slice 1's 25 mm / 2 mrad
    (refused pairs: the same refusal)."""
    cur, old = pair
    assert int(lio_state.kf_count) >= 3
    tcfg_caps, tcfg_params = convert.caps_from_jax(SMALL_CAPS), convert.params_from_jax(SMALL_PARAMS)
    sj, rj = jmap.loop_closure_external(lio_state, jnp.int32(cur), jnp.int32(old),
                                        SMALL_CAPS, SMALL_PARAMS)
    st, rt = tmap.loop_closure_external(convert.state_from_jax(lio_state, "cpu"), cur, old,
                                        tcfg_caps, tcfg_params)
    assert bool(rt.found) == bool(rj.found)
    assert int(rt.kf_to) == int(rj.kf_to)
    assert int(st.n_loops) == int(sj.n_loops)
    if bool(rj.found):
        f = SMALL_CAPS.max_keyframes
        np.testing.assert_allclose(st.graph.bf_trans[f].numpy(), np.asarray(sj.graph.bf_trans[f]),
                                   atol=0.025)
        qt, qj = st.graph.bf_quat[f].numpy(), np.asarray(sj.graph.bf_quat[f])
        assert 2 * np.arccos(min(1.0, abs(float(qt @ qj)))) < 2e-3
        assert bool(st.loop_pending) and int(st.last_loop_kf) == int(sj.last_loop_kf)
