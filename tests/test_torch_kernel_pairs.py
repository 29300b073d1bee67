"""The pair entry points of kernels K1 and K2 (one launch for both feature
classes on the card) on the CPU, where they run their plain versions,
against the JAX package's TPU kernels in interpret mode, one call per
class, as the JAX step makes them.

Tolerances: K1's indices exact and distances within rtol 1e-6 (both score
in the same scaled f32 domain); K2's residual count exact and H and g
within 2e-4 of their scale (`chip_smoke.check_gn_pair`'s bar; the sums run
in another order, and the TPU kernel's polynomial acos differs from the
port's true one); the pair plain versions equal the single-class plain
calls bit for bit (they are those calls, summed)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.ops import pallas_gn, scan2map as js2m, voxel_hash as jvh
from test_pallas_gn import _make_case as _pallas_gn_case
from lvislam_tpu_torch.core import lie as tlie
from lvislam_tpu_torch.ops import gn_partials as gnp
from lvislam_tpu_torch.ops import knn_tail
from lvislam_tpu_torch.ops import scan2map as ts2m, voxel_hash as tvh

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _gn_classes(seed, N):
    """Corner and surf cases of `tests/test_pallas_gn.py` seen from one pose
    (the same seed draws the same points and pose for both classes)."""
    return {kind: _pallas_gn_case(kind, np.random.default_rng(seed), N)
            for kind in ("corner", "surf")}


def _port_blocks(case):
    pl_, valid, nbrs, has = (_t(a) for a in case[1:5])
    return gnp.pack_pts(pl_, valid), gnp.pack_nbrs(nbrs, has)


def _port_pose(x6):
    x6 = _t(x6)
    return gnp.pack_pose(tlie.x6_rotation(x6), x6[3:6], ts2m._euler_jac_mats(x6))


def _world_classes(n_c, n_s):
    """`chip_smoke.py`'s K2 parity inputs at smaller sizes: neighbourhoods on
    the synthetic world's edges and surfaces, as the step sees them, in the
    case layout of `_pallas_gn_case`."""
    import chip_smoke

    corner, surf, h_c, h_s, q_c, q_s, x6 = chip_smoke.parity_inputs(torch.device("cpu"))
    cases = {}
    for kind, h, m, q in (("corner", h_c, corner, q_c[:n_c]), ("surf", h_s, surf, q_s[:n_s])):
        pts, nbr = (a.numpy() for a in chip_smoke.gn_blocks(h, m, q, x6))
        N = pts.shape[1]
        cases[kind] = (None, pts[0:3].T.copy(), pts[3] > 0.5, nbr[0:15].T.reshape(N, 5, 3).copy(),
                       nbr[15:20].T > 0.5, x6.numpy())
    return cases


@pytest.mark.parametrize("source", ["pallas_gn_case", "world"])
def test_gn_partials_pair_plain_matches_pallas_interpret(source):
    """On `tests/test_pallas_gn.py`'s case and seed (every gate fires both
    ways) and on the synthetic world. Random thin planes at other seeds are
    ill-conditioned in f32: there the TPU kernel itself strays past 2e-4 of
    the XLA path's sums (`tests/test_torch_scan2map.py`)."""
    cases = _gn_classes(0, 256) if source == "pallas_gn_case" else _world_classes(256, 512)
    H0 = g0 = None
    n0 = 0
    for kind, (_, pl_, valid, nbrs, has, x6) in cases.items():
        pl_, valid, nbrs, has, x6 = (jnp.asarray(a) for a in (pl_, valid, nbrs, has, x6))
        Rm = js2m.lie.ypr_to_matrix(jnp.stack([x6[2], x6[1], x6[0]]) * (180.0 / np.pi))
        H, g, n = pallas_gn.gn_partials_packed(
            pallas_gn.pack_pts(pl_, valid), pallas_gn.pack_nbrs(nbrs, has),
            pallas_gn.pack_pose(Rm, x6[3:6], js2m._euler_jac_mats(x6)), kind=kind,
            interpret=True)
        H0 = np.asarray(H) if H0 is None else H0 + np.asarray(H)
        g0 = np.asarray(g) if g0 is None else g0 + np.asarray(g)
        n0 += int(n)
    c_blk, s_blk = _port_blocks(cases["corner"]), _port_blocks(cases["surf"])
    H1, g1, n1 = gnp.gn_partials_pair(*c_blk, *s_blk, _port_pose(cases["surf"][5]))
    assert int(n1) == n0 > 100
    np.testing.assert_allclose(H1.numpy(), H0, atol=2e-4 * np.abs(H0).max(), rtol=2e-4)
    np.testing.assert_allclose(g1.numpy(), g0, atol=2e-4 * np.abs(g0).max(), rtol=2e-4)
    assert gnp.LAUNCHES == 0  # CPU tensors never launch the kernel


def test_gn_partials_pair_plain_is_the_single_class_calls():
    cases = _gn_classes(1, 200)  # 200: not a multiple of the kernel's block
    c_blk, s_blk = _port_blocks(cases["corner"]), _port_blocks(cases["surf"])
    par = _port_pose(cases["corner"][5])
    Hc, gc, nc = gnp.gn_partials(*c_blk, par, "corner")
    Hs, gs, ns = gnp.gn_partials(*s_blk, par, "surf")
    H, g, n = gnp.gn_partials_pair(*c_blk, *s_blk, par)
    assert torch.equal(H, Hc + Hs) and torch.equal(g, gc + gs)
    assert n.dtype == torch.int32 and int(n) == int(nc) + int(ns)


def _hashes(rng):
    """A corner-like (B=32) and a surf-like (B=16) hash, with JAX twins."""
    out = []
    for M, T, B, span in ((2048, 1 << 11, 32, 6.0), (4096, 1 << 12, 16, 10.0)):
        pts = rng.uniform(-span, span, (M, 3)).astype(np.float32)
        out.append((pts, jvh.build(jnp.asarray(pts), jnp.ones(M, bool), 1.0, T, B),
                    tvh.build(_t(pts), torch.ones(M, dtype=torch.bool), 1.0, T, B)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_query_score_pair_matches_pallas_interpret(seed):
    """Both hashes re-scored after the queries moved from their gather-time
    positions, some far from every point (fewer than 5 candidates)."""
    rng = np.random.default_rng(seed)
    args_t, refs = [], []
    for (pts, hj, ht), Q in zip(_hashes(rng), (40, 70)):
        q0 = (pts[rng.integers(0, len(pts), Q)] + rng.normal(0, 0.3, (Q, 3))).astype(np.float32)
        q0[-2:] = 40.0  # exhausted queries
        q1 = (q0 + rng.normal(0, 0.05, (Q, 3))).astype(np.float32)
        refs.append(jvh.query_score(hj, jvh.query_gather(hj, jnp.asarray(q0)), jnp.asarray(q1),
                                    5, interpret=True))
        args_t += [ht, tvh.query_gather(ht, _t(q0)), _t(q1)]
    got = tvh.query_score_pair(*args_t, k=5)
    for (it, dt), (ij, dj) in zip(got, refs):
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
        assert (dt.numpy()[-2:] > 1e9).all()
    assert knn_tail.LAUNCHES == 0


def _knn_sets(seed):
    rng = np.random.default_rng(seed)
    sets = []
    for B, Q in ((32, 30), (16, 50)):
        cand = rng.integers(-2048, 2048, (Q, 27, 4, B)).astype(np.int16)
        cand[:, :, 3, :] = rng.integers(-1, 4, (Q, 27, B))
        sets.append((_t(cand.reshape(Q, -1)), _t(rng.integers(0, 4, (Q, 27)).astype(np.int32)),
                     _t(rng.uniform(-4096, 4096, (Q, 81)).astype(np.float32)), B))
    return sets


def test_knn_tail_pair_plain_is_the_single_set_calls():
    sets = _knn_sets(5)
    for (d, p), s in zip(knn_tail.knn_tail_pair(*sets, k=5), sets):
        d0, p0 = knn_tail.knn_tail(*s[:3], bucket=s[3], k=5)
        assert torch.equal(p, p0) and torch.equal(d, d0)


def _on_meta(tensors, which):
    """`tensors` with those at the indices `which` moved to the meta device
    (a second device that exists on every machine)."""
    return [t.to("meta") if i in which else t for i, t in enumerate(tensors)]


@pytest.mark.parametrize("which", [(3,), (0,), (4, 5), (1,)])
def test_knn_tail_pair_refuses_mixed_devices(which):
    """The path follows every tensor of both sets, not the first one: a mix
    raises instead of running the plain version on a card's tensors."""
    a, b = _knn_sets(6)
    t = _on_meta([*a[:3], *b[:3]], which)
    with pytest.raises(ValueError, match="different devices"):
        knn_tail.knn_tail_pair((*t[:3], a[3]), (*t[3:], b[3]), k=5)
    if max(which) < 3:
        with pytest.raises(ValueError, match="different devices"):
            knn_tail.knn_tail(*t[:3], bucket=a[3], k=5)
    assert knn_tail.LAUNCHES == 0


@pytest.mark.parametrize("which", [(2,), (0, 1), (4,), (1, 3)])
def test_gn_partials_pair_refuses_mixed_devices(which):
    cases = _gn_classes(2, 64)
    blocks = [*_port_blocks(cases["corner"]), *_port_blocks(cases["surf"]),
              _port_pose(cases["corner"][5])]
    t = _on_meta(blocks, which)
    with pytest.raises(ValueError, match="different devices"):
        gnp.gn_partials_pair(*t)
    if 4 in which:
        with pytest.raises(ValueError, match="different devices"):
            gnp.gn_partials(t[0], t[1], t[4], "corner")
    assert gnp.LAUNCHES == 0
