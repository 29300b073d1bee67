"""The batched LIO step's lockstep Gauss-Newton (slice 11) on the CPU: the
batched forms of kernels K1 and K2 (their plain versions here), the batched
voxel-hash query sets, ``scan2map.scan_to_map_hashed_batched`` and
``batch_replay.make_batched_step`` against the port's own unbatched
functions bit for bit, and the lockstep GN against JAX's ``vmap`` of
``scan_to_map_hashed`` with its Pallas kernels in interpret mode.

Tolerances: every comparison with the port's unbatched functions is
``torch.equal`` (the batched forms must give each sequence its own bits);
against JAX, slice 1's bounds (25 mm, 2 mrad), ``converged`` equal and the
iteration counts within 1 (the convergence test meets the rounding drift
between the two, ROADMAP Queue 3)."""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.ops import scan2map as js2m, voxel_hash as jvh
from test_pallas_gn import _make_case as _pallas_gn_case
from lvislam_tpu_torch.core import lie as tlie
from lvislam_tpu_torch.models.lio import frontend as tfe
from lvislam_tpu_torch.models.lio import mapping as tmap
from lvislam_tpu_torch.ops import gn_partials as gnp
from lvislam_tpu_torch.ops import knn_tail as kt
from lvislam_tpu_torch.ops import scan2map as ts2m, voxel_hash as tvh
from lvislam_tpu_torch.parallel import batch_replay as tbr

import torch_lockstep_inputs as inputs
from test_torch_parallel import batch_inputs, port_cfg  # noqa: F401 (a fixture)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---- kernel K2 over a batch of sequences ----

def _gn_blocks(seed, n_c, n_s):
    """One sequence's K2 inputs: `tests/test_pallas_gn.py`'s corner and surf
    cases seen from one pose."""
    out = []
    for kind, n in (("corner", n_c), ("surf", n_s)):
        case = _pallas_gn_case(kind, np.random.default_rng(seed), n)
        pl_, valid, nbrs, has = (_t(a) for a in case[1:5])
        out += [gnp.pack_pts(pl_, valid), gnp.pack_nbrs(nbrs, has)]
    x6 = _t(np.random.default_rng(seed + 100).uniform(-0.3, 0.3, 6).astype(np.float32))
    out.append(gnp.pack_pose(tlie.x6_rotation(x6), x6[3:6], ts2m._euler_jac_mats(x6)))
    return out


@pytest.mark.parametrize("n_c,n_s", [(256, 512), (130, 77)])
def test_gn_partials_batched_plain_equals_unbatched(n_c, n_s):
    """Three sequences: (H, g, n_res) of each equal to its own
    `gn_partials_pair` (the plain version here), and the batched packers
    equal to the unbatched ones a sequence."""
    seqs = [_gn_blocks(seed, n_c, n_s) for seed in (0, 1, 2)]
    stacked = [torch.stack(x) for x in zip(*seqs)]
    n0 = gnp.LAUNCHES
    H, g, n = gnp.gn_partials_pair_batched(*stacked)
    assert gnp.LAUNCHES == n0  # the CPU takes the plain version
    assert H.shape == (3, 6, 6) and g.shape == (3, 6) and n.shape == (3,)
    assert n.dtype == torch.int32
    for s, blocks in enumerate(seqs):
        assert _equal((H[s], g[s], n[s]), gnp.gn_partials_pair(*blocks))
    pts = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 40, 3)).astype(np.float32))
    valid = torch.from_numpy(np.random.default_rng(4).random((3, 40)) > 0.3)
    nbrs = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 40, 5, 3)).astype(np.float32))
    has = torch.from_numpy(np.random.default_rng(6).random((3, 40, 5)) > 0.2)
    for s in range(3):
        assert torch.equal(gnp.pack_pts(pts, valid)[s], gnp.pack_pts(pts[s], valid[s]))
        assert torch.equal(gnp.pack_nbrs(nbrs, has)[s], gnp.pack_nbrs(nbrs[s], has[s]))


def test_gn_partials_batched_refuses_bad_inputs():
    """A call with tensors on two devices, mis-shaped blocks or float64
    raises, on the CPU as on the card."""
    c_p, c_n, s_p, s_n, par = [torch.stack(x) for x in zip(*[_gn_blocks(s, 128, 128)
                                                               for s in (0, 1)])]
    with pytest.raises(ValueError, match="different devices"):
        gnp.gn_partials_pair_batched(c_p, c_n, s_p, s_n, par.to("meta"))
    with pytest.raises(ValueError, match="bad shapes"):
        gnp.gn_partials_pair_batched(c_p, c_n, s_p, s_n, torch.cat([par, par]))
    with pytest.raises(ValueError, match="bad shapes"):
        gnp.gn_partials_pair_batched(c_p[:, :, :100], c_n, s_p, s_n, par)
    with pytest.raises(ValueError, match="bad shapes"):
        gnp.gn_partials_pair_batched(c_p[0], c_n[0], s_p[0], s_n[0], par[0])
    with pytest.raises(TypeError, match="float32"):
        gnp.gn_partials_pair_batched(c_p.double(), c_n, s_p, s_n, par)


# ---- kernel K1 and the voxel-hash query sets over a batch of sequences ----

def test_knn_tail_batched_plain_equals_unbatched():
    """K1's batched entry point over three sequences' stacked query sets
    (both classes) equals each sequence's own pair call; rows that do not
    split into S equal sequences, or tensors on two devices, raise."""
    worlds = [inputs.world(s) for s in (0, 1, 2)]
    sets = []
    for w in worlds:
        hc, hs = inputs.hashes(w)
        qc = _t(w[2]) + 0.1
        qs = _t(w[3]) - 0.1
        sets.append((tvh._query_set(hc, tvh.query_gather(hc, qc), qc),
                     tvh._query_set(hs, tvh.query_gather(hs, qs), qs)))
    stacked = [tuple(torch.cat([s[c][i] for s in sets]) for i in range(3)) + (sets[0][c][3],)
               for c in (0, 1)]
    got = kt.knn_tail_batched(stacked, 3, k=5)
    for s in range(3):
        ref = kt.knn_tail_pair(*sets[s], k=5)
        for c in (0, 1):
            assert torch.equal(got[c][0][s], ref[c][0]) and torch.equal(got[c][1][s], ref[c][1])
    with pytest.raises(ValueError, match="3 sequences"):
        kt.knn_tail_batched([tuple(t[:-1] for t in stacked[0][:3]) + (32,)], 3)
    with pytest.raises(ValueError, match="different devices"):
        kt.knn_tail_batched([stacked[0][:2] + (stacked[0][2].to("meta"), 32)], 3)


def test_batched_query_sets_equal_unbatched():
    """Over three hashes stacked (a leading sequence axis on every leaf):
    the gathered rows, K1's query sets, the global indices and distances of
    K1's stacked output (`_finish_batched`), and every batched query path
    equal each sequence's call alone; the stacked candidate rows start on a
    16-byte boundary (the kernel's vector loads at B = 16, 32)."""
    worlds = [inputs.world(s) for s in (0, 1, 2)]
    hs = [inputs.hashes(w) for w in worlds]
    hc_b, hs_b = tvh.stack([h[0] for h in hs]), tvh.stack([h[1] for h in hs])
    assert hc_b.rel.shape == (3, 1 << 12, 4, 32) and hc_b.cell.shape == (3,)
    qc = torch.stack([_t(w[2]) + 0.05 * (s + 1) for s, w in enumerate(worlds)])
    qs = torch.stack([_t(w[3]) - 0.05 * (s + 1) for s, w in enumerate(worlds)])
    gc, gs = tvh.query_gather_batched(hc_b, qc), tvh.query_gather_batched(hs_b, qs)
    for g in (gc, gs):
        row_bytes = g.cand.shape[1] * g.cand.element_size()
        assert g.cand.is_contiguous() and row_bytes % 16 == 0 and g.cand.data_ptr() % 16 == 0
    sets_b = [tvh._query_set_batched(hc_b, gc, qc), tvh._query_set_batched(hs_b, gs, qs)]
    pair_b = tvh.query_score_pair_batched(hc_b, gc, qc, hs_b, gs, qs, 5)
    fused_b = [tvh.query_fused_batched(hc_b, qc, 5), tvh.query_fused_batched(hs_b, qs, 5)]
    plain_b = [tvh.query_batched(hc_b, qc, 5), tvh.query_batched(hs_b, qs, 5)]
    for s, (hc, hsf) in enumerate(hs):
        g1 = [tvh.query_gather(hc, qc[s]), tvh.query_gather(hsf, qs[s])]
        for c, (gb, g) in enumerate(zip((gc, gs), g1)):
            rows = slice(s * g.cand.shape[0], (s + 1) * g.cand.shape[0])
            T = (hc, hsf)[c].rel.shape[0]
            assert torch.equal(gb.cand[rows], g.cand)
            assert torch.equal(gb.want_tag[rows], g.want_tag)
            assert torch.equal(gb.corner_s[rows], g.corner_s)
            assert torch.equal(gb.slots[rows], g.slots + s * T)
        sets1 = [tvh._query_set(hc, g1[0], qc[s]), tvh._query_set(hsf, g1[1], qs[s])]
        for sb, s1 in zip(sets_b, sets1):
            rows = slice(s * s1[0].shape[0], (s + 1) * s1[0].shape[0])
            assert all(torch.equal(a[rows], b) for a, b in zip(sb[:3], s1[:3]))
            assert sb[3] == s1[3]
        pair1 = tvh.query_score_pair(hc, g1[0], qc[s], hsf, g1[1], qs[s], 5)
        fused1 = [tvh.query_fused(hc, qc[s], 5), tvh.query_fused(hsf, qs[s], 5)]
        plain1 = [tvh.query(hc, qc[s], 5), tvh.query(hsf, qs[s], 5)]
        for got, ref in ((pair_b, pair1), (fused_b, fused1), (plain_b, plain1)):
            for (ib, db), (i1, d1) in zip(got, ref):
                assert torch.equal(ib[s], i1) and torch.equal(db[s], d1)
        # `_finish_batched` of K1's stacked output, sequence by sequence
        (d, p), = kt.knn_tail_batched([sets_b[1]], 3)
        i_b, d_b = tvh._finish_batched(hs_b, gs.slots, d, p, 16)
        i_1, d_1 = tvh.query_score(hsf, g1[1], qs[s], 5)
        assert torch.equal(i_b[s], i_1) and torch.equal(d_b[s], d_1)


# ---- the lockstep GN ----

SEQS, MAX_ITERS, FLAG_SETS = inputs.SEQS, inputs.MAX_ITERS, inputs.FLAG_SETS


@pytest.mark.parametrize("flags", list(FLAG_SETS.values()), ids=list(FLAG_SETS))
def test_lockstep_gn_equals_unbatched(flags):
    """`scan_to_map_hashed_batched` over three sequences equals
    `scan_to_map_hashed` on each alone, every GNState field bit for bit;
    on the kernels' main path the sequences converge at two different
    iterations and the third runs to MAX_ITERS. One host read an
    iteration."""
    from lvislam_tpu_torch.core import hostsync

    kw = dict(max_iters=MAX_ITERS, eigen_thresh=25.0, nn_refresh_every=2, **flags)
    args = inputs.gn_args(SEQS)
    ref = [ts2m.scan_to_map_hashed(*a, **kw) for a in args]
    hostsync.reset()
    got = ts2m.scan_to_map_hashed_batched(*inputs.stack_args(args), **kw)
    assert hostsync.COUNT == int(got.it.max())
    for s, r in enumerate(ref):
        for name, a, b in zip(r._fields, r, got):
            assert torch.equal(a, b[s]), (s, name)
    its = [int(r.it) for r in ref]
    if flags["use_pallas_gn"] and flags["gather_once"]:
        assert bool(ref[0].converged) and bool(ref[1].converged) and its[0] != its[1]
        assert its[2] == MAX_ITERS and not bool(ref[2].converged)


def test_lockstep_gn_matches_jax_vmap():
    """Two sequences through JAX's `vmap` of `scan_to_map_hashed` with both
    Pallas kernels in interpret mode (the batching rule adds the batch axis
    to their grids) against the port's lockstep GN: slice 1's bounds,
    `converged` equal, iteration counts within 1."""
    seqs = SEQS[:2]
    kw = dict(max_iters=MAX_ITERS, eigen_thresh=25.0, nn_refresh_every=2, use_pallas=True,
              gather_once=True, use_pallas_gn=True)
    got = ts2m.scan_to_map_hashed_batched(*inputs.stack_args(inputs.gn_args(seqs)), **kw)
    jargs = []
    for seed, share in seqs:
        mc, ms, cs, ss, xt = inputs.world(seed)
        hc = jvh.build(jnp.asarray(mc), jnp.ones(len(mc), bool), 1.0, 1 << 12, 32)
        hs = jvh.build(jnp.asarray(ms), jnp.ones(len(ms), bool), 1.0, 1 << 13, 16)
        jargs.append((jnp.asarray(xt * share), jnp.asarray(cs), jnp.ones(256, bool),
                      jnp.asarray(ss), jnp.ones(1024, bool), jnp.asarray(mc), jnp.asarray(ms),
                      hc, hs))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jargs)

    def one(*a):
        return js2m.scan_to_map_hashed(*a, pallas_interpret=True, **kw)

    stj = jax.vmap(one)(*stacked)
    x6j = np.asarray(stj.x6)
    np.testing.assert_allclose(got.x6.numpy()[:, 3:], x6j[:, 3:], atol=25e-3)
    np.testing.assert_allclose(got.x6.numpy()[:, :3], x6j[:, :3], atol=2e-3)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(stj.converged))
    assert np.abs(got.it.numpy() - np.asarray(stj.it)).max() <= 1


# ---- the batched step ----

@pytest.mark.parametrize("failing", [2, 1])
def test_make_batched_step_with_a_failing_gate(batch_inputs, failing):
    """Three sequences through `make_batched_step` (no mesh), one with no
    valid corner feature at step 3, so that its gate fails there while the
    others run the lockstep GN on the batched state's rows (a slice where
    the third fails, a stack where the second does): every sequence's
    outputs and state equal its own unbatched `map_step` run bit for bit."""
    from lvislam_tpu_torch.utils import convert

    caps, params = port_cfg()
    steps = []
    for i, (info, feats) in enumerate(batch_inputs):
        info = {k: _t(v) for k, v in info.items()}
        feats = tfe.FeatureResult(*[_t(x) for x in feats])
        info = {k: torch.cat([v, v[:1]]) for k, v in info.items()}
        feats = tfe.FeatureResult(*[torch.cat([x, x[:1]]) for x in feats])
        if i == 3:
            cv = feats.corner_valid.clone()
            cv[failing] = False
            feats = feats._replace(corner_valid=cv)
        steps.append((info, feats))
    step = tbr.make_batched_step(caps, params)
    state = tbr.batched_lio_init(caps, 3, device="cpu")
    outs = []
    for info, feats in steps:
        state, out = step(state, info, feats)
        outs.append(out)
    assert int(outs[3].gn_iters[failing]) == 0 and int(outs[3].gn_iters[0]) > 0
    for b in range(3):
        s = tmap.lio_init(caps, "cpu")
        for i, (info, feats) in enumerate(steps):
            s, out = tmap.map_step(s, {k: v[b] for k, v in info.items()},
                                   tfe.FeatureResult(*[x[b] for x in feats]), caps, params)
            for name, a, c in zip(out._fields, out, outs[i]):
                assert torch.equal(a, c[b]), (b, i, name)
        whole = convert.to_numpy(state)
        for name, a in convert.to_numpy(s).items():
            np.testing.assert_array_equal(a, whole[name][b], err_msg=name)


def test_map_step_is_its_three_parts(batch_inputs):
    """`map_step` equals `map_epilogue(map_gn(map_prologue))` called by
    hand, over the sequence of `batch_inputs`' first stream."""
    caps, params = port_cfg()
    s1 = s2 = tmap.lio_init(caps, "cpu")
    for info, feats in batch_inputs:
        info = {k: _t(v[0]) for k, v in info.items()}
        feats = tfe.FeatureResult(*[_t(x[0]) for x in feats])
        s1, o1 = tmap.map_step(s1, info, feats, caps, params)
        s2, pro = tmap.map_prologue(s2, info, feats, caps, params)
        st = tmap.map_gn(s2, pro, caps, params) if pro.run_gn else None
        s2, o2 = tmap.map_epilogue(s2, pro, st, info, feats, caps, params)
        assert _equal(o1, o2)
        assert all(torch.equal(a, b) for a, b in zip(tbr.leaves(s1), tbr.leaves(s2)))
