"""The port's voxel hash and kernel K1's plain version against the JAX
package: tables, counts and indices bit-identical; query indices exact and
distances within rtol 1e-6 (both score in the same scaled f32 domain); the
fused tail equal to the JAX Pallas kernel run in interpret mode, including
the padded block and queries with fewer than 5 candidates."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.ops import pallas_knn, voxel_hash as jvh
from lvislam_tpu_torch.ops import knn_tail, voxel_hash as tvh

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _hash_pair(rng, M, T, B, valid_frac=0.9, span=10.0):
    pts = rng.uniform(-span, span, (M, 3)).astype(np.float32)
    val = rng.random(M) < valid_frac
    hj = jvh.build(jnp.asarray(pts), jnp.asarray(val), 1.0, T, B)
    ht = tvh.build(_t(pts), _t(val), 1.0, T, B)
    return pts, val, hj, ht


def _assert_same_hash(hj, ht):
    np.testing.assert_array_equal(np.asarray(hj.rel), ht.rel.numpy())
    np.testing.assert_array_equal(np.asarray(hj.cnt), ht.cnt.numpy())
    np.testing.assert_array_equal(np.asarray(hj.idx), ht.idx.numpy())
    assert ht.rel.dtype == torch.int16 and ht.idx.dtype == torch.int32


@pytest.mark.parametrize("T,B,span", [(1 << 12, 16, 10.0), (1 << 10, 16, 3.0),
                                      (1 << 10, 32, 10.0)])
def test_build_bit_identical(T, B, span):
    # a 6 m box holds ~28 points per 1 m cell: buckets overflow, and the
    # stable sort must pick the survivors exactly as jnp.argsort does
    _, _, hj, ht = _hash_pair(np.random.default_rng(T), 6000, T, B, span=span)
    _assert_same_hash(hj, ht)
    if span < 5.0:
        assert int(ht.cnt.max()) == B


def test_slot_and_tag_hashes_match_uint32_arithmetic():
    rng = np.random.default_rng(3)
    c = rng.integers(-40000, 40000, (5000, 3)).astype(np.int32)
    cj = [jnp.asarray(c[:, i]) for i in range(3)]
    ct = [_t(c[:, i]) for i in range(3)]
    np.testing.assert_array_equal(np.asarray(jvh._slot(*cj, 1 << 16)),
                                  tvh._slot(*ct, 1 << 16).numpy())
    np.testing.assert_array_equal(np.asarray(jvh._tag(*cj)), tvh._tag(*ct).numpy())


def test_insert_bit_identical():
    rng = np.random.default_rng(1)
    pts, val, hj, ht = _hash_pair(rng, 3000, 1 << 11, 16)
    new = rng.uniform(-10, 10, (800, 3)).astype(np.float32)
    nval = rng.random(800) < 0.8
    gidx = np.arange(3000, 3800, dtype=np.int32)
    hj2 = jvh.insert(hj, jnp.asarray(new), jnp.asarray(nval), jnp.asarray(gidx))
    ht2 = tvh.insert(ht, _t(new), _t(nval), _t(gidx))
    _assert_same_hash(hj2, ht2)


def test_query_matches_jax():
    rng = np.random.default_rng(2)
    pts, _, hj, ht = _hash_pair(rng, 4096, 1 << 12, 32)
    q = (pts[rng.integers(0, 4096, 300)] + rng.normal(0, 0.4, (300, 3))).astype(np.float32)
    ij, dj = jvh.query(hj, jnp.asarray(q), 5)
    it, dt = tvh.query(ht, _t(q), 5)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), rtol=1e-6)


def test_query_score_matches_pallas_interpret_with_padding_and_exhaustion():
    """Q=33 is not a multiple of the Pallas block (padded lanes), and the
    last three queries sit far from every point (fewer than 5 candidates:
    the fill positions must match the kernel's too)."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (512, 3)).astype(np.float32)
    pts[:3] = 20.0 + rng.uniform(0, 1, (3, 3))  # an isolated 3-point cluster
    hj = jvh.build(jnp.asarray(pts), jnp.ones(512, bool), 1.0, 1 << 10, 16)
    ht = tvh.build(_t(pts), torch.ones(512, dtype=torch.bool), 1.0, 1 << 10, 16)
    q = np.concatenate([rng.uniform(-5, 5, (30, 3)), np.full((3, 3), 50.0)]).astype(np.float32)
    q[:2] = 20.5  # near the cluster: 3 candidates, 2 fill positions

    gj = jvh.query_gather(hj, jnp.asarray(q))
    gt = tvh.query_gather(ht, _t(q))
    np.testing.assert_array_equal(np.asarray(gj.cand), gt.cand.numpy())
    ij, dj = jvh.query_score(hj, gj, jnp.asarray(q), 5, interpret=True)
    it, dt = tvh.query_score(ht, gt, _t(q), 5)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), rtol=1e-6)
    assert (dt.numpy()[30:] > 1e9).all()
    n_found = (dt.numpy() < 1e9).sum(1)
    assert ((n_found > 0) & (n_found < 5)).any()


@pytest.mark.parametrize("B", [16, 32])
def test_knn_tail_plain_matches_pallas_kernel(B):
    """Kernel K1's plain version against `pallas_knn.topk_tail` itself on
    raw inputs (random tags, so many lanes are masked): positions exact,
    distances rtol 1e-6."""
    rng = np.random.default_rng(B)
    Q = 70
    cand = rng.integers(-2048, 2048, (Q, 27, 4, B)).astype(np.int16)
    want = rng.integers(0, 6, (Q, 27)).astype(np.int32)
    cand[:, :, 3, :] = rng.integers(-1, 6, (Q, 27, B))
    cand[-2:, :, 3, :] = -1  # exhausted rows: every lane empty
    off = rng.uniform(-4096, 4096, (Q, 81)).astype(np.float32)
    cand = cand.reshape(Q, 27 * 4 * B)
    dj, pj = pallas_knn.topk_tail(jnp.asarray(cand), jnp.asarray(want),
                                  jnp.asarray(off), bucket=B, k=5,
                                  interpret=True)
    dt, pt = knn_tail.knn_tail(_t(cand), _t(want), _t(off), bucket=B, k=5)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), rtol=1e-6)
    assert knn_tail.LAUNCHES == 0  # CPU tensors never launch the kernel


def test_query_fused_equals_query():
    rng = np.random.default_rng(6)
    pts, _, _, ht = _hash_pair(rng, 4096, 1 << 12, 16, valid_frac=1.0, span=8.0)
    q = _t(rng.uniform(-6, 6, (200, 3)).astype(np.float32))
    i0, d0 = tvh.query(ht, q, 5)
    i1, d1 = tvh.query_fused(ht, q, 5)
    assert torch.equal(i0.to(torch.int64), i1.to(torch.int64))
    assert torch.equal(d0, d1)


def test_knn_tail_rejects_unsupported_devices():
    x = torch.zeros((1, 27 * 4 * 16), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        knn_tail.knn_tail(x, torch.zeros((1, 27), dtype=torch.int32, device="meta"),
                          torch.zeros((1, 81), device="meta"), bucket=16)
