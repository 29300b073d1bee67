"""The port's sliding-window feature table against the JAX package on the
CPU: every integer table and mask exactly, over a 15-frame sequence that
fills the window, replaces features, adopts lidar depths and slides both
ways; float fields within 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.models.vio import feature_manager as jfm
from lvislam_tpu_torch.models.vio import feature_manager as tfm
from lvislam_tpu_torch.utils import convert

torch.set_num_threads(1)

W, F, N = 4, 32, 16
CJ = jfm.VioCaps(window=W, max_features=F, imu_buf=16, frame_features=N)
CT = convert.vio_caps_from_jax(CJ)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_tables_equal(tj, tt, where):
    for name in tt._fields:
        a, b = np.asarray(getattr(tj, name)), getattr(tt, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (where, name)
        if a.dtype.kind in "ib":
            np.testing.assert_array_equal(b, a, err_msg=f"{where} {name}")
        else:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=f"{where} {name}")


def _frames(seed, n_frames=15):
    """Incoming frames: ids that die and are replaced (some twice in one
    frame: more new features than free slots late in the run), invalid rows,
    -1 ids, lidar depths on a third."""
    rng = np.random.default_rng(seed)
    ids, nxt = np.arange(N).astype(np.int32), N
    pos = rng.uniform(-0.5, 0.5, (400, 2)).astype(np.float32)
    out = []
    for k in range(n_frames):
        for i in range(N):
            if rng.random() < 0.25:
                ids[i], nxt = nxt, nxt + 1
        ids_in = np.where(rng.random(N) < 0.05, -1, ids).astype(np.int32)
        out.append(dict(
            ids=ids_in, valid=rng.random(N) < 0.85,
            norm=(pos[ids % 400] + 0.012 * k + rng.normal(0, 1e-3, (N, 2))).astype(np.float32),
            vel=rng.normal(size=(N, 2)).astype(np.float32),
            depth=np.where(rng.random(N) < 0.3, rng.uniform(2, 8, N), -1).astype(np.float32),
            rt=rng.uniform(0, 0.03, N).astype(np.float32),
            Ps=(0.1 * rng.normal(size=(W + 1, 3))).astype(np.float32),
            slide_new=rng.random() < 0.35))
    return out


def test_table_init_matches_jax():
    _assert_tables_equal(jfm.table_init(CJ), tfm.table_init(CT, device="cpu"), "init")


@pytest.mark.parametrize("seed,tensor_index", [(0, False), (1, True), (2, False)])
def test_fifteen_frames_tables_exact(seed, tensor_index):
    tj, tt = jfm.table_init(CJ), tfm.table_init(CT, device="cpu")
    Qs = np.tile(np.array([1, 0, 0, 0], np.float32), (W + 1, 1))
    eye, q1, z3 = np.eye(3, dtype=np.float32), np.array([1, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    fc, n_kf, slid = 0, 0, set()
    for k, fr in enumerate(_frames(seed)):
        fi = min(fc, W)
        args = [fr[x] for x in ("ids", "norm", "vel", "depth", "valid")]
        tj, kj = jfm.add_frame(tj, jnp.int32(fi), *map(jnp.asarray, args), CJ, in_rt=jnp.asarray(fr["rt"]))
        tt, kt = tfm.add_frame(tt, torch.tensor(fi, dtype=torch.int32) if tensor_index else fi,
                               *map(_t, args), CT, in_rt=_t(fr["rt"]))
        assert bool(kj) == bool(kt), k
        n_kf += bool(kt)
        _assert_tables_equal(tj, tt, f"add {k}")
        aj = jfm.triangulate_all(tj, jnp.asarray(fr["Ps"]), jnp.asarray(Qs), jnp.asarray(z3), jnp.asarray(q1), CJ)
        at = tfm.triangulate_all(tt, _t(fr["Ps"]), _t(Qs), _t(z3), _t(q1), CT)
        # triangulated depths: a 4x4 inverse power iteration in f32, on random
        # (often ill-conditioned) view geometry here
        np.testing.assert_allclose(at.inv_depth.numpy(), np.asarray(aj.inv_depth), atol=2e-5, rtol=1e-4)
        if fc < W:
            fc += 1
            continue
        if fr["slide_new"]:
            tj, tt = jfm.slide_new(tj, CJ), tfm.slide_new(tt, CT)
        else:
            tj = jfm.slide_old(tj, jnp.asarray(fr["Ps"][0]), jnp.asarray(eye),
                               jnp.asarray(fr["Ps"][1]), jnp.asarray(eye), CJ)
            tt = tfm.slide_old(tt, _t(fr["Ps"][0]), _t(eye), _t(fr["Ps"][1]), _t(eye), CT)
        slid.add(fr["slide_new"])
        _assert_tables_equal(tj, tt, f"slide {k}")
    assert slid == {True, False} and 0 < n_kf
    assert int((tt.ids >= 0).sum()) > 10 and bool(tt.lidar_flag.any())


def test_more_new_features_than_free_slots():
    """A full table takes what fits, in incoming order, as JAX does."""
    caps_j = jfm.VioCaps(window=W, max_features=8, imu_buf=16, frame_features=N)
    caps_t = convert.vio_caps_from_jax(caps_j)
    tj, tt = jfm.table_init(caps_j), tfm.table_init(caps_t, device="cpu")
    for k, fr in enumerate(_frames(3, 3)):
        args = [fr[x] for x in ("ids", "norm", "vel", "depth", "valid")]
        tj, _ = jfm.add_frame(tj, jnp.int32(k), *map(jnp.asarray, args), caps_j)
        tt, _ = tfm.add_frame(tt, k, *map(_t, args), caps_t)
        _assert_tables_equal(tj, tt, f"full {k}")
    assert int((tt.ids >= 0).sum()) == 8


def test_table_from_jax_round_trip():
    tj = jfm.table_init(CJ)
    _assert_tables_equal(tj, convert.table_from_jax(tj, "cpu"), "convert")
