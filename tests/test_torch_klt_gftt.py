"""The port's Shi-Tomasi detection and pyramidal LK against the JAX package
on the CPU, on rendered frame pairs of the synthetic world.

Tolerances: `gftt.detect` exact (points, validity and order; the response
within 1e-7 of a maximum of ~0.03); `klt.track` status identical and points
within 1e-4 px (the window sums round in another order; measured equal on
these frames); the per-level patch fetch exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.ops import gftt as jg
from lvislam_tpu.ops import klt as jk
from lvislam_tpu.utils import synthetic as jsyn
from lvislam_tpu_torch.ops import gftt as tg
from lvislam_tpu_torch.ops import klt as tk

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frames():
    world = jsyn.default_world(seed=3)
    traj = jsyn.figure8_trajectory(scale=3.0, period=30.0)
    return [jsyn.render_camera_image(world, traj, t, width=320, height=240, f=200.0)
            for t in (1.0, 1.08)]


def test_shi_tomasi_response(frames):
    ref = np.asarray(jg.shi_tomasi_response(jnp.asarray(frames[0])))
    got = tg.shi_tomasi_response(_t(frames[0])).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


@pytest.mark.parametrize("cell,border,n_ex", [(16, 12, 16), (20, 10, 64)])
def test_detect_exact(frames, cell, border, n_ex):
    rng = np.random.default_rng(cell)
    ex = rng.uniform(0, 320, (n_ex, 2)).astype(np.float32)
    ex_valid = rng.random(n_ex) < 0.5
    pj, vj = jg.detect(jnp.asarray(frames[0]), jnp.asarray(ex), jnp.asarray(ex_valid),
                       max_pts=64, cell=cell, border=border)
    pt, vt = tg.detect(_t(frames[0]), _t(ex), _t(ex_valid), max_pts=64, cell=cell,
                       border=border)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert vt.sum() > 20


def _corner_image(frame):
    """A rendered frame with a bright square whose top-left corner lies in
    grid cell (0, 0) (the texture keeps the other cells' responses apart,
    so no tie is left to rounding)."""
    img = 0.3 * frame[:120, :160]
    img[14:60, 14:60] += 0.7
    return img


@pytest.mark.parametrize("tracked_slot", [0, 7])
def test_detect_cell_zero_duplicate_scatter(frames, tracked_slot):
    """The JAX quirk at `gftt.py:63-67`: free slots write False into cell
    (0, 0), and the scatter keeps the highest slot's write. A tracked
    feature in cell (0, 0) therefore excludes that cell only when no free
    slot comes after it. The port keeps that rule."""
    ex = np.zeros((8, 2), np.float32)
    ex[tracked_slot] = [15.0, 15.0]  # cell (0, 0) at cell=20
    ex_valid = np.zeros(8, bool)
    ex_valid[tracked_slot] = True
    img = _corner_image(frames[0])
    pj, vj = jg.detect(jnp.asarray(img), jnp.asarray(ex), jnp.asarray(ex_valid),
                       max_pts=16, cell=20, border=10)
    pt, vt = tg.detect(_t(img), _t(ex), _t(ex_valid), max_pts=16, cell=20, border=10)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    in_cell0 = ((pt[:, 0] < 20) & (pt[:, 1] < 20) & vt).any().item()
    # slot 0 tracked, slots 1..7 free and later: the cell is NOT excluded
    assert in_cell0 == (tracked_slot == 0)


@pytest.mark.parametrize("levels,half,iters", [(2, 7, 20), (3, 10, 30)])
def test_track_matches_jax(frames, levels, half, iters):
    pj, vj = jg.detect(jnp.asarray(frames[0]), jnp.zeros((1, 2)), jnp.zeros(1, bool),
                       max_pts=64, cell=16, border=12)
    rj = jk.track(jnp.asarray(frames[0]), jnp.asarray(frames[1]), pj, vj,
                  levels=levels, half=half, iters=iters)
    rt = tk.track(_t(frames[0]), _t(frames[1]), _t(pj), _t(vj),
                  levels=levels, half=half, iters=iters)
    status = np.asarray(rj.status)
    np.testing.assert_array_equal(rt.status.numpy(), status)
    assert status.sum() > 15
    np.testing.assert_allclose(rt.pts.numpy()[status], np.asarray(rj.pts)[status],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(rt.err.numpy(), np.asarray(rj.err), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(240, 320), (30, 40), (24, 200)])
def test_patches_match_row_block_fetch(shape):
    """The direct (N, S, S) gather reads what JAX's row-block gather +
    selection matmul reads, also on a level smaller than the patch, and on a
    level shorter than the patch and wider than one 128-lane block, where
    JAX's clamped flat index reads the last row's last block."""
    rng = np.random.default_rng(1)
    img = rng.random(shape).astype(np.float32)
    H, W = shape
    S = 32
    corners = np.stack([rng.integers(0, max(W - S, 0) + 1, 20),
                        rng.integers(0, max(H - S, 0) + 1, 20)], -1).astype(np.int32)
    ref, _ = jk._row_block_patches(jnp.asarray(img), jnp.asarray(corners), S)
    got = tk._patches(_t(img), _t(corners).long(), S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("W", [200, 320])
def test_track_on_a_short_wide_level_matches_jax(frames, W):
    """LK on a 24-row level wider than 128: shorter than the 32-pixel patch,
    so the patches' rows past the image come from JAX's clamped block
    fetch. The bottom row of points samples those rows (their status is
    false, their points and residuals still compared): repeating the last
    row instead moved them by up to 3 px and the residual by 0.05."""
    img0, img1 = (np.ascontiguousarray(f[100:124, 0:W]) for f in frames)
    xs, ys = np.meshgrid(np.linspace(12.0, W - 14.0, 12), [8.25, 11.0, 14.75, 20.5])
    pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    valid = np.ones(len(pts), bool)
    rj = jk.track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts), jnp.asarray(valid),
                  levels=0, half=5, iters=20)
    rt = tk.track(_t(img0), _t(img1), _t(pts), _t(valid), levels=0, half=5, iters=20)
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    assert np.asarray(rj.status).sum() > 5
    np.testing.assert_allclose(rt.pts.numpy(), np.asarray(rj.pts), atol=1e-4, rtol=0)
    np.testing.assert_allclose(rt.err.numpy(), np.asarray(rj.err), atol=1e-6, rtol=0)
