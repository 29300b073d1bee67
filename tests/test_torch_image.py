"""The port's image primitives and CLAHE (kernels K3/K4 through their plain
versions) against the JAX package on the CPU.

Tolerances: K3's tile histogram is bit-equal to the Pallas kernel in
interpret mode (exact integer counts). CLAHE within 1e-6 of both JAX paths
(the Pallas path and the scan path): the tolerance of JAX's own test
between its two paths; the cumulative sum and the blend round in another
order. Pyramids, gradients and bilinear sampling within 1e-6 (the same taps
in the same order; measured equal)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.ops import image as jim
from lvislam_tpu.ops import pallas_clahe as jpc
from lvislam_tpu_torch.ops import clahe as tcl
from lvislam_tpu_torch.ops import image as tim

torch.set_num_threads(1)


def _img(shape, seed=0):
    # squared uniform: a skewed histogram, so the clip limit binds
    return (np.random.default_rng(seed).random(shape).astype(np.float32)) ** 2


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(240, 320), (64, 1024)])
def test_tile_hist_plain_equals_pallas(shape):
    img = _img(shape)
    bins = (np.clip(img, 0.0, 1.0) * 255).astype(np.int32)
    ref = np.asarray(jpc.tile_hist(jnp.asarray(bins), tiles=8, n_bins=256, interpret=True))
    got = tcl.tile_hist(_t(img)).numpy()  # CPU tensor: the plain version
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == (shape[0] // 8) * (shape[1] // 8) * 64


def test_apply_cdf_plain_matches_pallas_apply_lut():
    """K4's direct 4-tile form against the TPU kernel's separable 3-row
    form (its x-pass table and row weights formed as `image.clahe` forms
    them), on the same CDF table."""
    H, W, T, B = 240, 320, 8, 256
    img = _img((H, W), seed=1)
    rng = np.random.default_rng(2)
    cdf = np.cumsum(rng.random((T * T, B)).astype(np.float32), axis=1)
    cdf = (cdf / cdf[:, -1:]).astype(np.float32)
    th, tw = H // T, W // T

    def lerp_mat(n, span):
        cc = (jnp.arange(n, dtype=jnp.float32) + 0.5) / span - 0.5
        i0 = jnp.clip(jnp.floor(cc).astype(jnp.int32), 0, T - 1)
        i1 = jnp.clip(i0 + 1, 0, T - 1)
        f = jnp.clip(cc - i0, 0.0, 1.0)
        r = jnp.arange(n)
        return jnp.zeros((n, T), jnp.float32).at[r, i0].add(1.0 - f).at[r, i1].add(f)

    cdf3 = jnp.asarray(cdf).reshape(T, T, B)
    vxt = jnp.einsum("ws,tsb->tbw", lerp_mat(W, tw), cdf3)
    y = jnp.arange(H)
    cc = (y.astype(jnp.float32) + 0.5) / th - 0.5
    t0 = jnp.clip(jnp.floor(cc).astype(jnp.int32), 0, T - 2)
    f = jnp.clip(cc - t0, 0.0, 1.0)
    bi = jnp.clip(y // th - 1, 0, T - 3)
    wy3 = jnp.zeros((H, 3), jnp.float32).at[y, t0 - bi].add(1.0 - f).at[y, t0 + 1 - bi].add(f)
    bins = (np.clip(img, 0.0, 1.0) * 255).astype(np.int32)
    ref = np.asarray(jpc.apply_lut(jnp.asarray(bins), wy3, vxt, tiles=T, n_bins=B,
                                   interpret=True))
    got = tcl.apply_cdf(_t(img), _t(cdf)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_clahe_matches_jax_paths(use_pallas):
    img = _img((240, 320), seed=3)
    ref = np.asarray(jim.clahe(jnp.asarray(img), use_pallas=use_pallas))
    got = tim.clahe(_t(img)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(100, 150), (37, 61)])
def test_clahe_ragged_matches_scan_path(shape):
    """H and W not divisible by 8: the histogram covers the cropped
    region, the blend the whole image."""
    img = _img(shape, seed=4)
    ref = np.asarray(jim.clahe(jnp.asarray(img), use_pallas=False))
    got = tim.clahe(_t(img)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_clahe_kernel_route_on_cpu_is_the_plain_route():
    img = _t(_img((96, 128), seed=5))
    n3, n4 = tcl.HIST_LAUNCHES, tcl.APPLY_LAUNCHES
    a = tim.clahe(img, use_kernels=True)
    b = tim.clahe(img, use_kernels=False)
    assert torch.equal(a, b)
    assert (tcl.HIST_LAUNCHES, tcl.APPLY_LAUNCHES) == (n3, n4)  # no launch on the CPU


def test_cumsum_last_matches_sequential_sum():
    x = torch.from_numpy(np.random.default_rng(6).random((64, 256)).astype(np.float32))
    ref = torch.cumsum(x.double(), dim=1)
    torch.testing.assert_close(tim._cumsum_last(x).double(), ref, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("width", [320, 321])
def test_pyr_down_even_and_odd_width(width):
    img = _img((61, width), seed=7)
    ref = np.asarray(jim.pyr_down(jnp.asarray(img)))
    got = tim.pyr_down(_t(img)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_build_pyramid_shapes_and_values():
    img = _img((64, 90), seed=8)
    ref = jim.build_pyramid(jnp.asarray(img), 3)
    got = tim.build_pyramid(_t(img), 3)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["scharr", "sobel"])
def test_gradients(kind):
    img = _img((50, 70), seed=9)
    ref = getattr(jim, f"{kind}_gradients")(jnp.asarray(img))
    got = getattr(tim, f"{kind}_gradients")(_t(img))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)


def test_bilinear_sample_and_patches():
    img = _img((60, 80), seed=10)
    rng = np.random.default_rng(11)
    xy = rng.uniform(-5.0, 85.0, (40, 7, 2)).astype(np.float32)  # some off the image
    np.testing.assert_allclose(
        tim.bilinear_sample(_t(img), _t(xy)).numpy(),
        np.asarray(jim.bilinear_sample(jnp.asarray(img), jnp.asarray(xy))), atol=1e-6, rtol=0)
    c = rng.uniform(5.0, 55.0, (12, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tim.extract_patches(_t(img), _t(c), 4).numpy(),
        np.asarray(jim.extract_patches(jnp.asarray(img), jnp.asarray(c), 4)), atol=1e-6, rtol=0)


def test_equalize_hist():
    img = _img((48, 64), seed=12)
    np.testing.assert_allclose(tim.equalize_hist(_t(img)).numpy(),
                               np.asarray(jim.equalize_hist(jnp.asarray(img))),
                               atol=1e-6, rtol=0)
