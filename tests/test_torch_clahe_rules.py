"""The host side of kernels K3 and K4 (`lvislam_tpu_torch/ops/clahe.py`),
which runs without a card: which kernel a shape and an address take, how
many bands K3 cuts a tile into, and the lattice blocks of the vector K4.

The blocks are checked two ways: as a partition (every pixel in one block,
blocks inside one lattice cell, 4-column alignment where the vector kernel
needs it), and by running K4's arithmetic block by block with only each
block's own window of tile CDFs, as the kernel does, against
`apply_cdf_plain` on the whole image: bit-equal, since the same ops run in
the same order on the same values."""

import numpy as np
import pytest
import torch

from lvislam_tpu_torch.ops import clahe

torch.set_num_threads(1)


@pytest.mark.parametrize("H,W,tiles,n_bins,ptrs,want", [
    (576, 1024, 8, 256, (0, 0, 0), ("vector", "vector")),
    (240, 320, 8, 256, (1 << 20, 512, 4096), ("vector", "vector")),
    (576, 1024, 4, 1024, (0, 0, 0), ("vector", "vector")),
    (580, 1028, 8, 256, (0, 0, 0), ("vector", "vector")),  # ragged rows, 4 spare columns
    (100, 150, 8, 256, (0, 0, 0), ("general", "general")),  # W % 4
    (37, 61, 8, 256, (0, 0, 0), ("general", "general")),
    (64, 96, 8, 256, (0, 0, 0), ("vector", "general")),  # tw = 12: % 4 but not % 8
    (64, 128, 8, 250, (0, 0, 0), ("vector", "general")),  # CDF rows of 1000 bytes
    (576, 1024, 8, 256, (4, 0, 0), ("general", "general")),  # image 4 bytes off
    (576, 1024, 8, 256, (0, 8, 0), ("vector", "general")),  # CDFs 8 bytes off
    (576, 1024, 8, 256, (0, 0, 4), ("vector", "general")),  # result 4 bytes off
])
def test_clahe_path_rule(H, W, tiles, n_bins, ptrs, want):
    assert clahe.hist_path(H, W, tiles, ptrs[0]) == want[0]
    assert clahe.apply_path(H, W, tiles, n_bins, *ptrs) == want[1]


@pytest.mark.parametrize("th,tiles,n_sm,want", [
    (72, 8, 132, 4),    # the rig: 256 blocks of 18 rows
    (144, 4, 132, 8),   # 16 tiles: the largest cluster
    (3, 8, 132, 2),     # no more bands than rows, a power of two
    (1, 8, 132, 1),
    (8, 1, 132, 8),
    (72, 16, 132, 1),   # 256 tiles fill the card as they are
    (72, 8, 16, 1),     # a small card
])
def test_hist_slabs(th, tiles, n_sm, want):
    s = clahe.hist_slabs(th, tiles, n_sm)
    assert s == want
    # the kernel's bands [k*th/s, (k+1)*th/s) are never empty
    assert all((k + 1) * th // s > k * th // s for k in range(s))


def _taps(n, tiles):
    i0, i1, _, _ = clahe._lerp_taps(n, tiles, n // tiles, "cpu")
    return i0.numpy(), i1.numpy()


@pytest.mark.parametrize("tiles", [1, 2, 3, 8])
@pytest.mark.parametrize("size", [1, 4, 12, 24, 128])
def test_axis_blocks_partition_the_axis_inside_lattice_cells(tiles, size):
    """Over every length from `tiles` to 12 tiles' worth and a remainder:
    tiles of odd and even span, with and without spare pixels."""
    for n in range(tiles, 12 * tiles + 7):
        blocks = clahe.axis_blocks(n, tiles, size)
        # in order, each pixel once, none empty, none over `size`
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(blocks[:-1], blocks[1:]))
        assert all(0 < hi - lo <= size for lo, hi in blocks)
        # one lattice cell: every pixel of a block has the same two taps, so
        # the kernel's window (first pixel's i0 to last pixel's i1) is 2 tiles
        i0, i1 = _taps(n, tiles)
        for lo, hi in blocks:
            assert (i0[lo:hi] == i0[lo]).all() and (i1[lo:hi] == i1[lo]).all()
            assert i1[hi - 1] - i0[lo] + 1 <= 2


@pytest.mark.parametrize("W,tiles", [(1024, 8), (1028, 8), (320, 8), (64, 1), (8, 1), (4096, 4)])
def test_axis_blocks_of_the_vector_kernel_start_on_four_columns(W, tiles):
    """Wherever the path rule says "vector" (tw % 8 == 0), every block of a
    power-of-two width from 4 to 256 columns starts and ends on 4 columns."""
    assert clahe.apply_path(24, W, tiles, 256, 0, 0, 0) == "vector"
    for cols in (4, 8, 16, 32, 64, 128, 256):
        blocks = clahe.axis_blocks(W, tiles, cols)
        assert all(lo % 4 == 0 and hi % 4 == 0 for lo, hi in blocks)


def test_axis_blocks_at_the_rig_shape():
    def grid(rows):
        return len(clahe.axis_blocks(1024, 8, 128)) * len(clahe.axis_blocks(576, 8, rows))

    assert (grid(12), grid(24), grid(36)) == (432, 225, 144)
    assert [hi - lo for lo, hi in clahe.axis_blocks(1024, 8, 128)] == [64] + [128] * 7 + [64]
    assert [hi - lo for lo, hi in clahe.axis_blocks(576, 8, 24)][:5] == [24, 12, 24, 24, 24]


def _apply_by_blocks(img, cdf, tiles, rows, cols):
    """K4 as the vector kernel runs it: block by block, each pixel's four
    CDF values read from the block's own window of tiles, indexed relative
    to the window's first tile row and column."""
    H, W = img.shape
    n_bins = cdf.shape[1]
    r0, r1, wy0, wy1 = clahe._lerp_taps(H, tiles, H // tiles, "cpu")
    s0, s1, wx0, wx1 = clahe._lerp_taps(W, tiles, W // tiles, "cpu")
    cdf3 = cdf.reshape(tiles, tiles, n_bins)
    out = torch.full_like(img, float("nan"))
    for y_lo, y_hi in clahe.axis_blocks(H, tiles, rows):
        for x_lo, x_hi in clahe.axis_blocks(W, tiles, cols):
            rlo, rhi = int(r0[y_lo]), int(r1[y_hi - 1])
            clo, chi = int(s0[x_lo]), int(s1[x_hi - 1])
            assert rhi - rlo < 3 and chi - clo < 3  # the kernel's capacity
            win = cdf3[rlo:rhi + 1, clo:chi + 1]
            ys, xs = slice(y_lo, y_hi), slice(x_lo, x_hi)
            b = clahe._bins(img[ys, xs], n_bins)

            def tap(r, s):
                return win[(r[ys] - rlo)[:, None], (s[xs] - clo)[None, :], b]

            a0 = wy0[ys, None] * tap(r0, s0) + wy1[ys, None] * tap(r1, s0)
            a1 = wy0[ys, None] * tap(r0, s1) + wy1[ys, None] * tap(r1, s1)
            assert torch.isnan(out[ys, xs]).all()  # no pixel twice
            out[ys, xs] = wx0[None, xs] * a0 + wx1[None, xs] * a1
    return out


@pytest.mark.parametrize("H,W,tiles,n_bins,rows,cols", [
    (72, 128, 8, 256, 24, 16),   # the rig's shape at an eighth: even tiles
    (45, 80, 5, 64, 4, 16),      # th = 9: an odd tile height
    (50, 72, 3, 32, 7, 8),       # spare rows, tw = 24
    (21, 8, 1, 16, 24, 8),       # one tile
    (19, 40, 4, 8, 3, 4),        # th = 4, spare rows
])
def test_apply_by_lattice_blocks_equals_plain(H, W, tiles, n_bins, rows, cols):
    rng = np.random.default_rng(H * W)
    img = torch.from_numpy(rng.random((H, W), dtype=np.float32) ** 2)
    cdf = torch.from_numpy(np.cumsum(rng.random((tiles * tiles, n_bins), dtype=np.float32), 1))
    cdf = cdf / cdf[:, -1:]
    got = _apply_by_blocks(img, cdf, tiles, rows, cols)
    assert torch.equal(got, clahe.apply_cdf_plain(img, cdf, tiles))
