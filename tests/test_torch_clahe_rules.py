"""The host side of kernels K3 and K4 (`lvislam_tpu_torch/ops/clahe.py`),
which runs without a card: which kernel a shape and an address take, how
many bands K3 cuts a tile (a group of tiles) into, K3's blocks of tile
groups, the lattice blocks of the vector K4 and the column blocks of the
aligned K4.

The blocks are checked two ways: as a partition (every pixel in one block,
K4's blocks inside one lattice cell or two, 4-column alignment where the
kernels need it), and by running the kernels' arithmetic block by block: K3
counting each pixel into its tile of the block's group by the kernel's
compares, K4 with only each block's own window of tile CDFs. Both equal the
plain versions on the whole image bit for bit (K4: the same ops in the same
order on the same values). Last, K4's library yardstick in chip_smoke.py,
one `F.grid_sample`, against `apply_cdf_plain` within 1e-5 (its own blend
order)."""

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
    (64, 96, 8, 256, (0, 0, 0), ("vector", "aligned")),  # tw = 12: % 4 but not % 8
    (64, 128, 8, 250, (0, 0, 0), ("vector", "general")),  # CDF rows of 1000 bytes
    (576, 1024, 8, 256, (4, 0, 0), ("general", "general")),  # image 4 bytes off
    (576, 1024, 8, 256, (0, 8, 0), ("vector", "general")),  # CDFs 8 bytes off
    (576, 1024, 8, 256, (0, 0, 4), ("vector", "general")),  # result 4 bytes off
    (480, 752, 8, 256, (0, 0, 0), ("aligned", "aligned")),  # EuRoC: tw = 94, tw % 4 == 2
    (480, 756, 8, 256, (0, 0, 0), ("aligned", "aligned")),  # tw = 94, 4 spare columns
    (64, 72, 8, 256, (0, 0, 0), ("aligned", "aligned")),  # tw = 9: tw % 4 == 1
    (64, 88, 8, 256, (0, 0, 0), ("aligned", "aligned")),  # tw = 11: tw % 4 == 3
    (48, 92, 8, 256, (0, 0, 0), ("aligned", "aligned")),  # tw = 11, 4 spare columns
    (480, 752, 8, 256, (4, 0, 0), ("general", "general")),  # image 4 bytes off
    (480, 752, 8, 256, (0, 8, 0), ("aligned", "general")),  # CDFs 8 bytes off
    (480, 752, 8, 250, (0, 0, 0), ("aligned", "general")),  # CDF rows of 1000 bytes
    (480, 750, 8, 256, (0, 0, 0), ("general", "general")),  # W % 4
    (48, 32, 3, 256, (0, 0, 0), ("general", "aligned")),  # groups of 2 tiles, 3 tiles a row
    (16, 8, 8, 256, (0, 0, 0), ("aligned", "general")),  # tw = 1: K4 blocks need tw >= 4
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


@pytest.mark.parametrize("th,tiles,n_sm,group,row_vectors,want", [
    (60, 8, 132, 2, 47, 4),  # the EuRoC camera: 128 blocks of 15 rows x 47 vectors
    (60, 8, 132, 2, 0, 8),   # without the band floor: 256 blocks of 7 or 8 rows
    (72, 8, 132, 1, 0, 4),   # group 1 is the vector path's count
    (7, 8, 132, 4, 11, 1),   # tw = 11: 7 rows of 11 vectors already under the floor
    (7, 8, 132, 4, 0, 4),    # no more bands than rows, a power of two
    (60, 8, 16, 2, 47, 1),   # a small card
    (480, 4, 132, 2, 250, 8),  # a large tile: the blocks rule binds
])
def test_hist_slabs_of_tile_groups(th, tiles, n_sm, group, row_vectors, want):
    s = clahe.hist_slabs(th, tiles, n_sm, group, row_vectors)
    assert s == want
    assert all((k + 1) * th // s > k * th // s for k in range(s))
    assert s == 1 or not row_vectors or th // s * row_vectors >= 512


@pytest.mark.parametrize("H,W,ptr,want3,want4", [
    (576, 1024, 0, 4, (24, 0)),   # the rig: the vector kernels at their measured sizes
    (480, 752, 0, 4, (32, 64)),   # the EuRoC camera: the aligned kernels
    (480, 752, 4, 0, (0, 0)),     # a misaligned image: the general kernels
    (571, 1021, 0, 0, (0, 0)),    # W % 4
])
def test_launch_sizes_the_wrappers_pick(H, W, ptr, want3, want4):
    assert clahe.hist_launch(H, W, 8, ptr, 132) == want3
    assert clahe.apply_launch(H, W, 8, 256, ptr, 0, 0) == want4


_ALIGNED_SHAPES = [(480, 752, 8), (480, 756, 8), (64, 72, 8), (64, 88, 8), (40, 200, 4),
                   (16, 8, 8), (36, 12, 2), (576, 1024, 8), (148, 288, 4)]


@pytest.mark.parametrize("H,W,tiles", _ALIGNED_SHAPES)
def test_hist_blocks_partition_the_tiles_in_aligned_groups(H, W, tiles):
    """Wherever K3's path rule says "vector" or "aligned", at every band
    count the kernel takes: every pixel of the cropped region in one block,
    each block one band of a group of `hist_group` tiles of one tile row,
    whose columns start on a multiple of 4 and are a multiple of 4 wide (no
    16-byte load straddles two groups), and the grid's block order."""
    assert clahe.hist_path(H, W, tiles, 0) in ("vector", "aligned")
    th, tw, g = H // tiles, W // tiles, clahe.hist_group(W, tiles)
    assert g == (1 if tw % 4 == 0 else 2 if tw % 2 == 0 else 4)
    for slabs in (s for s in (1, 2, 3, 4, 8) if s <= th):
        blocks = clahe.hist_blocks(H, W, tiles, slabs)
        assert len(blocks) == tiles * tiles // g * slabs
        seen = np.zeros((th * tiles, tw * tiles), np.int32)
        for j, (y_lo, y_hi, x_lo, x_hi, t0) in enumerate(blocks):
            assert y_hi > y_lo and x_lo % 4 == 0 and x_hi - x_lo == g * tw and x_hi % 4 == 0
            assert y_lo // th == (y_hi - 1) // th == t0 // tiles  # one tile row
            assert x_lo == (t0 % tiles) * tw and (t0 % tiles) % g == 0
            group, slab = divmod(j, slabs)
            assert t0 == group * g and y_lo == t0 // tiles * th + slab * th // slabs
            seen[y_lo:y_hi, x_lo:x_hi] += 1
        assert (seen == 1).all()


def _hist_by_blocks(img, tiles, n_bins, slabs):
    """K3 as the vector and aligned kernels run it: block by block, each
    16-byte vector's four pixels counted into their tile of the block's
    group by the kernel's compares against the group's inner tile edges."""
    H, W = img.shape
    tw = W // tiles
    g = clahe.hist_group(W, tiles)
    counts = torch.zeros(tiles * tiles, n_bins, dtype=torch.int64)
    for y_lo, y_hi, x_lo, x_hi, t0 in clahe.hist_blocks(H, W, tiles, slabs):
        block = img[y_lo:y_hi, x_lo:x_hi].reshape(y_hi - y_lo, -1, 4)  # rows, vectors, 4
        col = (4 * torch.arange(block.shape[1]))[:, None] + torch.arange(4)[None, :]
        t = sum(((col >= k * tw).long() for k in range(1, g)), torch.zeros_like(col))
        keys = (t0 + t)[None].expand_as(block) * n_bins + clahe._bins(block, n_bins)
        counts += torch.bincount(keys.reshape(-1), minlength=tiles * tiles * n_bins).reshape(
            tiles * tiles, n_bins)
    return counts.to(torch.float32)


@pytest.mark.parametrize("H,W,tiles", _ALIGNED_SHAPES)
def test_hist_by_tile_groups_equals_plain(H, W, tiles):
    rng = np.random.default_rng(H + W)
    img = torch.from_numpy(rng.random((H, W), dtype=np.float32) ** 2)
    img[0, :4] = torch.tensor([-0.5, 0.0, 1.0, 1.5])  # out-of-range values clamp
    want = clahe.tile_hist_plain(img, tiles, 64)
    for slabs in (s for s in (1, 3, 8) if s <= H // tiles):
        assert torch.equal(_hist_by_blocks(img, tiles, 64, slabs), want)


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


@pytest.mark.parametrize("tiles", [1, 2, 3, 4, 8])
def test_column_blocks_of_the_aligned_kernel(tiles):
    """Over every W % 4 == 0 up to 12 tiles' worth where K4's path rule says
    "aligned", at every block width the entry point takes (a power of two
    from 4 to tw): the columns in order, each once, every block starting and
    ending on 4 columns, and its window, from its first pixel's left tap to
    its last pixel's right tap, 3 tile columns at most; the rows' lattice
    blocks add 2 tile rows at most."""
    n_aligned = 0
    for W in range(4 * tiles, 12 * tiles + 8, 4):
        if clahe.apply_path(24, W, tiles, 256, 0, 0, 0) != "aligned":
            continue
        n_aligned += 1
        tw = W // tiles
        i0, i1 = _taps(W, tiles)
        assert 4 <= clahe.apply_cols(tw) <= tw
        for cols in (c for c in (4, 8, 16, 32, 64, 128, 256) if c <= tw):
            blocks = clahe.column_blocks(W, cols)
            assert blocks[0][0] == 0 and blocks[-1][1] == W
            assert all(a[1] == b[0] for a, b in zip(blocks[:-1], blocks[1:]))
            assert all(lo % 4 == 0 and hi % 4 == 0 and 0 < hi - lo <= cols for lo, hi in blocks)
            assert all(i1[hi - 1] - i0[lo] + 1 <= 3 for lo, hi in blocks)
    assert n_aligned > 0


def test_column_blocks_at_the_euroc_shape():
    assert clahe.apply_cols(752 // 8) == 64
    blocks = clahe.column_blocks(752, 64)
    assert len(blocks) == 12 and blocks[-1] == (704, 752)
    rows = clahe.axis_blocks(480, 8, clahe.ALIGNED_ROWS)
    assert len(rows) == 16  # [0, 30) and [450, 480) whole; 7 cells of 60 in 32 + 28
    i0, i1 = _taps(752, 8)
    # a tile is 94 columns, so lattice cells start on odd columns (47, 141, ...)
    # and a block of 64 spans two of them where it holds one's edge
    assert [int(i1[hi - 1] - i0[lo] + 1) for lo, hi in blocks] == [2, 2, 3, 3, 2, 3, 3, 2, 3, 3, 2,
                                                                   2]


def test_axis_blocks_at_the_rig_shape():
    def grid(rows):
        return len(clahe.axis_blocks(1024, 8, 128)) * len(clahe.axis_blocks(576, 8, rows))

    assert (grid(12), grid(24), grid(36)) == (432, 225, 144)
    assert [hi - lo for lo, hi in clahe.axis_blocks(1024, 8, 128)] == [64] + [128] * 7 + [64]
    assert [hi - lo for lo, hi in clahe.axis_blocks(576, 8, 24)][:5] == [24, 12, 24, 24, 24]


def _apply_by_blocks(img, cdf, tiles, rows, cols, x_blocks=None):
    """K4 as the vector kernel runs it (or the aligned kernel, with its
    `x_blocks`): block by block, each pixel's four CDF values read from the
    block's own window of tiles, indexed relative to the window's first tile
    row and column."""
    H, W = img.shape
    n_bins = cdf.shape[1]
    r0, r1, wy0, wy1 = clahe._lerp_taps(H, tiles, H // tiles, "cpu")
    s0, s1, wx0, wx1 = clahe._lerp_taps(W, tiles, W // tiles, "cpu")
    cdf3 = cdf.reshape(tiles, tiles, n_bins)
    out = torch.full_like(img, float("nan"))
    for y_lo, y_hi in clahe.axis_blocks(H, tiles, rows):
        for x_lo, x_hi in x_blocks or clahe.axis_blocks(W, tiles, cols):
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


@pytest.mark.parametrize("H,W,tiles,n_bins,rows,cols", [
    (480, 752, 8, 256, 32, 64),  # the EuRoC camera, the wrapper's launch size
    (480, 752, 8, 256, 12, 16),
    (60, 92, 4, 64, 5, 16),      # tw = 23, th = 15: an odd tile height
    (50, 88, 8, 32, 7, 8),       # tw = 11, spare rows
    (21, 60, 3, 16, 24, 4),      # tw = 20, one-vector blocks
])
def test_apply_by_column_blocks_equals_plain(H, W, tiles, n_bins, rows, cols):
    assert clahe.apply_path(H, W, tiles, n_bins, 0, 0, 0) == "aligned"
    rng = np.random.default_rng(H * W + 1)
    img = torch.from_numpy(rng.random((H, W), dtype=np.float32) ** 2)
    cdf = torch.from_numpy(np.cumsum(rng.random((tiles * tiles, n_bins), dtype=np.float32), 1))
    cdf = cdf / cdf[:, -1:]
    got = _apply_by_blocks(img, cdf, tiles, rows, cols, clahe.column_blocks(W, cols))
    assert torch.equal(got, clahe.apply_cdf_plain(img, cdf, tiles))


@pytest.mark.parametrize("H,W", [(48, 96), (37, 64)])
def test_grid_sample_yardstick_matches_plain(H, W):
    """chip_smoke.py's library yardstick for K4 (one 5-D F.grid_sample at
    precomputed coordinates) computes K4's function: within
    GRID_SAMPLE_TOL = 1e-5 of `apply_cdf_plain`."""
    import chip_smoke

    rng = np.random.default_rng(W)
    img = torch.from_numpy(rng.random((H, W), dtype=np.float32) ** 2)
    img[0, :4] = torch.tensor([-0.5, 0.0, 1.0, 1.5])
    cdf = torch.from_numpy(np.cumsum(rng.random((64, 256), dtype=np.float32), 1))
    cdf = cdf / cdf[:, -1:]
    got = chip_smoke.grid_sample_apply(*chip_smoke.grid_sample_inputs(img, cdf))
    assert chip_smoke.GRID_SAMPLE_TOL == 1e-5
    assert float((got - clahe.apply_cdf_plain(img, cdf)).abs().max()) <= 1e-5
