"""Kernels K1-K4 on the card against their plain PyTorch versions (the
CPU tests reach only the plain versions: a CUDA kernel has no interpret
mode). Marked `cuda`; each test skips when no CUDA device is present. Run on
a GPU machine from the repository root with
`python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py`
(`--noconftest`: the test tree's conftest imports JAX).

Tolerances: K1 positions identical and distances within rtol 1e-6 (same f32
op order, explicitly rounded); K2's H and g of each class within 2e-4 of
that class's scale and the residual count exact (the block sums run in
another order, and K2's multiply-adds are contracted into FMAs); K2's one
launch for both classes bit-equal to the per-class path (block rows,
torch.sum, then the add). K2 is checked on neighbourhoods from the
synthetic world, as the step sees them. On random thin planes the
f32 plane fit is ill-conditioned, and rounding alone moves the sums past
2e-4 of scale: on such cases the TPU kernel in interpret mode differs from
the JAX XLA path by up to 8e-3 of scale. K3's counts and K4's pixels
identical (K4 rounds every op on its own in the plain version's order), at
the rig's 576x1024, at the EuRoC camera's 480x752 (the aligned kernels), at
shapes that take each branch of the vector and aligned kernels and at shapes
that take the general ones."""

import os

import numpy as np
import pytest
import torch

from lvislam_tpu_torch.ops import clahe
from lvislam_tpu_torch.ops import gn_partials as gnp
from lvislam_tpu_torch.ops import image as imops
from lvislam_tpu_torch.ops import knn_tail as kt

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels K1-K4 run only on the card")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def step_inputs(cuda):
    """chip_smoke.py's parity inputs: map points on the synthetic world's
    surfaces and edges, their voxel hashes, and perturbed queries."""
    import chip_smoke

    return chip_smoke.parity_inputs(cuda)


def _random_knn_set(cuda, B, Q, seed):
    rng = np.random.default_rng(seed)
    cand = rng.integers(-2048, 2048, (Q, 27, 4, B)).astype(np.int16)
    cand[:, :, 3, :] = rng.integers(-1, 4, (Q, 27, B))
    cand[Q - 1:, :, 3, :] = -1  # an exhausted query
    want = rng.integers(0, 4, (Q, 27)).astype(np.int32)
    off = rng.uniform(-4096, 4096, (Q, 81)).astype(np.float32)
    return [torch.as_tensor(a, device=cuda) for a in (cand.reshape(Q, 27 * 4 * B), want, off)] + [B]


@pytest.mark.parametrize("B,Q", [(16, 2048), (32, 512), (16, 37), (7, 100), (24, 64)])
def test_knn_tail_kernel_matches_plain(cuda, B, Q):
    """One query set (the pair launch with the other set empty), at the
    compiled buckets 16 and 32 and at buckets given at run time."""
    *args, _ = _random_knn_set(cuda, B, Q, B + Q)
    n0 = kt.LAUNCHES
    d1, p1 = kt.knn_tail(*args, bucket=B, k=5)
    d0, p0 = kt.knn_tail_plain(*args, bucket=B, k=5)
    torch.cuda.synchronize()
    assert kt.LAUNCHES == n0 + 1
    assert torch.equal(p1, p0)
    torch.testing.assert_close(d1, d0, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("sets", [((32, 512), (16, 2048)), ((16, 37), (7, 5)), ((32, 3), (32, 0)),
                                  ((32, 3001), (16, 12007))])
def test_knn_tail_pair_matches_plain(cuda, sets):
    """Two query sets in one launch, an empty one among them; the last case
    holds more queries than the card keeps warps, so each persistent warp
    takes several, from both sets."""
    a, b = (_random_knn_set(cuda, B, Q, 7 * B + Q) for B, Q in sets)
    n0 = kt.LAUNCHES
    got = kt.knn_tail_pair(a, b, k=5)
    ref = kt.knn_tail_pair_plain(a, b, k=5)
    torch.cuda.synchronize()
    assert kt.LAUNCHES == n0 + 1
    for (d1, p1), (d0, p0) in zip(got, ref):
        assert torch.equal(p1, p0)
        assert torch.equal(d1, d0)


@pytest.mark.parametrize("n_c,n_s", [(512, 2048), (200, 300), (128, 128)])
def test_step_kernels_match_plain(step_inputs, n_c, n_s):
    """Both pair kernels at the LIO step's shapes (and ragged last blocks)
    on realistic neighbourhoods, through chip_smoke.py's own checks."""
    import chip_smoke

    corner, surf, h_c, h_s, q_c, q_s, x6 = step_inputs
    n1, n2 = kt.LAUNCHES, gnp.LAUNCHES
    chip_smoke.check_knn_pair([chip_smoke.knn_set(h_c, q_c[:n_c]),
                               chip_smoke.knn_set(h_s, q_s[:n_s])], ("corner", "surf"))
    chip_smoke.check_gn_pair([chip_smoke.gn_blocks(h_c, corner, q_c[:n_c], x6),
                              chip_smoke.gn_blocks(h_s, surf, q_s[:n_s], x6)],
                             chip_smoke.gn_pose(x6))
    assert kt.LAUNCHES > n1 and gnp.LAUNCHES > n2


@pytest.mark.parametrize("N", [128, 512, 2048])
def test_gn_pair_bit_equal_to_per_class_path(step_inputs, N):
    """K2's one launch for both classes gives the bits of the per-class path
    (each class's block rows summed by torch.sum, then added), with N
    points in each class."""
    import chip_smoke

    corner, surf, h_c, h_s, q_c, q_s, x6 = step_inputs
    blocks = [chip_smoke.gn_blocks(h_c, corner, torch.cat([q_c] * 4)[:N], x6),
              chip_smoke.gn_blocks(h_s, surf, q_s[:N], x6)]
    par = chip_smoke.gn_pose(x6)
    n0 = gnp.LAUNCHES
    got = gnp.gn_partials_pair(*blocks[0], *blocks[1], par)
    assert gnp.LAUNCHES == n0 + 1
    raw, per_class = chip_smoke.gn_per_class_path(*blocks[0], *blocks[1], par)
    assert chip_smoke.bits_equal(raw, per_class)
    assert chip_smoke.bits_equal(got, raw)
    assert int(got[2]) > N // 2


def test_wrappers_refuse_bad_inputs_on_the_card(cuda):
    with pytest.raises(TypeError):
        kt.knn_tail(torch.zeros((2, 27 * 4 * 16), dtype=torch.int32, device=cuda),
                    torch.zeros((2, 27), dtype=torch.int32, device=cuda),
                    torch.zeros((2, 81), device=cuda), bucket=16)
    # a contiguous row view 2 bytes past a 16-byte boundary
    buf = torch.zeros(2 * 27 * 4 * 16 + 1, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        kt.knn_tail(buf[1:].view(2, 27 * 4 * 16), torch.zeros((2, 27), dtype=torch.int32,
                                                               device=cuda),
                    torch.zeros((2, 81), device=cuda), bucket=16)
    with pytest.raises(ValueError):
        gnp.gn_partials(torch.zeros((8, 4), device=cuda), torch.zeros((20, 4), device=cuda),
                        torch.zeros(39, device=cuda), "surf")
    # one set on the CPU, the other on the card: neither path may take it
    cpu_set = _random_knn_set(torch.device("cpu"), 16, 8, 1)
    card_set = _random_knn_set(cuda, 32, 8, 2)
    n0 = kt.LAUNCHES
    for pair in ((cpu_set, card_set), (card_set, cpu_set)):
        with pytest.raises(ValueError):
            kt.knn_tail_pair(*pair, k=5)
    blocks = [torch.zeros((8, 4)), torch.zeros((24, 4))]
    n2 = gnp.LAUNCHES
    with pytest.raises(ValueError):
        gnp.gn_partials_pair(*blocks, *(b.to(cuda) for b in blocks), torch.zeros(39, device=cuda))
    with pytest.raises(ValueError):
        gnp.gn_partials_pair(*blocks, *blocks, torch.zeros(39, device=cuda))
    assert (kt.LAUNCHES, gnp.LAUNCHES) == (n0, n2)
    with pytest.raises(ValueError):
        gnp.gn_partials_pair(torch.zeros((8, 4), device=cuda), torch.zeros((24, 4), device=cuda),
                             torch.zeros((8, 5), device=cuda), torch.zeros((24, 4), device=cuda),
                             torch.zeros(39, device=cuda))


def _clahe_image(cuda, H, W):
    rng = np.random.default_rng(H + W)
    img = torch.as_tensor(rng.random((H, W), dtype=np.float32) ** 2, device=cuda)
    img[0, :4] = torch.tensor([-0.5, 0.0, 1.0, 1.5])  # out-of-range values clamp
    return img


@pytest.mark.parametrize("H,W,tiles,n_bins", [
    (576, 1024, 8, 256), (240, 320, 8, 256),
    (100, 150, 8, 256), (37, 61, 8, 256),  # the general kernels
    (576, 1024, 4, 1024),  # 8 slabs of 18 rows; 4 KB a warp histogram
    (584, 1024, 8, 256),   # th = 73: slabs of 18, 18, 18 and 19 rows
    (580, 1028, 8, 256),   # spare rows and 4 spare columns in the last lattice cells
    (64, 96, 8, 256),      # tw = 12: the vector K3 with the aligned K4
    (480, 752, 8, 256),    # the EuRoC camera: tw = 94, groups of 2 tiles, blocks of 64 columns
    (480, 756, 8, 256),    # tw = 94 and 4 spare columns in the last block
    (64, 72, 8, 256),      # tw = 9: groups of 4 tiles, blocks of 8 columns
    (60, 88, 8, 1024),     # tw = 11, th = 7: 4 KB a tile's counters, 16 KB a warp's
    (48, 32, 3, 256),      # tw = 10, 3 tiles: the general K3 (3 % 2), the aligned K4
    (16, 8, 8, 256),       # tw = 1: the aligned K3 (groups of 4 one-column tiles), general K4
    (40, 200, 4, 4096),    # tw = 50: one warp's 2 x 4096 counters
    (40, 196, 4, 4096),    # tw = 49: one warp's 4 x 4096 counters, 64 KB
    (16, 64, 8, 256),      # th = 2: two slabs of one row
    (8, 8, 1, 256),        # one tile, the smallest vector shape
    (96, 256, 4, 4096),    # 3 warps a block in K3; K4's window over 48 KB
    (90, 2304, 2, 64),     # a lattice cell wider than a block's 256 columns
])
def test_clahe_kernels_match_plain(cuda, H, W, tiles, n_bins):
    img = _clahe_image(cuda, H, W)
    n3, n4 = clahe.HIST_LAUNCHES, clahe.APPLY_LAUNCHES
    h1 = clahe.tile_hist(img, tiles, n_bins)
    h0 = clahe.tile_hist_plain(img, tiles, n_bins)
    cdf = imops.clip_cdf(h0, (H // tiles) * (W // tiles))
    o1 = clahe.apply_cdf(img, cdf, tiles)
    o0 = clahe.apply_cdf_plain(img, cdf, tiles)
    torch.cuda.synchronize()
    assert (clahe.HIST_LAUNCHES, clahe.APPLY_LAUNCHES) == (n3 + 1, n4 + 1)
    assert torch.equal(h1, h0)
    assert torch.equal(o1, o0)


@pytest.mark.parametrize("view", ["four_bytes_off", "strided", "cdf_eight_bytes_off"])
def test_clahe_kernels_on_views(cuda, view):
    """A contiguous view off the 16-byte grid takes the general kernels by
    the path rule; a strided view is copied, and the copy is aligned."""
    H, W = 144, 256
    img = _clahe_image(cuda, H, 2 * W)
    if view == "four_bytes_off":
        img = torch.cat([img.reshape(-1)[:1], img[:, :W].reshape(-1)])[1:].view(H, W)
        assert img.is_contiguous() and img.data_ptr() % 16 == 4
        assert clahe.hist_path(H, W, 8, img.data_ptr()) == "general"
    elif view == "strided":
        img = img[:, ::2]
        assert not img.is_contiguous()
    else:
        img = img[:, :W].contiguous()
    h0 = clahe.tile_hist_plain(img)
    cdf = imops.clip_cdf(h0, (H // 8) * (W // 8))
    if view == "cdf_eight_bytes_off":
        cdf = torch.cat([cdf.reshape(-1)[:2], cdf.reshape(-1)])[2:].view(64, 256)
        assert clahe.apply_path(H, W, 8, 256, img.data_ptr(), cdf.data_ptr()) == "general"
    assert torch.equal(clahe.tile_hist(img), h0)
    assert torch.equal(clahe.apply_cdf(img, cdf), clahe.apply_cdf_plain(img, cdf))


def test_clahe_kernels_back_to_back_and_in_a_cuda_graph(cuda):
    """Two CLAHE passes one after the other on one stream, then the same
    pair captured in a CUDA graph and replayed twice on new pixels."""
    H, W = 576, 1024
    a, b = _clahe_image(cuda, H, W), _clahe_image(cuda, H, W).flip(0).contiguous()
    ref = [imops.clahe(x, use_kernels=False) for x in (a, b)]
    assert all(torch.equal(imops.clahe(x), r) for x, r in zip((a, b), ref))
    buf = a.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        imops.clahe(buf)  # builds and warms the kernels outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = imops.clahe(buf)
    for x, r in ((b, ref[1]), (a, ref[0])):
        buf.copy_(x)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, r)


@pytest.mark.parametrize("H,W,tiles", [(576, 1024, 8), (148, 288, 4), (480, 752, 8)])
def test_clahe_kernels_at_every_launch_size(cuda, H, W, tiles):
    """The raw entry points at slab counts, rows a block and (the aligned
    cut, also where tw % 8 == 0) columns a block other than the wrappers'
    own choice, each twice into a result filled with -1."""
    from lvislam_tpu_torch.ops import _kernels

    lib = _kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    img = _clahe_image(cuda, H, W)
    h0 = clahe.tile_hist_plain(img, tiles)
    cdf = imops.clip_cdf(h0, (H // tiles) * (W // tiles))
    o0 = clahe.apply_cdf_plain(img, cdf, tiles)
    for slabs in (0, 1, 2, 3, 4, 8):
        for _ in range(2):
            hist = torch.full((tiles * tiles, 256), -1.0, device=cuda)
            _kernels.check(lib.lvt_clahe_hist(img.data_ptr(), hist.data_ptr(), H, W, tiles, 256,
                                              slabs, stream), "lvt_clahe_hist")
            assert torch.equal(hist, h0), slabs
    tw = W // tiles
    widths = [c for c in (4, 8, 16, 32, 64, 128, 256) if c <= tw] + ([0] if tw % 8 == 0 else [])
    for rows in (0, 1, 5, 12, 24, 37, 64):
        for cols in widths if rows else [0]:
            out = torch.full_like(img, -1.0)
            _kernels.check(lib.lvt_clahe_apply(img.data_ptr(), cdf.data_ptr(), out.data_ptr(),
                                               H, W, tiles, 256, rows, cols, stream),
                           "lvt_clahe_apply")
            assert torch.equal(out, o0), (rows, cols)


def test_clahe_on_the_card_equals_the_cpu(cuda):
    """The whole CLAHE (K3, the CDF step, K4) on the card against the same
    function on the CPU, which runs the plain versions."""
    img = np.random.default_rng(5).random((576, 1024), dtype=np.float32)
    a = imops.clahe(torch.as_tensor(img, device=cuda)).cpu()
    b = imops.clahe(torch.from_numpy(img))
    assert float((a - b).abs().max()) <= 1e-6


def test_clahe_wrappers_refuse_bad_inputs_on_the_card(cuda):
    n = (clahe.HIST_LAUNCHES, clahe.APPLY_LAUNCHES)
    with pytest.raises(TypeError):
        clahe.tile_hist(torch.zeros((64, 64), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        clahe.tile_hist(torch.zeros((4, 64), device=cuda))
    with pytest.raises(ValueError):
        clahe.apply_cdf(torch.zeros((64, 64), device=cuda), torch.zeros((63, 256), device=cuda))
    with pytest.raises(ValueError):
        clahe.apply_cdf(torch.zeros((64, 64), device=cuda), torch.zeros((64, 256)))
    assert (clahe.HIST_LAUNCHES, clahe.APPLY_LAUNCHES) == n  # refused before any launch
    # the entry points refuse a vector launch the path rule would not make:
    # too many rows a block or slabs a tile, W % 4, a misaligned image
    from lvislam_tpu_torch.ops import _kernels

    lib = _kernels.library()
    stream = torch.cuda.current_stream().cuda_stream
    H, W = 144, 256
    img = torch.zeros(H * W + 4, device=cuda)
    hist, cdf, out = (torch.zeros(s, device=cuda) for s in ((64, 256), (64, 256), (H, W)))
    p, off = img.data_ptr(), img[1:].data_ptr()
    c = cdf.data_ptr()
    assert lib.lvt_clahe_apply(p, c, out.data_ptr(), H, W, 8, 256, 65, 0, stream) != 0
    assert lib.lvt_clahe_apply(off, c, out.data_ptr(), H, W, 8, 256, 24, 0, stream) != 0
    assert lib.lvt_clahe_apply(p, c, out.data_ptr(), H, W - 2, 8, 256, 24, 0, stream) != 0
    assert lib.lvt_clahe_hist(p, hist.data_ptr(), H, W, 8, 256, 9, stream) != 0
    assert lib.lvt_clahe_hist(off, hist.data_ptr(), H, W, 8, 256, 4, stream) != 0
    assert lib.lvt_clahe_hist(p, hist.data_ptr(), H, W - 2, 8, 256, 4, stream) != 0
    # the aligned cut: a lattice cut at tw = 94 (cells on odd columns), blocks
    # wider than a tile or not a power of two; K3 with tiles % G != 0
    assert lib.lvt_clahe_apply(p, c, out.data_ptr(), 48, 752, 8, 256, 24, 0, stream) != 0
    assert lib.lvt_clahe_apply(p, c, out.data_ptr(), 48, 752, 8, 256, 24, 128, stream) != 0
    assert lib.lvt_clahe_apply(p, c, out.data_ptr(), 48, 752, 8, 256, 24, 48, stream) != 0
    assert lib.lvt_clahe_apply(off, c, out.data_ptr(), 48, 752, 8, 256, 24, 64, stream) != 0
    assert lib.lvt_clahe_hist(p, hist.data_ptr(), 30, 32, 3, 256, 2, stream) != 0
    torch.cuda.synchronize()
