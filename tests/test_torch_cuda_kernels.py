"""Kernels K1-K4 on the card against their plain PyTorch versions (the
CPU tests reach only the plain versions: a CUDA kernel has no interpret
mode). Marked `cuda`; each test skips when no CUDA device is present. Run on
a GPU machine from the repository root with
`python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py`
(`--noconftest`: the test tree's conftest imports JAX).

Tolerances: K1 positions identical and distances within rtol 1e-6 (same f32
op order, explicitly rounded); K2's H and g within 2e-4 of their scale and
the residual count exact (the block sums run in another order, and K2's
multiply-adds are contracted into FMAs). K2 is checked on neighbourhoods
from the synthetic world, as the step sees them. On random thin planes the
f32 plane fit is ill-conditioned, and rounding alone moves the sums past
2e-4 of scale: on such cases the TPU kernel in interpret mode differs from
the JAX XLA path by up to 8e-3 of scale. K3's counts identical; K4 within
1e-6 (every op rounded on its own in the plain version's order, so
measured equal), at the rig's 576x1024 and at ragged shapes."""

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


@pytest.mark.parametrize("B,Q", [(16, 2048), (32, 512), (16, 37)])
def test_knn_tail_kernel_matches_plain(cuda, B, Q):
    rng = np.random.default_rng(B + Q)
    cand = rng.integers(-2048, 2048, (Q, 27, 4, B)).astype(np.int16)
    cand[:, :, 3, :] = rng.integers(-1, 4, (Q, 27, B))
    cand[-1, :, 3, :] = -1  # an exhausted query
    want = rng.integers(0, 4, (Q, 27)).astype(np.int32)
    off = rng.uniform(-4096, 4096, (Q, 81)).astype(np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in (cand.reshape(Q, -1), want, off)]
    n0 = kt.LAUNCHES
    d1, p1 = kt.knn_tail(*args, bucket=B, k=5)
    d0, p0 = kt.knn_tail_plain(*args, bucket=B, k=5)
    torch.cuda.synchronize()
    assert kt.LAUNCHES == n0 + 1
    assert torch.equal(p1, p0)
    torch.testing.assert_close(d1, d0, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("kind,n", [("corner", 512), ("corner", 200), ("surf", 2048), ("surf", 300)])
def test_step_kernels_match_plain(step_inputs, kind, n):
    """Both kernels at the LIO step's shapes (and a ragged last block) on
    realistic neighbourhoods, through chip_smoke.py's own checks."""
    import chip_smoke

    corner, surf, h_c, h_s, q_c, q_s, x6 = step_inputs
    h, map_pts, q = (h_c, corner, q_c) if kind == "corner" else (h_s, surf, q_s)
    n1, n2 = kt.LAUNCHES, gnp.LAUNCHES
    chip_smoke.check_knn_tail(h, q[:n], kind)
    chip_smoke.check_gn_partials(h, map_pts, q[:n], x6, kind)
    assert kt.LAUNCHES > n1 and gnp.LAUNCHES > n2


def test_wrappers_refuse_bad_inputs_on_the_card(cuda):
    with pytest.raises(TypeError):
        kt.knn_tail(torch.zeros((2, 27 * 4 * 16), dtype=torch.int32, device=cuda),
                    torch.zeros((2, 27), dtype=torch.int32, device=cuda),
                    torch.zeros((2, 81), device=cuda), bucket=16)
    with pytest.raises(ValueError):
        gnp.gn_partials(torch.zeros((8, 4), device=cuda), torch.zeros((20, 4), device=cuda),
                        torch.zeros(39, device=cuda), "surf")


@pytest.mark.parametrize("H,W,tiles,n_bins", [(576, 1024, 8, 256), (240, 320, 8, 256),
                                              (100, 150, 8, 256), (37, 61, 8, 256),
                                              (576, 1024, 4, 1024)])
def test_clahe_kernels_match_plain(cuda, H, W, tiles, n_bins):
    rng = np.random.default_rng(H + W)
    img = torch.as_tensor(rng.random((H, W), dtype=np.float32) ** 2, device=cuda)
    img[0, :4] = torch.tensor([-0.5, 0.0, 1.0, 1.5])  # out-of-range values clamp
    n3, n4 = clahe.HIST_LAUNCHES, clahe.APPLY_LAUNCHES
    h1 = clahe.tile_hist(img, tiles, n_bins)
    h0 = clahe.tile_hist_plain(img, tiles, n_bins)
    cdf = imops.clip_cdf(h0, (H // tiles) * (W // tiles))
    o1 = clahe.apply_cdf(img, cdf, tiles)
    o0 = clahe.apply_cdf_plain(img, cdf, tiles)
    torch.cuda.synchronize()
    assert (clahe.HIST_LAUNCHES, clahe.APPLY_LAUNCHES) == (n3 + 1, n4 + 1)
    assert torch.equal(h1, h0)
    assert float((o1 - o0).abs().max()) <= 1e-6


def test_clahe_on_the_card_equals_the_cpu(cuda):
    """The whole CLAHE (K3, the CDF step, K4) on the card against the same
    function on the CPU, which runs the plain versions."""
    img = np.random.default_rng(5).random((576, 1024), dtype=np.float32)
    a = imops.clahe(torch.as_tensor(img, device=cuda)).cpu()
    b = imops.clahe(torch.from_numpy(img))
    assert float((a - b).abs().max()) <= 1e-6


def test_clahe_wrappers_refuse_bad_inputs_on_the_card(cuda):
    with pytest.raises(TypeError):
        clahe.tile_hist(torch.zeros((64, 64), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        clahe.tile_hist(torch.zeros((4, 64), device=cuda))
    with pytest.raises(ValueError):
        clahe.apply_cdf(torch.zeros((64, 64), device=cuda), torch.zeros((63, 256), device=cuda))
