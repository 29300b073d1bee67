"""The batched forms of kernels K1 and K2 and the lockstep GN on the card
(slice 11): the CPU tests (``test_torch_lockstep.py``) reach only the plain
versions, a CUDA kernel having no interpret mode. Marked `cuda`; each test
skips when no CUDA device is present. Run on a GPU machine from the
repository root with
`python -m pytest --noconftest -q tests/test_torch_cuda_batched.py`.

Tolerances: the batched K1 equal to its plain version and to one
unbatched launch a sequence; the batched K2 bit-equal to one unbatched
launch a sequence (its plain version sums in another order:
``test_torch_cuda_kernels.py`` holds the unbatched launch to it); the
lockstep GN on the card bit-equal, sequence by sequence, to
``scan_to_map_hashed`` on the card."""

import os

import numpy as np
import pytest
import torch

import torch_lockstep_inputs as inputs
from lvislam_tpu_torch.ops import gn_partials as gnp
from lvislam_tpu_torch.ops import knn_tail as kt
from lvislam_tpu_torch.ops import scan2map as ts2m

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batched kernels run only on the card")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def parity(cuda):
    import chip_smoke

    return chip_smoke.parity_inputs(cuda)


def _bits(a, b):
    return all(torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.parametrize("S", [1, 3, 4])
def test_batched_kernels_at_the_step_shapes(parity, S):
    """K1 and K2 batched over S sequences of the LIO step's shapes (512
    corner, 2048 surf queries): one launch each; K1 equal to its plain
    version and to S unbatched launches, K2 bit-equal to S unbatched
    launches and within 2e-4 of scale of its plain version."""
    import chip_smoke

    sets, singles, blocks, blk, pars = chip_smoke.batched_inputs(parity, S)
    n1, n2 = kt.LAUNCHES, gnp.LAUNCHES
    got = kt.knn_tail_batched(sets, S, k=5)
    H, g, n = gnp.gn_partials_pair_batched(*blocks[0], *blocks[1], pars)
    torch.cuda.synchronize()
    assert (kt.LAUNCHES, gnp.LAUNCHES) == (n1 + 1, n2 + 1)
    for c in (0, 1):
        d0, p0 = kt.knn_tail_plain(*sets[c], k=5)
        assert torch.equal(got[c][1].reshape(-1, 5), p0)
        assert _bits((got[c][0].reshape(-1, 5),), (d0,))
    for i in range(S):
        for c, (d1, p1) in enumerate(kt.knn_tail_pair(*singles[i], k=5)):
            assert torch.equal(got[c][1][i], p1) and _bits((got[c][0][i],), (d1,))
        assert _bits((H[i], g[i], n[i]), gnp.gn_partials_pair(*blk[i][0], *blk[i][1], pars[i]))
    H0, g0, n0 = gnp.gn_partials_pair_batched_plain(*blocks[0], *blocks[1], pars)
    for i in range(S):
        assert abs(int(n[i]) - int(n0[i])) <= 2
        torch.testing.assert_close(H[i], H0[i], atol=2e-4 * float(H0[i].abs().max()), rtol=2e-4)


def test_batched_gn_kernel_ragged_sizes_and_tickets(parity):
    """K2 batched at sizes with ragged last blocks and an empty class, with
    S changing between launches (the per-device tickets grow, and reset
    themselves), and replayed from a CUDA graph: each sequence bit-equal to
    its unbatched launch every time."""
    import chip_smoke

    _, _, blocks, _, pars = chip_smoke.batched_inputs(parity, 5)
    for S, nc, ns in ((2, 200, 300), (5, 128, 77), (2, 0, 130), (3, 512, 0)):
        b = [blocks[0][0][:S, :, :nc], blocks[0][1][:S, :, :nc],
             blocks[1][0][:S, :, :ns], blocks[1][1][:S, :, :ns]]
        b = [x.contiguous() for x in b]
        H, g, n = gnp.gn_partials_pair_batched(*b, pars[:S])
        for i in range(S):
            assert _bits((H[i], g[i], n[i]), gnp.gn_partials_pair(*(x[i] for x in b), pars[i]))
    b = [x[:4].contiguous() for x in (*blocks[0], *blocks[1])]
    ref = [x.clone() for x in gnp.gn_partials_pair_batched(*b, pars[:4])]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gnp.gn_partials_pair_batched(*b, pars[:4])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gnp.gn_partials_pair_batched(*b, pars[:4])
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert _bits(out, ref)


def test_batched_wrappers_refuse_bad_inputs_on_the_card(parity):
    """A mix of CPU and card tensors raises; K1's stacked rows must split
    into S sequences."""
    import chip_smoke

    sets, _, blocks, _, pars = chip_smoke.batched_inputs(parity, 2)
    with pytest.raises(ValueError, match="different devices"):
        gnp.gn_partials_pair_batched(*blocks[0], *blocks[1], pars.cpu())
    with pytest.raises(ValueError, match="different devices"):
        kt.knn_tail_batched([sets[0][:2] + (sets[0][2].cpu(), sets[0][3])], 2)
    with pytest.raises(ValueError, match="sequences"):
        kt.knn_tail_batched([tuple(t[:-1] for t in sets[0][:3]) + (sets[0][3],)], 2)


@pytest.mark.parametrize("flags", list(inputs.FLAG_SETS.values()), ids=list(inputs.FLAG_SETS))
def test_lockstep_gn_on_the_card_equals_unbatched(cuda, flags):
    """`scan_to_map_hashed_batched` on the card over three sequences equals
    `scan_to_map_hashed` on the card on each, every GNState field bit for
    bit; K2 runs once an iteration of the longest GN, and K1 once a
    refresh of it (a launch a class without gather-once)."""
    kw = dict(max_iters=inputs.MAX_ITERS, eigen_thresh=25.0, nn_refresh_every=2, **flags)
    args = inputs.gn_args(inputs.SEQS, cuda)
    ref = [ts2m.scan_to_map_hashed(*a, **kw) for a in args]
    counts = (kt.LAUNCHES, gnp.LAUNCHES)
    got = ts2m.scan_to_map_hashed_batched(*inputs.stack_args(args), **kw)
    torch.cuda.synchronize()
    for s, r in enumerate(ref):
        for name, a, b in zip(r._fields, r, got):
            assert torch.equal(a, b[s]), (s, name)
    longest = max(int(r.it) for r in ref)
    k1 = -(-longest // 2) * (1 if flags["gather_once"] else 2) if flags["use_pallas"] else 0
    assert kt.LAUNCHES - counts[0] == k1
    assert gnp.LAUNCHES - counts[1] == (longest if flags["use_pallas_gn"] else 0)
