"""The smoother's correction replayed as a CUDA graph against the same
function run eagerly, on the card. Marked `cuda`; each test skips when no
CUDA device is present. Run on a GPU machine from the repository root with
`python -m pytest --noconftest -q tests/test_torch_cuda_fusion_graph.py`
(`--noconftest`: the test tree's conftest imports JAX).

The sequence is `torch_fusion_inputs.corrections` at the fused system's
window of 64 slots: windows of 2-20 samples, a degenerate correction and a
failure reset (velocity over ``maxVelocity``), the IMU columns passed as
views of one buffer, as `_scan_glue` passes them. A graph replays the
kernels that the eager function launches, in their order, so every
comparison is bit for bit."""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_fusion_inputs as fin
from lvislam_tpu_torch.core import cudagraph
from lvislam_tpu_torch.models import pipeline
from lvislam_tpu_torch.models.lio import imu_fusion as fus

pytestmark = pytest.mark.cuda

N = 64  # the fused system's glue window (`models/replay.GLUE_CAP`)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured and replayed only on a card")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    return torch.device("cuda")


def as_views(step):
    """The step's IMU columns as views of one (N, 7) buffer."""
    dts, accs, gyrs, p, q, deg = step
    imu = torch.cat([dts[:, None], accs, gyrs], dim=1)
    return dts, imu[:, 1:4], imu[:, 4:7], p, q, deg


def eager(state, step, gn_iters=4):
    consts = fus._constants(fin.PARAMS, state.pos.dtype, state.pos.device)
    return fus._correct(state, *step, fin.PARAMS, gn_iters, consts)


def assert_bits(a, b):
    la, lb = cudagraph.leaves(a), cudagraph.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)


def test_corrections_by_graph_are_bit_equal_to_eager(cuda):
    """Every correction of the sequence, each from its own carried state,
    and the reset after the failure as the system makes it."""
    st0, steps, counts = fin.corrections(N, cuda)
    assert len(set(counts)) > 3
    got, want = st0, st0
    for k, step in enumerate(steps):
        got = fus.fusion_correct(got, *as_views(step), fin.PARAMS)
        want = eager(want, step)
        assert_bits(got, want)
        assert bool(got.failed) == (k == fin.FAIL)
        if k == fin.FAIL:
            p, q = step[3], step[4]
            got, want = (fus.fusion_initialize(s, p, q, fin.PARAMS) for s in (got, want))
    assert int(got.reset_id) == 1 and not bool(got.failed)


def test_one_signature_captures_once_and_leaves_earlier_results(cuda):
    st0, steps, _ = fin.corrections(N, cuda)
    first = fus.fusion_correct(st0, *as_views(steps[0]), fin.PARAMS)
    kept = cudagraph.tmap(torch.clone, first)
    n, graphs = fus.CAPTURES, len(fus._GRAPHS)
    later = first
    for step in steps[1:fin.FAIL]:
        later = fus.fusion_correct(later, *as_views(step), fin.PARAMS)
    # contiguous columns share the graph of the views
    contiguous = fus.fusion_correct(first, *steps[1], fin.PARAMS)
    assert fus.CAPTURES == n and len(fus._GRAPHS) == graphs
    assert_bits(first, kept)
    assert_bits(contiguous, eager(first, steps[1]))


def test_another_signature_captures_its_own_graph(cuda):
    st0, steps, _ = fin.corrections(N, cuda)
    fus.fusion_correct(st0, *as_views(steps[0]), fin.PARAMS)
    n, graphs = fus.CAPTURES, len(fus._GRAPHS)
    st32, steps32, _ = fin.corrections(32, cuda)
    got = fus.fusion_correct(st32, *as_views(steps32[0]), fin.PARAMS)
    three = fus.fusion_correct(st32, *as_views(steps32[0]), fin.PARAMS, gn_iters=3)
    assert fus.CAPTURES == n + 2 and len(fus._GRAPHS) == graphs + 2
    assert_bits(got, eager(st32, steps32[0]))
    assert_bits(three, eager(st32, steps32[0], gn_iters=3))


def test_each_correction_replays_a_graph(cuda):
    st0, steps, _ = fin.corrections(N, cuda)
    fus.fusion_correct(st0, *as_views(steps[0]), fin.PARAMS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = st0
        for step in steps[:3]:
            with torch.profiler.record_function("lio.fusion"):
                st = fus.fusion_correct(st, *as_views(step), fin.PARAMS)
    names = [e.name for e in prof.events()]
    assert names.count("lio.fusion_graph") == 3
    assert "lio.fusion_capture" not in names


def test_scan_glue_summary_is_bit_equal_to_eager(cuda, monkeypatch):
    """The pipeline's glue over an uploaded window (count in slot 0, the
    correction's columns as views) with the graph and with it turned off."""
    st0, steps, counts = fin.corrections(N, cuda)
    dts, accs, gyrs, p, q, deg = steps[1]
    buf = torch.cat([torch.tensor([float(counts[1])], device=cuda),
                     torch.cat([dts[:, None], accs, gyrs], dim=1).reshape(-1)])
    x6 = torch.cat([torch.tensor([0.01, -0.02, 0.03], device=cuda), p])
    kf = torch.tensor(3, dtype=torch.int32, device=cuda)

    def glue():
        return pipeline._scan_glue(st0, x6, x6, deg, kf, buf, fin.PARAMS,
                                   initialized=True, n=counts[1])

    got = glue()
    monkeypatch.setattr(cudagraph, "graphable", lambda args: False)
    assert_bits(got, glue())
