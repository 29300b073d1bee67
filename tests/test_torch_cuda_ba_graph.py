"""BA's LM loop and MARGIN_OLD replayed as CUDA graphs against the same
functions run eagerly, on the card. Marked `cuda`; each test skips when no
CUDA device is present. Run on a GPU machine from the repository root with
`python -m pytest --noconftest -q tests/test_torch_cuda_ba_graph.py`
(`--noconftest`: the test tree's conftest imports JAX).

The window is `synthetic.consistent_window` at the fused cell's size (10
frames, 150 features), its states perturbed so that the solver has work,
with velocities, row times, lidar-fixed depths and a prior from one eager
marginalization. A graph replays the kernels that the eager functions
launch, in their order, so every comparison is bit for bit."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lvislam_tpu_torch.core import cudagraph
from lvislam_tpu_torch.ops import ba
from lvislam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda

# the fused cell's BA (Schur, 4 iterations, ftol 1e-6); an early ftol stop;
# the augmented-QR solver
CONFIGS = {
    "schur": dict(solver="schur", iterations=4),
    "schur_ftol_stop": dict(solver="schur", iterations=8, ftol=0.05),
    "qr": dict(solver="qr", iterations=3),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured and replayed only on a card")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    return torch.device("cuda")


def window(dev, F: int = 150, seed: int = 0):
    """(cfg, solve's positional arguments, table_rt) of a perturbed window."""
    _, cfg, ws, pints, table, G = synthetic.consistent_window(10, F, seed=seed, device=dev)
    cfg = dataclasses.replace(cfg, solver="schur", iterations=4)
    rng = np.random.default_rng(seed)
    W1 = cfg.window + 1
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ws = ws._replace(Ps=ws.Ps + 0.03, Vs=ws.Vs + 0.05, Bgs=ws.Bgs + 0.002)
    table = table._replace(
        vel=f32(rng.normal(0, 0.05, (F, W1, 2))), rt=f32(rng.uniform(0, 0.02, (F, W1))),
        lidar_flag=torch.as_tensor(rng.random(F) < 0.15, device=dev),
        start_frame=torch.as_tensor(np.where(np.arange(F) % 5 == 0, 1, 0).astype(np.int32),
                                    device=dev))
    fv = torch.ones(W1, dtype=torch.bool, device=dev)
    td0 = torch.zeros((), device=dev)
    args = [ws, table.inv_depth, table.obs, table.vel, table.obs_valid, table.start_frame,
            table.ids >= 0, table.lidar_flag, pints, fv, ba.empty_prior(cfg, device=dev), G, td0]
    # a prior from one marginalization, so that its rows take part
    args[10] = ba._marginalize_old(args[0], args[1], ba._Window(*args[2:], table.rt), cfg)
    return cfg, args, table.rt


def eager_solve(cfg, args, rt):
    return ba._solve_eager(args[0], args[1], ba._Window(*args[2:], rt), cfg)


def eager_marg(cfg, args, rt):
    return ba._marginalize_old(args[0], args[1], ba._Window(*args[2:], rt), cfg)


def assert_bits(a, b):
    la, lb = cudagraph.leaves(a), cudagraph.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)


def assert_solves_equal(got, want):
    assert got.iterations == want.iterations
    assert_bits((got.ws, got.inv_depth, got.final_cost),
                (want.ws, want.inv_depth, want.final_cost))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_solve_by_graph_is_bit_equal_to_eager(cuda, name):
    cfg, args, rt = window(cuda)
    cfg = dataclasses.replace(cfg, **CONFIGS[name])
    want = eager_solve(cfg, args, rt)
    got = ba.solve(*args, cfg, table_rt=rt)
    assert_solves_equal(got, want)
    assert float(got.final_cost) < float(ba._lm_prologue(
        args[0], args[1], ba._Window(*args[2:], rt), cfg)[3])
    if name == "schur_ftol_stop":
        assert got.iterations < cfg.iterations


def test_marginalize_old_by_graph_is_bit_equal_to_eager(cuda):
    cfg, args, rt = window(cuda)
    assert_bits(ba.marginalize_old(*args, cfg, table_rt=rt), eager_marg(cfg, args, rt))


def test_new_values_replay_without_a_capture(cuda):
    cfg, args, rt = window(cuda)
    first = ba.solve(*args, cfg, table_rt=rt)
    first_prior = ba.marginalize_old(*args, cfg, table_rt=rt)
    outs = lambda: (first.ws, first.inv_depth, first.final_cost, first_prior)
    kept = cudagraph.tmap(torch.clone, outs())
    n = ba.CAPTURES
    args2 = list(args)
    args2[0] = first.ws._replace(Ps=first.ws.Ps + 0.02)
    args2[1] = first.inv_depth * 1.05
    args2[10] = first_prior
    got = ba.solve(*args2, cfg, table_rt=rt)
    got_prior = ba.marginalize_old(*args2, cfg, table_rt=rt)
    assert ba.CAPTURES == n
    assert_solves_equal(got, eager_solve(cfg, args2, rt))
    assert_bits(got_prior, eager_marg(cfg, args2, rt))
    # the first call's results do not alias the buffers the second replayed into
    assert_bits(outs(), kept)


def test_another_signature_captures_its_own_graphs(cuda):
    cfg, args, rt = window(cuda)
    ba.solve(*args, cfg, table_rt=rt)
    ba.marginalize_old(*args, cfg, table_rt=rt)
    n, graphs = ba.CAPTURES, len(ba._GRAPHS)
    cfg96, args96, rt96 = window(cuda, F=96, seed=1)
    got = ba.solve(*args96, cfg96, table_rt=rt96)
    prior = ba.marginalize_old(*args96, cfg96, table_rt=rt96)
    assert ba.CAPTURES == n + 3  # the prologue, the iteration, the marginalization
    assert len(ba._GRAPHS) == graphs + 2
    assert_solves_equal(got, eager_solve(cfg96, args96, rt96))
    assert_bits(prior, eager_marg(cfg96, args96, rt96))


def test_each_iteration_and_marginalization_replays_a_graph(cuda):
    cfg, args, rt = window(cuda)
    ba.solve(*args, cfg, table_rt=rt)
    ba.marginalize_old(*args, cfg, table_rt=rt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("vio.ba"):
            res = ba.solve(*args, cfg, table_rt=rt)
        with torch.profiler.record_function("vio.marg"):
            ba.marginalize_old(*args, cfg, table_rt=rt)
    names = [e.name for e in prof.events()]
    assert names.count("vio.ba_iter") == res.iterations
    assert names.count("vio.ba_graph") == res.iterations + 2  # with the prologue's, marg's
    assert "vio.ba_capture" not in names


def test_strided_inputs_share_the_graphs(cuda):
    """The window's first preintegration biases are views (stride 0, as
    `preint_init` makes them); stored whole they take the same graphs and
    give the same bits."""
    cfg, args, rt = window(cuda)
    assert any(t.stride()[0] == 0 for t in cudagraph.leaves(args[8]))
    ba.solve(*args, cfg, table_rt=rt)
    ba.marginalize_old(*args, cfg, table_rt=rt)
    n = ba.CAPTURES
    dense = list(args)
    dense[8] = cudagraph.tmap(lambda t: t.contiguous().clone(), args[8])
    assert_solves_equal(ba.solve(*dense, cfg, table_rt=rt), eager_solve(cfg, args, rt))
    assert_bits(ba.marginalize_old(*dense, cfg, table_rt=rt), eager_marg(cfg, args, rt))
    assert ba.CAPTURES == n
