"""The port's sliding-window bundle adjustment and marginalization against
the JAX package on the CPU, on the consistent synthetic window of
tests/test_ba_marginalization.py (W = 6, F = 64), perturbed so the solvers
have work to do.

Tolerances. Residuals are whitened by 460/1.5 (projection) and by inverse
Cholesky factors of order 1e2..1e4 (IMU), so f32 rounding of the states shows
as 1e-3 absolute in a projection residual and 1e-4 of the largest IMU
residual. The Jacobian is compared with `jax.jacfwd` within 1e-4 of its
largest entry. One `solve` per solver: final cost within 20% (the JAX test's
own solver-parity bound) and positions within 2e-3 m (the same test's bound).
A new prior is compared as JᵀJ and Jᵀr, never entrywise: QR leaves the sign
of each row of R free."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lvislam_tpu.ops import ba as jba
from lvislam_tpu_torch.core import cudagraph
from lvislam_tpu_torch.ops import ba as tba
from lvislam_tpu_torch.utils import convert
from lvislam_tpu_torch.utils import synthetic as tsyn
from tests.test_ba_marginalization import build_consistent_window

torch.set_num_threads(1)

W, F = 6, 64


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


@pytest.fixture(scope="module")
def win():
    caps, cfg, ws, pints, table, G = build_consistent_window(W=W, F=F, seed=3)
    rng = np.random.default_rng(0)
    # perturbed states, td-shifted observations, a few lidar-fixed depths
    ws = ws._replace(Ps=ws.Ps + 0.03, Vs=ws.Vs + 0.05, td=jnp.float32(0.01),
                     Bgs=ws.Bgs + 0.002)
    table = table._replace(
        vel=jnp.asarray(rng.normal(0, 0.05, (F, W + 1, 2)), jnp.float32),
        rt=jnp.asarray(rng.uniform(0, 0.02, (F, W + 1)), jnp.float32),
        lidar_flag=jnp.asarray(rng.random(F) < 0.15),
        start_frame=jnp.asarray(np.where(np.arange(F) % 5 == 0, 1, 0), jnp.int32))
    fv = jnp.ones(W + 1, bool)
    j = dict(cfg=cfg, ws=ws, pints=pints, table=table, G=G, fv=fv, prior=jba.empty_prior(cfg),
             td0=jnp.float32(0.0))
    t = dict(cfg=convert.ba_config_from_jax(cfg), ws=convert.window_from_jax(ws, "cpu"),
             pints=convert.preint_from_jax(pints, "cpu"), table=convert.table_from_jax(table, "cpu"),
             G=_t(G), fv=_t(fv), prior=convert.prior_from_jax(j["prior"], "cpu"),
             td0=torch.tensor(0.0))
    return j, t


def _args(d, cfg=None):
    tb = d["table"]
    return (d["ws"], tb.inv_depth, tb.obs, tb.vel, tb.obs_valid, tb.start_frame, tb.ids >= 0,
            tb.lidar_flag, d["pints"], d["fv"], d["prior"], d["G"], d["td0"], cfg or d["cfg"])


def test_consistent_window_matches_the_jax_tests_window():
    caps, cfg, ws, pints, table, G = build_consistent_window(W=4, F=24, seed=0)
    c2, cfg2, ws2, p2, t2, G2 = tsyn.consistent_window(4, 24, 0, device="cpu")
    assert convert.ba_config_from_jax(cfg) == cfg2 and convert.vio_caps_from_jax(caps) == c2
    for a, b in ((ws, ws2), (table, t2)):
        for name in b._fields:
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)))
    for name in p2._fields:  # preintegrated by each package's own integrator
        a = np.asarray(getattr(pints, name))
        np.testing.assert_allclose(getattr(p2, name).numpy(), a, atol=1e-6 * max(np.abs(a).max(), 1), rtol=0)


@pytest.mark.parametrize("with_rt", [False, True])
def test_projection_residuals_match_jax(win, with_rt):
    j, t = win
    kw_j = dict(rt=j["table"].rt) if with_rt else {}
    kw_t = dict(rt=t["table"].rt) if with_rt else {}
    pick = lambda d: (d["ws"], d["table"].inv_depth, d["table"].obs, d["table"].vel,
                      d["table"].obs_valid, d["table"].start_frame, d["table"].ids >= 0, d["td0"], d["cfg"])
    rj, mj = jba.projection_residuals(*pick(j), **kw_j)
    rt_, mt = tba.projection_residuals(*pick(t), **kw_t)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert np.abs(np.asarray(rj)).max() > 1.0
    np.testing.assert_allclose(rt_.numpy(), np.asarray(rj), atol=1e-3, rtol=1e-5)
    wj, wt = jba.robust_weights(rj, mj, 1.0), tba.robust_weights(rt_, mt, 1.0)
    # w = 1/sqrt(1 + |r|²): the residuals' 1e-3 shows as 5e-4 of a weight
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=5e-4, rtol=0)


@pytest.mark.parametrize("whiten", [False, True])
def test_imu_residuals_match_jax(win, whiten):
    j, t = win
    kw_j = dict(whiten=jba.imu_whiteners(j["pints"])) if whiten else {}
    kw_t = dict(whiten=tba.imu_whiteners(t["pints"])) if whiten else {}
    rj = np.asarray(jba.imu_residuals(j["ws"], j["pints"], j["fv"], j["G"], j["cfg"], **kw_j))
    rt_ = tba.imu_residuals(t["ws"], t["pints"], t["fv"], t["G"], t["cfg"], **kw_t).numpy()
    assert rj.shape == rt_.shape == (W, 15)
    np.testing.assert_allclose(rt_, rj, atol=1e-4 * np.abs(rj).max(), rtol=0)
    if whiten:
        Lj, Lt = np.asarray(kw_j["whiten"]), kw_t["whiten"].numpy()
        np.testing.assert_allclose(Lt, Lj, atol=1e-4 * np.abs(Lj).max(), rtol=0)


def test_retract_and_state_minus_match_jax(win):
    j, t = win
    d = (0.01 * np.random.default_rng(1).normal(size=j["cfg"].d_state)).astype(np.float32)
    cfg_j = dataclasses.replace(j["cfg"], estimate_td=True, estimate_extrinsic=True)
    cfg_t = dataclasses.replace(t["cfg"], estimate_td=True, estimate_extrinsic=True)
    wj = jba._retract_window(j["ws"], jnp.asarray(d), cfg_j)
    wt = tba._retract_window(t["ws"], _t(d), cfg_t)
    for name in wt._fields:
        np.testing.assert_allclose(getattr(wt, name).numpy(), np.asarray(getattr(wj, name)), atol=1e-6)
    mj = jba.state_minus(wj, j["ws"], cfg_j)
    mt = tba.state_minus(wt, t["ws"], cfg_t)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)
    np.testing.assert_allclose(mt.numpy(), d, atol=1e-5)  # minus undoes retract


def test_full_jacobian_matches_jax_jacfwd(win):
    j, t = win
    z = np.zeros(j["cfg"].d_total, np.float32)

    def res(mod, d, delta):
        a = _args(d)
        return mod.full_residual(delta, *a[:8], *a[8:], table_rt=d["table"].rt)

    Jj = np.asarray(jax.jacfwd(lambda x: res(jba, j, x))(jnp.asarray(z)))
    Jt = torch.func.jacfwd(lambda x: res(tba, t, x))(_t(z)).numpy()
    assert Jt.shape == Jj.shape == (j["cfg"].d_state + W * 15 + F * (W + 1) * 2, j["cfg"].d_total)
    np.testing.assert_allclose(Jt, Jj, atol=1e-4 * np.abs(Jj).max(), rtol=0)
    # the td column is zero with estimate_td off; lidar-fixed depth columns too
    assert not Jt[:, j["cfg"].d_state - 1].any()
    fixed = np.asarray(j["table"].lidar_flag)
    assert not Jt[:, j["cfg"].d_state:][:, fixed].any() and Jt[:, j["cfg"].d_state:][:, ~fixed].any()


@pytest.mark.parametrize("solver", ["qr", "cholesky", "schur"])
def test_solve_matches_jax(win, solver):
    j, t = win
    a = jba.solve(*_args(j, dataclasses.replace(j["cfg"], solver=solver, iterations=5)),
                  table_rt=j["table"].rt)
    b = tba.solve(*_args(t, dataclasses.replace(t["cfg"], solver=solver, iterations=5)),
                  table_rt=t["table"].rt)
    assert 1 <= b.iterations <= 5
    cj, ct = float(a.final_cost), float(b.final_cost)
    assert abs(ct - cj) <= 0.2 * cj, (ct, cj)
    np.testing.assert_allclose(b.ws.Ps.numpy(), np.asarray(a.ws.Ps), atol=2e-3, rtol=0)
    np.testing.assert_allclose(b.ws.Vs.numpy(), np.asarray(a.ws.Vs), atol=1e-2, rtol=0)
    # (unobserved slots hold 1 / 1e-3: relative there)
    np.testing.assert_allclose(b.inv_depth.numpy(), np.asarray(a.inv_depth), atol=2e-3, rtol=1e-3)
    fixed = np.asarray(j["table"].lidar_flag)
    np.testing.assert_array_equal(b.inv_depth.numpy()[fixed], t["table"].inv_depth.numpy()[fixed])


def test_port_solvers_agree(win):
    """tests/test_ba_marginalization.py::test_solver_parity_cholesky_vs_qr on
    the port alone, with its bounds."""
    _, t = win
    outs = {s: tba.solve(*_args(t, dataclasses.replace(t["cfg"], solver=s, iterations=5)))
            for s in ("qr", "cholesky", "schur")}
    for s in ("cholesky", "schur"):
        np.testing.assert_allclose(outs[s].ws.Ps.numpy(), outs["qr"].ws.Ps.numpy(), atol=2e-3)
        assert float(outs[s].final_cost) < float(outs["qr"].final_cost) * 1.2


def test_solve_stops_early_and_counts_host_reads(win):
    from lvislam_tpu_torch.core import hostsync

    _, t = win
    hostsync.reset()
    res = tba.solve(*_args(t, dataclasses.replace(t["cfg"], solver="schur", iterations=8, ftol=1e-2)))
    assert res.iterations < 8 and hostsync.COUNT == res.iterations
    hostsync.reset()
    res = tba.solve(*_args(t, dataclasses.replace(t["cfg"], solver="schur", iterations=3, ftol=0.0)))
    assert res.iterations == 3 and hostsync.COUNT == 0
    with pytest.raises(ValueError):
        tba.solve(*_args(t, dataclasses.replace(t["cfg"], solver="lu")))


def _assert_prior_close(pj, pt):
    Jj, Jt = np.asarray(pj.J, np.float64), pt.J.numpy().astype(np.float64)
    Hj, Ht = Jj.T @ Jj, Jt.T @ Jt
    assert np.abs(Hj).max() > 1.0
    # f32 QR of a (rows, 100+) system squared back into information: 3e-4 of
    # the largest entry (measured 1.1e-4)
    np.testing.assert_allclose(Ht, Hj, atol=3e-4 * np.abs(Hj).max(), rtol=0)
    gj, gt = Jj.T @ np.asarray(pj.r, np.float64), Jt.T @ pt.r.numpy().astype(np.float64)
    np.testing.assert_allclose(gt, gj, atol=2e-3 * max(np.abs(gj).max(), 1.0), rtol=0)
    for name in pt.ws_bar._fields:
        np.testing.assert_array_equal(getattr(pt.ws_bar, name).numpy(), np.asarray(getattr(pj.ws_bar, name)))


def test_marginalize_old_then_second_new_match_jax(win):
    j, t = win
    pj = jba.marginalize_old(*_args(j), table_rt=j["table"].rt)
    pt = tba.marginalize_old(*_args(t), table_rt=t["table"].rt)
    _assert_prior_close(pj, pt)
    S = t["cfg"].d_state
    assert not pt.J[:, W * 15:(W + 1) * 15].any() and not pt.J[S - 15:].any()  # frame W free
    # a second marginalization on top of that prior, each from the JAX prior
    _assert_prior_close(jba.marginalize_second_new(pj, j["cfg"]),
                        tba.marginalize_second_new(convert.prior_from_jax(pj, "cpu"), t["cfg"]))
    # and with the prior in the loop
    j2, t2 = dict(j, prior=pj), dict(t, prior=convert.prior_from_jax(pj, "cpu"))
    _assert_prior_close(jba.marginalize_old(*_args(j2)), tba.marginalize_old(*_args(t2)))


def test_empty_prior_matches_jax(win):
    j, t = win
    pj, pt = jba.empty_prior(j["cfg"]), tba.empty_prior(t["cfg"], device="cpu")
    assert pt.J.shape == pj.J.shape and not pt.J.any() and not pt.r.any()
    for name in pt.ws_bar._fields:
        np.testing.assert_array_equal(getattr(pt.ws_bar, name).numpy(), np.asarray(getattr(pj.ws_bar, name)))


class _ReplayByCall:
    """A stand-in for a CUDA graph on the CPU: the capture runs the function
    and keeps its outputs; a replay runs it again and writes the results
    into those same tensors, as a graph's kernels write into its memory."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()

    def replay(self):
        for dst, src in zip(cudagraph.leaves(self.out), cudagraph.leaves(self.fn())):
            dst.copy_(src)


def _capture_by_call(fn):
    tba.CAPTURES += 1
    fn()  # the side-stream warm-up
    g = _ReplayByCall(fn)
    return g, g.out


@pytest.mark.parametrize("solver", ["schur", "qr"])
def test_graph_dispatch_carries_the_eager_iterations(win, monkeypatch, solver):
    """The graph path's plumbing (static copies, the iteration writing its
    carry back into its inputs, results that alias nothing a later replay
    writes, one capture per signature) with each replay run as a call: bit
    for bit the eager functions. On a card the same holds for the captured
    graphs (tests/test_torch_cuda_ba_graph.py)."""
    import contextlib

    _, t = win
    monkeypatch.setattr(tba, "_capture", _capture_by_call)
    monkeypatch.setattr(cudagraph, "graphable", lambda args: True)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tba, "_GRAPHS", {})
    cfg = dataclasses.replace(t["cfg"], solver=solver, iterations=4)
    args = list(_args(t, cfg))
    rt = t["table"].rt
    window = lambda a: tba._Window(*a[2:13], rt)
    n = tba.CAPTURES
    first = tba.solve(*args, table_rt=rt)
    prior = tba.marginalize_old(*args, table_rt=rt)
    assert tba.CAPTURES == n + 3 and len(tba._GRAPHS) == 2
    kept = cudagraph.tmap(torch.clone, (first.ws, first.inv_depth, prior))
    want = tba._solve_eager(args[0], args[1], window(args), cfg)
    args[0], args[1], args[10] = first.ws._replace(Ps=first.ws.Ps + 0.01), first.inv_depth, prior
    second = tba.solve(*args, table_rt=rt)
    prior2 = tba.marginalize_old(*args, table_rt=rt)
    assert tba.CAPTURES == n + 3
    want2 = tba._solve_eager(args[0], args[1], window(args), cfg)
    for got, ref in ((first, want), (second, want2)):
        assert got.iterations == ref.iterations
        for a, b in zip(cudagraph.leaves((got.ws, got.inv_depth, got.final_cost)),
                        cudagraph.leaves((ref.ws, ref.inv_depth, ref.final_cost))):
            assert torch.equal(a, b)
    for a, b in zip(cudagraph.leaves(prior2), cudagraph.leaves(tba._marginalize_old(
            args[0], args[1], window(args), cfg))):
        assert torch.equal(a, b)
    for a, b in zip(cudagraph.leaves((first.ws, first.inv_depth, prior)), cudagraph.leaves(kept)):
        assert torch.equal(a, b)


def test_the_cpu_runs_eagerly_and_opens_no_graph_span(win):
    from torch.profiler import ProfilerActivity, profile

    _, t = win
    n = tba.CAPTURES
    cfg = dataclasses.replace(t["cfg"], solver="schur", iterations=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = tba.solve(*_args(t, cfg), table_rt=t["table"].rt)
        tba.marginalize_old(*_args(t, cfg), table_rt=t["table"].rt)
    names = {e.name for e in prof.events()}
    assert "vio.ba_iter" in names and res.iterations == 2
    assert not names & {"vio.ba_graph", "vio.ba_capture"}
    assert tba.CAPTURES == n
