"""The LIO step's loop-closure mechanism held to the plain reference
(``benchmark/plain_loop.py``): a pose-graph solve and a loop ICP the step
made, each redone by the program and by the reference, with the
tolerances and the controls that must fail them.

``compare_posegraph(state, k)`` takes the state and keyframe the step
handed ``mapping._optimize_graph``; ``compare_icp(args, kw, res)`` the
arguments of an ``ops/icp.icp_point2point`` call and its result.
``chip_loop_check.py`` captures both from a long run of the cell on the
card."""

from __future__ import annotations

import torch

from lvislam_tpu_torch.core import lie
from lvislam_tpu_torch.models.lio import mapping
from lvislam_tpu_torch.ops import icp as icp_ops
from lvislam_tpu_torch.ops import posegraph as pg

from . import plain_loop as P

# Tolerances, each with its reason. The readings are in PERF.md §6.
TOL = {
    # Every valid node's pose is compared in its solve's first node's frame:
    # the prior holds the graph's frame only to its variances (pi^2 rad^2 in
    # heading, 1e8 m^2 in position, the upstream's priorNoise), so a solve
    # may leave the whole graph turned or moved at no cost, and float32 PCG
    # does (the gauge gap, reported beside and not compared). The step's
    # 6 GN x 96 PCG read 4.1e-6 / 6.7e-6 m, 1.3e-6 / 1.6e-6 rad and
    # 7.0e-7 / 1.4e-6 of the error on the cell's last solves at 230 s
    # (176 / 178 loops); 8 PCG iterations 3.6e-4 / 2.3e-4 m, 5.3e-5 /
    # 2.9e-5 rad, 2.0e-5 / 1.4e-5; the graph rounded to float16 2.0e-3 /
    # 1.7e-3 m and 0.16 / 0.20 of the error. 20 GN or 300 PCG read as 96
    # on the CPU: float32's rounding of the poses, not the iteration count.
    "pos_m": 5e-5,  # a node's position
    "rot_rad": 1e-5,  # a node's rotation
    "total_error_rel": 1e-5,  # the total weighted squared error, relative to the optimum's
    # ICP. The program's 1-NN takes the expanded distance |q|^2 + |r|^2 -
    # 2 q.r in float32, which ranks two neighbours apart only where their
    # squared distances differ by more than ~|q|^2 2^-23; a flipped pair
    # among ~700 correspondences moves the pose by (their gap) / 700, and a
    # gap of 0.35 m by 5e-4 m. Sound readings on the cell's last loop ICPs:
    # 2.4e-4 m and 1.3e-4 rad on the card with one such flip, 3.6e-6 m
    # without; 2.2e-6 and 3.4e-7 m on the CPU.
    "icp_trans_m": 5e-4,
    "icp_rot_rad": 3e-4,
    # The fitness (m^2), absolute: the float32 expanded distance rounds each
    # pair's squared distance by ~|q|^2 2^-23 whatever the fit, so a perfect
    # fit of points within 6 m reads 8e-7 (the CPU test's) and the cell's
    # loop ICPs 8.6e-8-8.8e-7 from the plain fitness; from float16-rounded
    # inputs 5.3e-6-2.8e-5.
    "icp_fitness_m2": 3e-6,
}

ICP_OFFSET = ((0.3, -0.2, 0.05), (0.0, 0.0, 0.05))  # m, rad: a revisit after drift


def _f16(x):
    """The float32 tensors of `x` rounded to float16 and back."""
    if torch.is_tensor(x) and x.dtype == torch.float32:
        return x.half().float()
    return x


def _diffs(g, nodes, trans, R, plain) -> dict:
    """The worst gap of `g`'s valid nodes from the reference's, each pose
    taken in its solve's first node's frame (position m, rotation rad);
    the total error (the reference's cost in float64) relative to the
    reference's; and the gauge gap: the first node's own position and
    rotation gap."""
    t = trans.detach().cpu().double()[nodes]
    Rg = R[nodes]

    def in_first(R_, t_):
        return R_[0].T @ R_, (t_ - t_[0]) @ R_[0]

    Ra, ta = in_first(Rg, t)
    Rb, tb = in_first(plain["R"], plain["trans"])
    e = P._Graph(g).error(Rg, t)
    d = {"pos_m": float(torch.linalg.norm(ta - tb, dim=1).max()),
         "rot_rad": float(torch.linalg.norm(P.so3_log(Ra.transpose(-1, -2) @ Rb), dim=1).max()),
         "total_error": e,
         "total_error_rel": abs(e - plain["total_error"]) / plain["total_error"],
         "gauge_pos_m": float(torch.linalg.norm(t[0] - plain["trans"][0])),
         "gauge_rot_rad": float(torch.linalg.norm(P.so3_log(Rg[0].T @ plain["R"][0])))}
    d["within"] = all(d[k] <= TOL[k] for k in ("pos_m", "rot_rad", "total_error_rel"))
    return d


def compare_posegraph(state, k) -> dict:
    """The graph the step handed a solve, solved on its device as the step
    solves it, with 8 PCG iterations, and from the graph rounded to float16,
    each against the plain float64 solve. ``ok``: the step's solve within
    ``TOL`` and both others outside it."""
    g = state.graph

    def solved(g_, **kw):
        if kw:
            out = pg.optimize(g_, gn_iters=6, **kw)
        else:  # the step's own solve
            out = mapping._optimize_graph(state._replace(graph=g_), k).graph
        R = P.quat_to_matrix(out.quat.detach().cpu().double())
        return _diffs(g, plain["nodes"], out.trans, R, plain)

    plain = P.pose_graph_solve(g)
    f16 = g._replace(**{f: _f16(getattr(g, f)) for f in g._fields})
    res = {"nodes": int(len(plain["nodes"])), "loops": int(state.n_loops),
           "reference": {k_: plain[k_] for k_ in ("iters", "step_norm", "total_error_before",
                                                   "total_error")},
           "step": solved(g), "pcg8": solved(g, pcg_iters=8),
           "float16_graph": solved(f16, pcg_iters=96)}
    res["ok"] = (res["step"]["within"] and not res["pcg8"]["within"]
                 and not res["float16_graph"]["within"])
    return res


def _icp_gaps(res, plain) -> dict:
    """The gaps of an ICP result from the plain ICP's."""
    R = P.quat_to_matrix(res.quat.detach().cpu().double())
    d = {"fitness": float(res.fitness), "num_corr": int(res.num_corr),
         "icp_trans_m": float(torch.linalg.norm(res.trans.detach().cpu().double()
                                                - plain["trans"])),
         "icp_rot_rad": float(torch.linalg.norm(P.so3_log(R.T @ plain["R"]))),
         "icp_fitness_m2": abs(float(res.fitness) - plain["fitness"])}
    d["within"] = all(d[k] <= TOL[k] for k in ("icp_trans_m", "icp_rot_rad", "icp_fitness_m2"))
    return d


def compare_icp(args, kw, res) -> dict:
    """An ICP call of the step (`args`, `kw`) and its result `res` against
    the plain ICP on the same inputs, with two controls on those inputs: the
    program's ICP on inputs rounded to float16 (must fall outside ``TOL``)
    and with a quarter of the iterations (reported: on the cell's loop ICPs,
    which start ~5 mm from their optimum, 5 of 20 iterations land within
    2e-4 m of it, inside the float32 nearest-neighbour noise, so no
    tolerance the step holds can fail them). The iterations are held from a
    start `ICP_OFFSET` away instead: there the program must match the plain
    ICP and a quarter of the iterations must fall outside ``TOL``."""
    src, srcv, dst, dstv, t0, q0 = args
    short = dict(kw, iters=max(1, kw["iters"] // 4))
    plain = P.icp_point2point(*args, **kw)
    off = (torch.tensor(ICP_OFFSET[0], dtype=t0.dtype, device=t0.device),
           lie.so3_exp_quat(torch.tensor(ICP_OFFSET[1], dtype=t0.dtype, device=t0.device)))
    moved = (src, srcv, dst, dstv) + off
    plain_off = P.icp_point2point(*moved, **kw)
    d = {"src_points": int(srcv.sum()), "dst_points": int(dstv.sum()),
         "plain_fitness": plain["fitness"], "plain_num_corr": plain["num_corr"],
         "step": _icp_gaps(res, plain),
         "float16_inputs": _icp_gaps(icp_ops.icp_point2point(*map(_f16, args), **kw), plain),
         "quarter_iters": _icp_gaps(icp_ops.icp_point2point(*args, **short), plain),
         "offset_start": _icp_gaps(icp_ops.icp_point2point(*moved, **kw), plain_off),
         "offset_quarter_iters": _icp_gaps(icp_ops.icp_point2point(*moved, **short), plain_off)}
    d["ok"] = (d["step"]["within"] and not d["float16_inputs"]["within"]
               and d["offset_start"]["within"] and not d["offset_quarter_iters"]["within"])
    return d
