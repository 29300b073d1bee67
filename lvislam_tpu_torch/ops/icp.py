"""Point-to-point ICP, the loop-closure verifier — port of
``lvislam_tpu.ops.icp``: exact 1-NN (``scan2map.knn``) then a weighted
Kabsch alignment, a fixed number of iterations; fitness is the mean squared
correspondence distance (PCL ``getFitnessScore``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from .scan2map import knn


class ICPResult(NamedTuple):
    trans: torch.Tensor  # (3,) source -> target
    quat: torch.Tensor  # (4,)
    fitness: torch.Tensor  # ()
    num_corr: torch.Tensor  # () int


def _kabsch(src, dst, w):
    """Weighted rigid alignment src -> dst."""
    wsum = torch.clamp(torch.sum(w), min=1e-6)
    mu_s = torch.sum(src * w[:, None], dim=0) / wsum
    mu_d = torch.sum(dst * w[:, None], dim=0) / wsum
    S = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)
    U, _, Vt = torch.linalg.svd(S)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    flip = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ flip @ U.T
    return R, mu_d - R @ mu_s


def icp_point2point(src, src_valid, dst, dst_valid, init_trans, init_quat,
                    max_corr_dist: float = 30.0, iters: int = 30) -> ICPResult:
    R = lie.quat_to_matrix(init_quat)
    t = init_trans
    for _ in range(iters):
        moved = src @ R.T + t
        idx, sqd = knn(moved, src_valid, dst, dst_valid, k=1)
        nn = dst[idx[:, 0]]
        w = (src_valid & (sqd[:, 0] < max_corr_dist ** 2)).to(src.dtype)
        dR, dt = _kabsch(moved, nn, w)
        R, t = dR @ R, dR @ t + dt

    moved = src @ R.T + t
    idx, sqd = knn(moved, src_valid, dst, dst_valid, k=1)
    w = src_valid & (sqd[:, 0] < max_corr_dist ** 2)
    n = torch.clamp(torch.sum(w, dtype=torch.int32), min=1)
    fitness = torch.sum(torch.where(w, sqd[:, 0], torch.zeros_like(sqd[:, 0]))) / n.to(src.dtype)
    return ICPResult(trans=t, quat=lie.matrix_to_quat(R), fitness=fitness,
                     num_corr=torch.sum(w, dtype=torch.int32))
