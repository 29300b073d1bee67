"""Trajectory metrics — a numpy copy of ``umeyama_alignment`` and
``ate_rmse`` from ``lvislam_tpu.utils.metrics`` (the JAX package's utils
package imports JAX, which the card's machine does not have)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) transform aligning
    src -> dst, both (N, 3). Returns (s, R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after (optional) SE(3) alignment."""
    if align:
        s, R, t = umeyama_alignment(est_pos, gt_pos)
        est_pos = (s * (R @ est_pos.T)).T + t
    err = np.linalg.norm(est_pos - gt_pos, axis=1)
    return float(np.sqrt((err**2).mean()))
