"""Trajectory metrics and the per-stage metrics log — a numpy copy of
``lvislam_tpu.utils.metrics`` (``umeyama_alignment``, ``ate_rmse``,
``rpe_rmse``, ``MetricsLogger``, ``StageTimer``); the port keeps its own."""

from __future__ import annotations

import json
import time
from typing import IO

import numpy as np
from torch.profiler import record_function


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


def rpe_rmse(
    est_pos: np.ndarray, est_R: np.ndarray, gt_pos: np.ndarray, gt_R: np.ndarray,
    delta: int = 1,
):
    """Relative pose error RMSE over index offsets of `delta` frames.
    Returns (trans_rmse, rot_rmse_rad)."""
    n = len(est_pos) - delta
    terr, rerr = [], []
    for i in range(n):
        dt_est = est_R[i].T @ (est_pos[i + delta] - est_pos[i])
        dt_gt = gt_R[i].T @ (gt_pos[i + delta] - gt_pos[i])
        terr.append(np.linalg.norm(dt_est - dt_gt))
        dR = (est_R[i].T @ est_R[i + delta]).T @ (gt_R[i].T @ gt_R[i + delta])
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        rerr.append(angle)
    return float(np.sqrt(np.mean(np.array(terr) ** 2))), float(
        np.sqrt(np.mean(np.array(rerr) ** 2))
    )


class MetricsLogger:
    """Append-only JSONL metrics stream, one record per pipeline stage call."""

    def __init__(self, path: str | None = None):
        self._fh: IO | None = open(path, "a") if path else None
        self.records: list[dict] = []

    def log(self, stage: str, **fields):
        rec = {"t_wall": time.time(), "stage": stage, **fields}
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()


class StageTimer:
    """Context-manager timing helper feeding MetricsLogger (host clock; the
    time covers the device work only where the stage reads a result back).
    It also opens the profiler range ``lvi.<stage>``, the root of the spans
    a traced run records inside the stage."""

    def __init__(self, logger: MetricsLogger, stage: str, **fields):
        self.logger = logger
        self.stage = stage
        self.fields = fields
        self._range = record_function(f"lvi.{stage}")

    def __enter__(self):
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.logger.log(self.stage, dt=time.perf_counter() - self.t0, **self.fields)
        self._range.__exit__(*exc)
        return False
