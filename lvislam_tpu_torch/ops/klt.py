"""Sparse pyramidal Lucas-Kanade feature tracking — port of
``lvislam_tpu.ops.klt`` (the reference's SparsePyrLKOpticalFlow,
`feature_tracker.cpp:115-135`).

Per level each feature's S x S neighbourhood is fetched once, template
values and Scharr gradients are taken inside the patch, and every LK
iteration evaluates its warped window as ``Sy @ P @ Sxᵀ`` with two-tap
bilinear selection matrices. The JAX module fetches the patch as 128-lane
row blocks compacted by a 0/1 selection matmul, a TPU layout device; here
it is one direct (N, S, S) gather of the same pixels.

JAX stops the iteration with a ``lax.while_loop`` once every live step has
fallen to 0.01 px. Here the loop runs ``iters`` times with a device-side
"done" flag that freezes the iterate from then on: the same result with no
host sync.

Semantics match cv::calcOpticalFlowPyrLK with the JAX module's documented
deviation: an iterate that drifts more than the patch margin
(S/2 - half - 2 px) from its per-level initial guess fails.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import image as imops


class KLTResult(NamedTuple):
    pts: torch.Tensor  # (N, 2) tracked positions in level-0 pixels
    status: torch.Tensor  # (N,) bool
    err: torch.Tensor  # (N,) mean absolute residual of final window


def _patches(img: torch.Tensor, corners: torch.Tensor, S: int) -> torch.Tensor:
    """(N, S, S) integer-cornered patches; corners (N, 2) int (x0, y0),
    pre-clipped to [0, W-S] x [0, H-S]. On a level smaller than the patch,
    rows past the image repeat its last row and columns past it read 0, as
    the JAX gather + selection matmul give."""
    H, W = img.shape
    ar = torch.arange(S, device=img.device)
    rows = torch.clamp(corners[:, 1, None] + ar, max=H - 1)
    cols = corners[:, 0, None] + ar
    P = img[rows[:, :, None], torch.clamp(cols, max=W - 1)[:, None, :]]
    if W < S:
        P = torch.where((cols < W)[:, None, :], P, torch.zeros_like(P))
    return P


def _lin_sample_mats(d: torch.Tensor, offs: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Triangular two-tap bilinear selection matrices (N, k, S): row i
    samples patch coordinate d + offs[i] (offs = arange(k) - half) from
    patch coordinates src = arange(S)."""
    tgt = d[:, None] + offs[None, :]
    w = 1.0 - torch.abs(tgt[:, :, None] - src[None, None, :])
    return torch.clamp(w, min=0.0)


def _scharr_patch(P: torch.Tensor):
    """Scharr x/y gradients inside the (N, S, S) patch (edge rows/cols
    wrap and are invalid; the sampling margin keeps windows inside)."""
    s0, s1, s2 = 3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0

    def d_axis(P, axis):
        return (torch.roll(P, -1, axis) - torch.roll(P, 1, axis)) * 0.5

    def s_axis(P, axis):
        return torch.roll(P, 1, axis) * s0 + P * s1 + torch.roll(P, -1, axis) * s2

    return s_axis(d_axis(P, 2), 1), s_axis(d_axis(P, 1), 2)


def _sample(P, Sy, Sx):
    return Sy @ P @ Sx.transpose(1, 2)


def _track_level(prev_img, next_img, prev_pts, guess_pts, valid,
                 half: int, iters: int, min_eig_thresh: float = 1e-4, S: int = 32):
    """One pyramid level of patch-resident iterative LK."""
    H, W = prev_img.shape
    k = 2 * half + 1
    dtype = prev_img.dtype
    hS = S // 2
    margin = hS - half - 2  # iterate drift allowance inside the patch
    assert margin >= 2, f"window half={half} too large for patch S={S}"

    def corners_of(centers):
        c = torch.round(centers).to(torch.int64) - hS
        cx = torch.clamp(c[:, 0], 0, max(W - S, 0))
        cy = torch.clamp(c[:, 1], 0, max(H - S, 0))
        return torch.stack([cx, cy], -1)

    offs = torch.arange(k, dtype=dtype, device=prev_pts.device) - half
    src = torch.arange(S, dtype=dtype, device=prev_pts.device)

    def sample_at(P, d):  # the (N, k, k) window of P centered at d (patch coords)
        return _sample(P, _lin_sample_mats(d[:, 1], offs, src),
                       _lin_sample_mats(d[:, 0], offs, src))

    # ---- template side ----
    pc = corners_of(prev_pts)
    P_prev = _patches(prev_img, pc, S)
    gx_p, gy_p = _scharr_patch(P_prev)
    dp = prev_pts - pc.to(dtype)  # window center in patch coords
    Sy0 = _lin_sample_mats(dp[:, 1], offs, src)
    Sx0 = _lin_sample_mats(dp[:, 0], offs, src)
    T = _sample(P_prev, Sy0, Sx0)
    Gx = _sample(gx_p, Sy0, Sx0)
    Gy = _sample(gy_p, Sy0, Sx0)

    a11 = torch.sum(Gx * Gx, dim=(1, 2))
    a12 = torch.sum(Gx * Gy, dim=(1, 2))
    a22 = torch.sum(Gy * Gy, dim=(1, 2))
    det = a11 * a22 - a12 * a12
    tr = a11 + a22
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / (2.0 * k * k)
    ok0 = valid & (min_eig > min_eig_thresh)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, float("inf")))

    # ---- search side: iterations never touch the image ----
    nc = corners_of(guess_pts)
    P_next = _patches(next_img, nc, S)
    nc_f = nc.to(dtype)
    lo = nc_f + (hS - margin)
    hi = nc_f + (hS + margin)

    # cv::TermCriteria(COUNT | EPS, iters, 0.01): once every live step has
    # fallen to 0.01 px, JAX's while_loop stops; `done` freezes the iterate
    pts = guess_pts
    done = torch.zeros((), dtype=torch.bool, device=pts.device)
    for _ in range(iters):
        dI = sample_at(P_next, pts - nc_f) - T
        b1 = torch.sum(dI * Gx, dim=(1, 2))
        b2 = torch.sum(dI * Gy, dim=(1, 2))
        dx = -(a22 * b1 - a12 * b2) * inv_det
        dy = -(-a12 * b1 + a11 * b2) * inv_det
        step = torch.where(ok0[:, None], torch.stack([dx, dy], dim=-1), 0.0)
        new_pts = torch.clamp(pts + step, lo, hi)
        max_step = torch.max(torch.abs(new_pts - pts))
        pts = torch.where(done, pts, new_pts)
        done = done | ~(max_step > 0.01)

    inb = (
        (pts[:, 0] > half) & (pts[:, 0] < W - 1 - half)
        & (pts[:, 1] > half) & (pts[:, 1] < H - 1 - half)
    )
    # converged iterates sit strictly inside the drift margin; ones pinned
    # to the clamp boundary ran out of patch
    in_patch = torch.amax(torch.abs(pts - nc_f - hS), dim=1) < (margin - 1e-3)
    err = torch.mean(torch.abs(sample_at(P_next, pts - nc_f) - T), dim=(1, 2))
    return pts, ok0 & inb & in_patch, err


def track(
    prev_img: torch.Tensor | None,  # (H, W) float; None iff prev_pyr given
    next_img: torch.Tensor,
    prev_pts: torch.Tensor,  # (N, 2) level-0 pixel coords
    valid: torch.Tensor,  # (N,)
    levels: int = 3,
    half: int = 10,  # 21x21 window
    iters: int = 30,
    patch: int = 32,  # S: per-level sampled neighbourhood
    prev_pyr: tuple | None = None,  # precomputed pyramids (the tracker
    next_pyr: tuple | None = None,  # caches the prev frame's across steps)
) -> KLTResult:
    """Pyramidal LK, coarse to fine over `levels`+1 images. `patch` bounds
    the per-level trackable displacement (margin = patch/2 - half - 2 px at
    the coarsest level)."""
    if prev_pyr is None:
        prev_pyr = imops.build_pyramid(prev_img, levels)
    if next_pyr is None:
        next_pyr = imops.build_pyramid(next_img, levels)

    pts = prev_pts / 2.0**levels
    status = valid
    err = torch.zeros(prev_pts.shape[0], dtype=next_img.dtype, device=next_img.device)
    for lvl in range(levels, -1, -1):
        pts, status, err = _track_level(
            prev_pyr[lvl], next_pyr[lvl], prev_pts / 2.0**lvl, pts, status,
            half, iters, S=patch,
        )
        if lvl > 0:
            pts = pts * 2.0
    return KLTResult(pts=pts, status=status, err=err)
