"""Shi-Tomasi corner detection with grid non-max suppression — port of
``lvislam_tpu.ops.gftt``.

The reference's goodFeaturesToTrack refill with its min-distance mask
(`feature_tracker.cpp:36-69,162-191`) becomes a min_dist x min_dist grid:
one response maximum per cell, cells holding a tracked feature excluded.
"""

from __future__ import annotations

import torch

from . import image as imops


def shi_tomasi_response(img: torch.Tensor, block: int = 3) -> torch.Tensor:
    """Min-eigenvalue corner response of the structure tensor."""
    gx, gy = imops.sobel_gradients(img)
    # the box tap as JAX forms it: 1/block rounded to f32
    w = float(torch.tensor(1.0, dtype=torch.float32) / block)
    k = [w] * block
    sxx = imops._sep_conv(gx * gx, k)
    sxy = imops._sep_conv(gx * gy, k)
    syy = imops._sep_conv(gy * gy, k)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    return (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / 2.0


def _excluded_cells(existing_pts, existing_valid, cell: int, gh: int, gw: int):
    """(gh, gw) bool: cells holding a tracked feature.

    JAX writes ``existing_valid`` into the cells with one scatter
    (``gftt.py:63-67``). Free slots map to cell (0, 0) with the value False,
    so a tracked feature in cell (0, 0) shares that cell with them, and
    XLA keeps the write of the highest slot index. This reproduces that
    rule exactly and deterministically on any device: each cell takes the
    value of its highest-index writer, and cells nobody writes stay False."""
    ex = torch.where(existing_valid[:, None], existing_pts,
                     torch.full_like(existing_pts, -1e6))
    cx = torch.clamp(torch.div(ex[:, 0], cell, rounding_mode="floor").to(torch.int32), 0, gw - 1)
    cy = torch.clamp(torch.div(ex[:, 1], cell, rounding_mode="floor").to(torch.int32), 0, gh - 1)
    flat = (cy * gw + cx).long()
    M = existing_valid.shape[0]
    last = torch.full((gh * gw,), -1, dtype=torch.long, device=flat.device)
    last = last.scatter_reduce(0, flat, torch.arange(M, device=flat.device), "amax")
    exc = (last >= 0) & existing_valid[torch.clamp(last, min=0)]
    return exc.reshape(gh, gw)


def detect(
    img: torch.Tensor,  # (H, W) float
    existing_pts: torch.Tensor,  # (M, 2) current tracked feature pixels
    existing_valid: torch.Tensor,  # (M,)
    max_pts: int,
    cell: int = 20,  # MIN_DIST
    quality_level: float = 0.01,
    border: int = 10,
):
    """Returns (pts (max_pts, 2), valid (max_pts,)) new corners, strongest
    first (ties to the lower cell index, as ``lax.top_k``)."""
    H, W = img.shape
    dev = img.device
    resp = shi_tomasi_response(img)
    # zero the border (reference BORDER_SIZE culling, `inBorder` `:12-18`)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    resp = torch.where(inb, resp, torch.zeros_like(resp))

    gh, gw = H // cell, W // cell
    rc = resp[: gh * cell, : gw * cell].reshape(gh, cell, gw, cell)
    cell_max = rc.amax(dim=(1, 3))  # (gh, gw)
    flat_arg = torch.argmax(rc.permute(0, 2, 1, 3).reshape(gh, gw, cell * cell), dim=-1)
    py = torch.arange(gh, device=dev)[:, None] * cell + flat_arg // cell
    px = torch.arange(gw, device=dev)[None, :] * cell + flat_arg % cell

    exc = _excluded_cells(existing_pts, existing_valid, cell, gh, gw)
    thresh = quality_level * torch.max(resp)
    good = (cell_max > thresh) & (~exc)
    score = torch.where(good, cell_max, torch.full_like(cell_max, -float("inf"))).reshape(-1)
    srt = torch.sort(score, descending=True, stable=True)
    top, sel = srt.values[:max_pts], srt.indices[:max_pts]
    pts = torch.stack([px.reshape(-1)[sel], py.reshape(-1)[sel]], dim=-1).to(img.dtype)
    return pts, top > -float("inf")
