"""Chessboard inner-corner detection for camera calibration — port of
``lvislam_tpu.ops.chessboard``.

The reference's calibration tool detects corners with OpenCV
`findChessboardCorners` + `cornerSubPix` (`camera_model/src/chessboard/
Chessboard.cc`, driven by `src/intrinsic_calib.cc`). Here, as in the JAX
package: a fixed-shape saddle-point detector (chessboard inner corners are
the strongest saddle points of the smoothed image, where -det(Hessian)
peaks), a quadratic subpixel step on the response surface, and a rank-based
grid ordering along the lattice's PCA axes. The detected board feeds
`ops.calibration.calibrate`.

Runs on the device of its input image, in float32. The separable Gaussian
is a sum over taps with the JAX module's reflect padding; the strongest
``rows * cols + 1`` responses are taken by a stable descending sort, so
equal responses go to the lower flat index, as ``lax.top_k`` breaks ties.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.device import resolve as resolve_device


def _gauss_kernel(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _conv_valid(p: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """'valid' convolution of `p` with the (symmetric) kernel `k` along
    `dim`, as a sum over taps."""
    n = p.shape[dim] - k.shape[0] + 1
    out = p.narrow(dim, 0, n) * k[-1]
    for t in range(1, k.shape[0]):
        out = out + p.narrow(dim, t, n) * k[k.shape[0] - 1 - t]
    return out


def _sep_conv(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 2-d convolution with reflect padding (H, W)."""
    r = (k.shape[0] - 1) // 2
    p = F.pad(img[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    img = _conv_valid(p, k, 0)
    p = F.pad(img[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    return _conv_valid(p, k, 1)


def saddle_response(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """-det(Hessian) of the Gaussian-smoothed image: large and positive at
    checker saddle points, negative at blobs/edges."""
    g = _sep_conv(img.to(torch.float32), _gauss_kernel(sigma, int(3 * sigma), img.device))
    ixx = F.pad(g[:, 2:] - 2 * g[:, 1:-1] + g[:, :-2], (1, 1, 0, 0))
    iyy = F.pad(g[2:, :] - 2 * g[1:-1, :] + g[:-2, :], (0, 0, 1, 1))
    ix = F.pad((g[:, 2:] - g[:, :-2]) * 0.5, (1, 1, 0, 0))
    ixy = F.pad((ix[2:, :] - ix[:-2, :]) * 0.5, (0, 0, 1, 1))
    return ixy * ixy - ixx * iyy


def _nms(resp: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep local maxima within a (2r+1)^2 window ('SAME', -inf padding)."""
    mx = F.max_pool2d(resp[None, None], 2 * radius + 1, stride=1, padding=radius)[0, 0]
    return resp >= mx


def find_chessboard(
    img: torch.Tensor,  # (H, W) grayscale, any numeric dtype
    rows: int,
    cols: int,
    sigma: float = 2.0,
    nms_radius: int = 5,
):
    """Detect a (rows x cols) inner-corner grid.

    Returns (corners (rows*cols, 2) float32 [x, y] ordered row-major along
    the board axes, found: () bool tensor). `found` is False when the top
    responses don't form a clean rows x cols lattice (the weakest accepted
    corner against the next candidate)."""
    H, W = img.shape
    dev = img.device
    n = rows * cols
    resp = saddle_response(img, sigma)
    b = max(3, int(2 * sigma))
    mask = torch.zeros((H, W), dtype=torch.bool, device=dev)
    mask[b:H - b, b:W - b] = True
    resp = torch.where(mask & _nms(resp, nms_radius), resp,
                       torch.full_like(resp, -float("inf")))

    flat = resp.reshape(-1)
    srt = torch.sort(flat, descending=True, stable=True)
    top_v, top_i = srt.values[:n + 1], srt.indices[:n + 1]

    found = (top_v[n - 1] > 0) & (top_v[n - 1] > 2.5 * torch.clamp(top_v[n], min=0.0))

    yi = torch.clamp(top_i[:n] // W, 1, H - 2)
    xi = torch.clamp(top_i[:n] % W, 1, W - 2)
    # 3x3 response neighbourhood of each corner: nb[:, dy, dx]
    off = torch.arange(-1, 2, device=dev)
    nb = resp[(yi[:, None, None] + off[None, :, None]),
              (xi[:, None, None] + off[None, None, :])]
    dx = (nb[:, 1, 2] - nb[:, 1, 0]) * 0.5
    dy = (nb[:, 2, 1] - nb[:, 0, 1]) * 0.5
    dxx = nb[:, 1, 2] - 2 * nb[:, 1, 1] + nb[:, 1, 0]
    dyy = nb[:, 2, 1] - 2 * nb[:, 1, 1] + nb[:, 0, 1]
    dxy = (nb[:, 2, 2] - nb[:, 2, 0] - nb[:, 0, 2] + nb[:, 0, 0]) * 0.25
    det = dxx * dyy - dxy * dxy
    zero = torch.zeros_like(det)
    ok = torch.abs(det) > 1e-9
    ox = torch.clamp(torch.where(ok, -(dyy * dx - dxy * dy) / det, zero), -1.0, 1.0)
    oy = torch.clamp(torch.where(ok, -(dxx * dy - dxy * dx) / det, zero), -1.0, 1.0)
    pts = torch.stack([xi.to(torch.float32) + ox, yi.to(torch.float32) + oy], dim=-1)

    # --- order into a row-major grid along the board's own axes ---
    c = pts - torch.mean(pts, dim=0)
    cov = c.T @ c
    tr = cov[0, 0] + cov[1, 1]
    d = cov[0, 0] * cov[1, 1] - cov[0, 1] * cov[1, 0]
    lam1 = 0.5 * tr + torch.sqrt(torch.clamp(0.25 * tr * tr - d, min=0.0))
    v1 = torch.stack([cov[0, 1], lam1 - cov[0, 0]])
    v1 = torch.where(torch.linalg.norm(v1) < 1e-9,
                     torch.tensor([1.0, 0.0], dtype=pts.dtype, device=dev), v1)
    v1 = v1 / torch.linalg.norm(v1)
    v2 = torch.stack([-v1[1], v1[0]])
    long_is_cols = cols >= rows
    a = c @ (v1 if long_is_cols else v2)  # along-row coordinate
    bb = c @ (v2 if long_is_cols else v1)  # across-row coordinate

    row_order = torch.argsort(bb, stable=True)
    a_rows = a[row_order].reshape(rows, cols)
    inrow = torch.argsort(a_rows, dim=1, stable=True)
    order = torch.gather(row_order.reshape(rows, cols), 1, inrow)
    ordered = pts[order.reshape(-1)]

    flip = torch.sum(ordered[0] ** 2) > torch.sum(ordered[-1] ** 2)
    ordered = torch.where(flip, torch.flip(ordered, [0]), ordered)
    return ordered, found


def board_object_points(rows: int, cols: int, square: float, device=None) -> torch.Tensor:
    """(rows*cols, 3) planar board coordinates matching `find_chessboard`'s
    row-major ordering (z = 0), `square` metres per cell, on `device` (the
    card unless named)."""
    device = resolve_device(device)
    ii, jj = torch.meshgrid(torch.arange(rows, device=device),
                            torch.arange(cols, device=device), indexing="ij")
    return torch.stack(
        [jj.reshape(-1) * square, ii.reshape(-1) * square,
         torch.zeros(rows * cols, device=device)], dim=-1,
    ).to(torch.float32)
