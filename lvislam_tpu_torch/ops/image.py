"""Image primitives for the visual front end — port of
``lvislam_tpu.ops.image``: pyramids, gradients, bilinear sampling, global
histogram equalization and CLAHE.

These feed ``ops.klt`` (pyramidal Lucas-Kanade) and ``ops.gftt``
(Shi-Tomasi). Convolutions are edge-clamped shifted adds in the JAX
module's tap order, so the two agree to f32 rounding. ``clahe`` runs its
two image passes through kernels K3 (``ops.clahe.tile_hist``) and K4
(``ops.clahe.apply_cdf``); the clip/redistribute/cumsum between them works
on a (tiles², bins) table and stays plain torch.
"""

from __future__ import annotations

import torch

from . import clahe as clahe_ops

_GAUSS5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _axis_conv(img: torch.Tensor, k, axis: int) -> torch.Tensor:
    """1D cross-correlation along `axis` with edge padding, as K shifted
    adds (the JAX module's tap order)."""
    K = len(k)
    pad = K // 2
    n = img.shape[axis]
    idx = torch.clamp(torch.arange(-pad, n + pad, device=img.device), 0, n - 1)
    x = img.index_select(axis, idx)
    out = None
    for i in range(K):
        term = x.narrow(axis, i, n) * k[i]
        out = term if out is None else out + term
    return out


def _sep_conv(img: torch.Tensor, k) -> torch.Tensor:
    """Separable 2D convolution with edge padding, (H, W) x (K,)."""
    return _axis_conv(_axis_conv(img, k, 0), k, 1)


def _shift_edge(x: torch.Tensor, i: int, axis: int) -> torch.Tensor:
    """Shift by i along `axis` with edge clamp."""
    if i == 0:
        return x
    n = x.shape[axis]
    if i > 0:
        return torch.cat([x.narrow(axis, 0, 1).repeat_interleave(i, axis),
                          x.narrow(axis, 0, n - i)], axis)
    return torch.cat([x.narrow(axis, -i, n + i),
                      x.narrow(axis, n - 1, 1).repeat_interleave(-i, axis)], axis)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Gaussian blur + 2x decimation (cv::pyrDown with edge-clamped
    borders). Even width: the JAX module's polyphase form (vertical 5-tap,
    decimate rows, then even/odd column phases with the two border columns
    patched to exact edge clamp). Odd width: the pad-based separable form."""
    k = _GAUSS5
    if img.shape[1] % 2:
        return _sep_conv(img, k)[::2, ::2]
    xv = (
        _shift_edge(img, 2, 0) * k[0] + _shift_edge(img, 1, 0) * k[1]
        + img * k[2]
        + _shift_edge(img, -1, 0) * k[3] + _shift_edge(img, -2, 0) * k[4]
    )[::2]
    e, o = xv[:, ::2], xv[:, 1::2]
    out = (
        _shift_edge(e, 1, 1) * k[0] + _shift_edge(o, 1, 1) * k[1]
        + e * k[2] + o * k[3] + _shift_edge(e, -1, 1) * k[4]
    )
    left = xv[:, 0] * (k[0] + k[1] + k[2]) + xv[:, 1] * k[3] + xv[:, 2] * k[4]
    right = (
        xv[:, -4] * k[0] + xv[:, -3] * k[1] + xv[:, -2] * k[2]
        + xv[:, -1] * (k[3] + k[4])
    )
    out = out.clone()
    out[:, 0] = left
    out[:, -1] = right
    return out


def build_pyramid(img: torch.Tensor, levels: int):
    """List of `levels`+1 images, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def scharr_gradients(img: torch.Tensor):
    """Scharr 3x3 x/y gradients: gx = smooth_y(img(x+1) - img(x-1))."""
    kd = [-1.0, 0.0, 1.0]
    ks = [3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0]
    gx = _axis_conv(_axis_conv(img, ks, 0), kd, 1)
    gy = _axis_conv(_axis_conv(img, ks, 1), kd, 0)
    return gx, gy


def sobel_gradients(img: torch.Tensor):
    kd = [-0.5, 0.0, 0.5]
    ks = [0.25, 0.5, 0.25]
    gx = _axis_conv(_axis_conv(img, ks, 0), kd, 1)
    gy = _axis_conv(_axis_conv(img, ks, 1), kd, 0)
    return gx, gy


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of (H, W) at float coords xy (..., 2) in
    (x, y) pixel convention. Out-of-bounds clamps to the border."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi, yi = x0.long(), y0.long()
    i00 = img[yi, xi]
    i01 = img[yi, xi + 1]
    i10 = img[yi + 1, xi]
    i11 = img[yi + 1, xi + 1]
    return (
        i00 * (1 - fx) * (1 - fy)
        + i01 * fx * (1 - fy)
        + i10 * (1 - fx) * fy
        + i11 * fx * fy
    )


def extract_patches(img: torch.Tensor, centers: torch.Tensor, half: int):
    """Batched bilinear patch extraction: (N, 2) float centers ->
    (N, 2*half+1, 2*half+1) patches."""
    k = 2 * half + 1
    off = torch.arange(k, dtype=img.dtype, device=img.device) - half
    ox, oy = torch.meshgrid(off, off, indexing="xy")  # x varies along cols
    coords = centers[:, None, None, :] + torch.stack([ox, oy], dim=-1)[None]
    return bilinear_sample(img, coords)


def equalize_hist(img: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """Global histogram equalization. The counts are integers, so their
    cumulative sum is exact (and deterministic on the card) in int64."""
    scaled = torch.clamp(img.reshape(-1), 0.0, 1.0) * (n_bins - 1)
    b = scaled.to(torch.int64)
    cdf = torch.cumsum(torch.bincount(b, minlength=n_bins), 0).to(torch.float32)
    cdf = (cdf - cdf[0]) / torch.clamp(cdf[-1] - cdf[0], min=1.0)
    return cdf[b].reshape(img.shape).to(img.dtype)


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis by log2(n) shifted adds.
    ``torch.cumsum`` of floats has no deterministic CUDA implementation
    (it raises under ``torch.use_deterministic_algorithms``); this form is
    deterministic on every device and agrees with a sequential sum to f32
    rounding."""
    n = x.shape[-1]
    s = 1
    while s < n:
        x = torch.cat([x[..., :s], x[..., s:] + x[..., :-s]], dim=-1)
        s *= 2
    return x


def clip_cdf(hist: torch.Tensor, tile_pixels: int, clip_limit: float = 3.0) -> torch.Tensor:
    """Tile histograms (T*T, n_bins) -> clipped, redistributed, normalized
    CDFs in [0, 1]: the step between CLAHE's two image passes."""
    n_bins = hist.shape[1]
    limit = clip_limit * tile_pixels / n_bins
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / n_bins
    cdf = _cumsum_last(hist)
    return cdf / torch.clamp(cdf[:, -1:], min=1.0)


def clahe(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8,
          n_bins: int = 256, use_kernels: bool | None = None) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization (cv::CLAHE,
    `feature_tracker.cpp:86-92`: clipLimit 3.0, 8x8 tiles). Tile histograms
    over the cropped ``th*tiles x tw*tiles`` region are clipped and
    redistributed; each pixel of the whole image bilinearly interpolates
    the CDFs of its 4 surrounding tiles.

    ``use_kernels`` (JAX's ``use_pallas``): True runs the passes through
    the K3/K4 wrappers (the kernels on a CUDA tensor), False through their
    plain versions; None means kernels iff `img` is on CUDA."""
    H, W = img.shape
    th, tw = H // tiles, W // tiles
    if use_kernels is None:
        use_kernels = img.is_cuda
    x = img.to(torch.float32).contiguous()
    if use_kernels:
        hist = clahe_ops.tile_hist(x, tiles=tiles, n_bins=n_bins)
    else:
        hist = clahe_ops.tile_hist_plain(x, tiles=tiles, n_bins=n_bins)
    cdf = clip_cdf(hist, th * tw, clip_limit)
    if use_kernels:
        out = clahe_ops.apply_cdf(x, cdf, tiles=tiles)
    else:
        out = clahe_ops.apply_cdf_plain(x, cdf, tiles=tiles)
    return out.to(img.dtype)
