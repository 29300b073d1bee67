"""Kernels K3 and K4: the two image passes of CLAHE.

Replace the TPU kernels of ``lvislam_tpu/ops/pallas_clahe.py``:

- K3 ``tile_hist`` (``pallas_clahe.py:53``, body ``_hist_kernel``): the
  ``n_bins``-bin histogram of each tile of a ``tiles x tiles`` tiling of the
  cropped ``th*tiles x tw*tiles`` image region, as exact counts in f32, tile
  row-major. The kernel bins the f32 image itself, exactly as
  ``image.clahe`` does: ``(int)(clamp(x, 0, 1) * (n_bins - 1))``, truncated.
- K4 ``apply_cdf`` (``pallas_clahe.py:98 apply_lut``, body
  ``_apply_kernel``): each pixel of the whole image takes its bin and blends
  the CDFs of its 4 surrounding tiles with ``lerp_mat``'s two-tap weights
  (``lvislam_tpu/ops/image.py:220-230``): rows first, then columns. This is
  the field the TPU kernel's separable 3-row form computes, without its
  (tiles, n_bins, W) x-pass table.

CUDA design (``csrc/clahe.cu``). Both kernels move so few bytes (2.4 and
4.8 MB at 576x1024: 0.7 and 1.4 us at the H100's memory rate) that a
launch's fixed cost and the latency of a dependent chain of loads bound
them, not the bytes. So both fill the card with blocks and have each thread
start all its 16-byte loads before it waits on any:

- K3: a tile is cut into ``hist_slabs`` bands of rows, one block each
  (about two blocks an SM); each warp counts into its own ``n_bins`` ints of
  shared memory with integer ``atomicAdd``; the tile's blocks are one
  thread block cluster, which sums their counts through distributed shared
  memory in the same launch and writes each f32 bin once. Integer counts
  are the same in any order, so the result repeats bit for bit and equals
  ``torch.bincount``.
- K4: blocks are cut along the interpolation lattice (``axis_blocks``): all
  pixels of one block blend the same 2 x 2 tiles, whose CDFs are the
  block's window, brought into shared memory by bulk copies that run while
  the pixel loads are in flight. A thread owns 4 neighbouring columns and walks ``APPLY_ROWS`` rows at most. Every multiply
  and add is rounded on its own (``__fmul_rn`` / ``__fadd_rn``), in the
  plain version's order, so kernel and plain version agree bit for bit.

A shape or a base address that the vector kernels do not take
(``hist_path``, ``apply_path``) goes to the general kernels: one block a
tile with scalar loads for K3, one thread a column with a window of up to
4 x 5 tiles for K4. The rule is decided on sizes and alignment before the
launch; nothing falls back after one.
"""

from __future__ import annotations

import functools

import torch

from . import _kernels

HIST_LAUNCHES = 0  # K3 launches since the last reset (chip_smoke reads it)
APPLY_LAUNCHES = 0  # K4 launches since the last reset

_MAX_BINS = 4096
APPLY_ROWS = 24  # K4's rows a block at most (a lattice cell of fewer rows is one block)
_MAX_SLABS = 8  # K3's bands a tile at most: the portable cluster size


def _bins(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    return (torch.clamp(x, 0.0, 1.0) * (n_bins - 1)).to(torch.int64)


def _check(img: torch.Tensor, tiles: int, n_bins: int, name: str):
    if img.dtype != torch.float32 or img.dim() != 2:
        raise TypeError(f"{name}: expects a 2D float32 image, got "
                        f"{img.dtype} {tuple(img.shape)}")
    H, W = img.shape
    if tiles < 1 or H < tiles or W < tiles:
        raise ValueError(f"{name}: {H}x{W} image too small for {tiles}x{tiles} tiles")
    if not 2 <= n_bins <= _MAX_BINS:
        raise ValueError(f"{name}: n_bins={n_bins} outside [2, {_MAX_BINS}]")


# ---------------------------------------------------------------------------
# K3: per-tile histogram
# ---------------------------------------------------------------------------

def tile_hist_plain(img: torch.Tensor, tiles: int = 8, n_bins: int = 256) -> torch.Tensor:
    """Plain PyTorch version: (tiles*tiles, n_bins) f32 exact counts."""
    H, W = img.shape
    th, tw = H // tiles, W // tiles
    b = _bins(img[: th * tiles, : tw * tiles], n_bins)
    ty = torch.arange(th * tiles, device=img.device) // th
    tx = torch.arange(tw * tiles, device=img.device) // tw
    tile = ty[:, None] * tiles + tx[None, :]
    flat = (tile * n_bins + b).reshape(-1)
    counts = torch.bincount(flat, minlength=tiles * tiles * n_bins)
    return counts.reshape(tiles * tiles, n_bins).to(torch.float32)


def hist_path(H: int, W: int, tiles: int, img_ptr: int) -> str:
    """Which K3 kernel takes an (H, W) image at address `img_ptr`: "vector"
    (16-byte loads: every tile row starts on a 16-byte boundary) or
    "general"."""
    if W % 4 == 0 and (W // tiles) % 4 == 0 and img_ptr % 16 == 0:
        return "vector"
    return "general"


def hist_slabs(th: int, tiles: int, n_sm: int) -> int:
    """Bands of rows a tile of `th` rows is cut into, one block each: the
    smallest power of two that gives the card three blocks for every two
    SMs, at most `_MAX_SLABS` and at most `th` (no band is empty). At
    576x1024 in 8x8 tiles on 132 SMs that is 4 (256 blocks of 18 rows),
    which measured faster than 2 and than 8."""
    s = 1
    while 2 * tiles * tiles * s < 3 * n_sm and 2 * s <= min(_MAX_SLABS, th):
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_hist(img: torch.Tensor, tiles: int = 8, n_bins: int = 256) -> torch.Tensor:
    """Per-tile histograms of the (H, W) f32 image in [0, 1]. Returns
    (tiles*tiles, n_bins) f32, tile row-major. A CPU tensor takes the plain
    version; a CUDA tensor launches kernel K3."""
    global HIST_LAUNCHES
    if img.device.type == "cpu":
        return tile_hist_plain(img, tiles, n_bins)
    if img.device.type != "cuda":
        raise ValueError(f"tile_hist: unsupported device {img.device}")
    _check(img, tiles, n_bins, "tile_hist")
    img = img.contiguous()
    H, W = img.shape
    hist = torch.empty((tiles * tiles, n_bins), dtype=torch.float32, device=img.device)
    slabs = 0  # the general kernel
    if hist_path(H, W, tiles, img.data_ptr()) == "vector":
        slabs = hist_slabs(H // tiles, tiles, _sm_count(img.device.index))
    lib = _kernels.library()
    with torch.cuda.device(img.device):  # launch on the input's card
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.lvt_clahe_hist(img.data_ptr(), hist.data_ptr(), H, W, tiles, n_bins, slabs,
                                 stream)
        _kernels.check(err, "lvt_clahe_hist")
    HIST_LAUNCHES += 1
    return hist


# ---------------------------------------------------------------------------
# K4: CDF application
# ---------------------------------------------------------------------------

def _lerp_taps(n: int, tiles: int, span: int, device):
    """``image.py:lerp_mat`` as taps: for each of n pixels along an axis,
    the two tile indices (i0, i1) and their weights (1 - f, f). Computed on
    the host, where ``/ span`` is a true division (PyTorch's CUDA division
    by a scalar multiplies by its reciprocal), as K4 computes it."""
    cc = (torch.arange(n, dtype=torch.float32) + 0.5) / span - 0.5
    i0 = torch.clamp(torch.floor(cc), 0, tiles - 1)
    i1 = torch.clamp(i0 + 1, max=tiles - 1)
    f = torch.clamp(cc - i0, 0.0, 1.0)
    return (i0.long().to(device), i1.long().to(device), (1.0 - f).to(device),
            f.to(device))


def apply_cdf_plain(img: torch.Tensor, cdf: torch.Tensor, tiles: int = 8) -> torch.Tensor:
    """Plain PyTorch version: (H, W) f32, the 4-tile bilinear CDF blend at
    each pixel's bin, rows first: ``wx0*(wy0*c00 + wy1*c10) + wx1*(wy0*c01
    + wy1*c11)``."""
    H, W = img.shape
    n_bins = cdf.shape[1]
    th, tw = H // tiles, W // tiles
    r0, r1, wy0, wy1 = _lerp_taps(H, tiles, th, img.device)
    s0, s1, wx0, wx1 = _lerp_taps(W, tiles, tw, img.device)
    b = _bins(img, n_bins)
    flat = cdf.reshape(-1)

    def tap(r, s):
        return flat[(r[:, None] * tiles + s[None, :]) * n_bins + b]

    wy0, wy1 = wy0[:, None], wy1[:, None]
    a0 = wy0 * tap(r0, s0) + wy1 * tap(r1, s0)
    a1 = wy0 * tap(r0, s1) + wy1 * tap(r1, s1)
    return wx0[None, :] * a0 + wx1[None, :] * a1


def apply_path(H: int, W: int, tiles: int, n_bins: int, *ptrs: int) -> str:
    """Which K4 kernel takes an (H, W) image with tensors at addresses
    `ptrs` (image, CDFs, result): "vector" (16-byte loads and stores; every
    lattice cell starts on a multiple of 4 columns, which half a tile of
    tw % 8 == 0 columns does; CDF rows of whole 16 bytes for the window's
    bulk copies) or "general"."""
    if (W % 4 == 0 and (W // tiles) % 8 == 0 and n_bins % 4 == 0
            and all(p % 16 == 0 for p in ptrs)):
        return "vector"
    return "general"


@functools.lru_cache(maxsize=None)
def axis_blocks(n: int, tiles: int, size: int) -> tuple:
    """The vector K4's blocks along an axis of `n` pixels in `tiles` tiles:
    (lo, hi) pixel ranges, in block order. The axis is first cut into the
    interpolation lattice's cells (between two neighbouring tile centres
    every pixel has the same two taps: [0, half), then tiles-1 cells of one
    tile's span, then the rest, with half = span // 2 the first pixel whose
    ``lerp_mat`` coordinate is not negative), then each cell into blocks of
    `size` pixels. This is the host's model of the partition, for the
    tests: the kernel finds its ranges from the block index
    (``csrc/clahe.cu:axis_block``), along x in blocks of a tile's width
    rounded up to a power of two, 256 columns at most."""
    span = n // tiles
    half = span // 2
    edges = [0] + [half + c * span for c in range(tiles)] + [n]
    return tuple((lo, min(lo + size, end)) for start, end in zip(edges[:-1], edges[1:])
                 for lo in range(start, end, size))


def apply_cdf(img: torch.Tensor, cdf: torch.Tensor, tiles: int = 8) -> torch.Tensor:
    """Bilinear tile-CDF application. img (H, W) f32 in [0, 1]; cdf
    (tiles*tiles, n_bins) f32, tile row-major. Returns (H, W) f32. A CPU
    tensor takes the plain version; a CUDA tensor launches kernel K4."""
    global APPLY_LAUNCHES
    if img.device.type == "cpu":
        return apply_cdf_plain(img, cdf, tiles)
    if img.device.type != "cuda":
        raise ValueError(f"apply_cdf: unsupported device {img.device}")
    n_bins = cdf.shape[-1]
    _check(img, tiles, n_bins, "apply_cdf")
    if cdf.dtype != torch.float32 or cdf.shape != (tiles * tiles, n_bins):
        raise ValueError(f"apply_cdf: cdf must be ({tiles * tiles}, n_bins) "
                         f"float32, got {cdf.dtype} {tuple(cdf.shape)}")
    if cdf.device != img.device:
        raise ValueError("apply_cdf: inputs on different devices")
    img, cdf = img.contiguous(), cdf.contiguous()
    H, W = img.shape
    out = torch.empty((H, W), dtype=torch.float32, device=img.device)
    rows = 0  # the general kernel
    if apply_path(H, W, tiles, n_bins, img.data_ptr(), cdf.data_ptr(),
                  out.data_ptr()) == "vector":
        rows = APPLY_ROWS
    lib = _kernels.library()
    with torch.cuda.device(img.device):  # launch on the input's card
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.lvt_clahe_apply(img.data_ptr(), cdf.data_ptr(), out.data_ptr(),
                                  H, W, tiles, n_bins, rows, stream)
        _kernels.check(err, "lvt_clahe_apply")
    APPLY_LAUNCHES += 1
    return out
