"""A PNG codec of the port's own (no PIL): EuRoC's ``cam0`` frames and PNG
``CompressedImage`` blobs are decoded here, as ``utils/jpeg.py`` decodes
JPEG.

Decoder (`decode`, `decode_gray`): the chunk stream (CRC-checked), the
``IDAT`` data inflated by the standard library's ``zlib``, and the five row
filters of the PNG specification (§9: None, Sub, Up, Average, Paeth) undone.
8-bit greyscale, greyscale + alpha, RGB and RGBA are read; `decode_gray`
turns them into one grey channel by PIL's ``convert("L")`` rule (ITU-R
601-2 luma in 16-bit fixed point with rounding; the alpha channel dropped),
so a frame decodes to PIL's bytes. Interlaced (Adam7), 16-bit (and 1/2/4
bit) and palette PNGs raise ``NotImplementedError`` naming the cause; a
truncated or corrupt file raises ``ValueError``.

The filters: Average and Paeth chain each byte to its left neighbour, and
every filter but None to the row above, so all five are undone together
along anti-diagonals of the pixel grid (pixel (r, c) needs (r, c-1),
(r-1, c) and (r-1, c-1), all on the two diagonals before it): the Python
loop runs H + W - 1 times, each step a vector over the rows.

Writer (`encode`): 8-bit grey / grey + alpha / RGB / RGBA, one filter type
for every row or a list of them, or ``"adaptive"`` (the minimum-sum-of-
absolute-differences choice a row, as libpng's heuristic), zlib level 6.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels (8-bit)
_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale + alpha", 6: "RGBA"}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG file (no IEND)")


def _header(body: bytes):
    if len(body) != 13:
        raise ValueError("PNG IHDR of the wrong length")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if ctype == 3:
        raise NotImplementedError("palette PNG (colour type 3) is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not valid")
    if depth != 8:
        raise NotImplementedError(
            f"{depth}-bit PNG ({_NAMES[ctype]}) is not supported: only 8 bits a sample")
    if interlace != 0:
        raise NotImplementedError("interlaced (Adam7) PNG is not supported")
    if comp != 0 or filt != 0:
        raise ValueError("PNG compression or filter method is not 0")
    if w == 0 or h == 0:
        raise ValueError("PNG of zero size")
    return w, h, _CHANNELS[ctype]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(types: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the row filters of `filt` (H, W, C) uint8, one type a row, all
    rows at once along anti-diagonals of the pixel grid: H + W - 1 steps,
    each a vector over the rows. The bytes are stored skewed
    (S[d + 2, r + 1] holds pixel (r, d - r); row -1 and the pixels left of
    column 0 stay 0), so a step's left, upper and upper-left neighbours are
    contiguous slices of the two diagonals before it."""
    H, W, C = filt.shape
    if types.max(initial=0) > 4:
        raise ValueError(f"PNG row filter type {int(types.max())} is not valid")
    D = H + W - 1
    r = np.arange(H)[:, None]
    k = r + np.arange(W)[None, :]
    F = np.zeros((D, H, C), np.int16)
    F[k, r] = filt
    S = np.zeros((D + 2, H + 1, C), np.int16)
    t = types.astype(np.int16)[:, None]
    zero = np.zeros((H, C), np.int16)
    for d in range(D):
        lo, hi = max(0, d - W + 1), min(H - 1, d) + 1
        a = S[d + 1, lo + 1:hi + 1]  # left: pixel (r, p - 1)
        b = S[d + 1, lo:hi]  # up: pixel (r - 1, p)
        c = S[d, lo:hi]  # up-left: pixel (r - 1, p - 1)
        ab = a + b
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(ab - c - c)  # |p-a|, |p-b|, |p-c|
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(t[lo:hi], (zero[:hi - lo], a, b, ab >> 1, paeth))
        S[d + 2, lo + 1:hi + 1] = (F[d, lo:hi] + pred) & 255
    return S[k + 2, r + 1].astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A PNG file's pixels as (H, W, C) uint8, C = 1, 2, 3 or 4 (grey, grey
    + alpha, RGB, RGBA)."""
    header = None
    idat = []
    for kind, body in _chunks(bytes(data)):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE" and header is None:
            raise ValueError("PNG PLTE before IHDR")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    W, H, C = header
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from None
    stride = 1 + W * C
    if len(raw) < H * stride:
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, count=H * stride).reshape(H, stride)
    return _unfilter(rows[:, 0], rows[:, 1:].reshape(H, W, C))


def to_gray(px: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W) uint8 by PIL's ``convert("L")``: grey and
    grey + alpha keep the grey channel; RGB / RGBA take
    (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    if px.shape[-1] <= 2:
        return np.ascontiguousarray(px[..., 0])
    r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def decode_gray(data: bytes) -> np.ndarray:
    """A PNG file as (H, W) uint8 grey, bit-equal to PIL's
    ``Image.open(...).convert("L")``."""
    return to_gray(decode(data))


def read_gray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gray(f.read())


def _filter_row(t: int, x: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """Filter one row (W, C) int32 against `prior` with type `t`."""
    a = np.zeros_like(x)
    a[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:] = prior[:-1]
    pred = (0, a, prior, (a + prior) >> 1, None)[t] if t < 4 else _paeth(a, prior, c)
    return (x - pred) & 255


def encode(img: np.ndarray, filter_type="adaptive", level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8 (C = 1, 2, 3, 4) as an 8-bit PNG file.
    `filter_type`: 0-4 for every row, a sequence of one type a row, or
    ``"adaptive"``."""
    px = np.asarray(img)
    if px.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, not {px.dtype}")
    if px.ndim == 2:
        px = px[..., None]
    H, W, C = px.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    x = px.astype(np.int32)
    prior = np.zeros((W, C), np.int32)
    out = bytearray()
    for r in range(H):
        if filter_type == "adaptive":
            cands = [_filter_row(t, x[r], prior) for t in range(5)]
            # signed-byte magnitudes (libpng's minimum sum of absolute differences)
            cost = [np.abs(np.where(f > 127, f - 256, f)).sum() for f in cands]
            t = int(np.argmin(cost))
            row = cands[t]
        else:
            t = int(filter_type if np.isscalar(filter_type) else filter_type[r])
            row = _filter_row(t, x[r], prior)
        out.append(t)
        out += row.astype(np.uint8).tobytes()
        prior = x[r]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out), level))
            + chunk(b"IEND", b""))


def write(path: str, img: np.ndarray, filter_type="adaptive") -> None:
    with open(path, "wb") as f:
        f.write(encode(img, filter_type))
