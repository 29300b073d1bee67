"""A baseline JPEG decoder to 8-bit grayscale, so the port reads the
``sensor_msgs/CompressedImage`` frames of a bag without PIL.

Scope: baseline frames (SOF0: sequential, Huffman-coded, 8-bit samples); Huffman (DHT) and quantization (DQT, 8- or 16-bit) tables
from the stream; restart intervals (DRI / RSTn); one component, or three
(YCbCr) with any sampling factors, of which only Y is decoded: the output
is the luma plane, cropped to the frame's size. Everything else raises:
extended (SOF1), progressive (SOF2), lossless, hierarchical and
arithmetic-coded frames, 12-bit samples, two or four components, and an
Adobe RGB frame raise ``NotImplementedError``; a truncated or corrupt stream raises
``ValueError``.

A grayscale frame comes out bit-equal to libjpeg's (PIL's ``convert("L")``):
the inverse DCT is libjpeg's default integer ``JDCT_ISLOW`` (``jidctint.c``:
13-bit fixed-point constants, a 2-bit pass-1 scale, the descale by adding
half and shifting, and the range-limit table of ``jdmaster.c``). A colour
frame's Y plane differs from PIL's ``convert("L")`` by the rounding of the
YCbCr -> RGB -> L round trip and by RGB clamping.

Huffman decoding runs on the host (Python, one table lookup a code); the
dequantization and the inverse DCT are batched integer tensor ops over
every block of the frame (on the host: the frame is host data until
`LviSystem` uploads it).
"""

from __future__ import annotations

import numpy as np
import torch

# zigzag position k -> natural (row-major) index, with libjpeg's 16 extra
# entries so a corrupt run past 63 lands on coefficient 63
# (`jpeg_natural_order`, jutils.c)
_NATURAL = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16

# jidctint.c: FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0_298631336, _F0_390180644, _F0_541196100, _F0_765366865 = 2446, 3196, 4433, 6270
_F0_899976223, _F1_175875602, _F1_501321110, _F1_847759065 = 7373, 9633, 12299, 15137
_F1_961570560, _F2_053119869, _F2_562915447, _F3_072711026 = 16069, 16819, 20995, 25172


def _range_limit() -> torch.Tensor:
    """The post-IDCT range-limit table of `prepare_range_limit_table`
    (jdmaster.c), indexed by (descaled value & 1023)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return torch.from_numpy(t)


def _idct_1d(v, shift: int):
    """One 1-D pass of `jpeg_idct_islow` over 8 inputs (by frequency), each
    a tensor; returns the 8 outputs descaled by `shift` bits."""
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * _F0_541196100
    tmp2 = z1 - z3 * _F1_847759065
    tmp3 = z1 + z2 * _F0_765366865
    tmp0 = (v[0] + v[4]) << _CONST_BITS
    tmp1 = (v[0] - v[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175875602
    t0 = t0 * _F0_298631336
    t1 = t1 * _F2_053119869
    t2 = t2 * _F3_072711026
    t3 = t3 * _F1_501321110
    z1 = z1 * -_F0_899976223
    z2 = z2 * -_F2_562915447
    z3 = z3 * -_F1_961570560 + z5
    z4 = z4 * -_F0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(x + half) >> shift for x in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                          tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """libjpeg's `jpeg_idct_islow` on a batch of blocks: `coef` (N, 64)
    quantized coefficients in natural order, `quant` (64,) the table in
    natural order -> (N, 8, 8) uint8 samples. Exact integer arithmetic
    (int64), on the tensors' device."""
    x = (coef.to(torch.int64) * quant.to(coef.device, torch.int64)).reshape(-1, 8, 8)
    # pass 1: columns (the vertical frequencies, rows of the block)
    cols = _idct_1d([x[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)
    ws = torch.stack(cols, dim=1)
    # pass 2: rows
    rows = _idct_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)
    out = torch.stack(rows, dim=2)
    return _range_limit().to(out.device)[out & 1023]


class _Huffman:
    """A Huffman table as a 16-bit lookup: entry = (code length << 8) |
    symbol for every 16-bit window that starts with a code, 0 where none
    does."""

    def __init__(self, counts, symbols):
        lut = [0] * 65536
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if code >= (1 << length):
                    raise ValueError("JPEG: over-subscribed Huffman table")
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                lut[lo:hi] = [(length << 8) | symbols[k]] * (hi - lo)
                code += 1
                k += 1
            code <<= 1
        self.lut = lut


def _peek16(seg: bytes):
    """For each bit position of `seg`, the 16 bits from there (zeros past
    its end), as a list indexed by bit position."""
    b = np.frombuffer(seg + b"\x00" * 4, np.uint8).astype(np.uint32)
    w = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    shifts = np.arange(8, 0, -1, dtype=np.uint32)
    return ((w[:, None] >> shifts[None, :]) & 0xFFFF).ravel().tolist()


def _segments(data: bytes, start: int):
    """The entropy-coded data of the scan starting at `start`, split at its
    restart markers and unstuffed (FF00 -> FF). Returns (segments, position
    of the marker that ends the scan, or len(data))."""
    segs, seg_start, i, n = [], start, start, len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            segs.append(data[seg_start:n].replace(b"\xff\x00", b"\xff"))
            return segs, n
        m = data[j + 1]
        if m == 0x00:
            i = j + 2
        elif m == 0xFF:  # fill byte before a marker
            i = j + 1
        elif 0xD0 <= m <= 0xD7:
            segs.append(data[seg_start:j].replace(b"\xff\x00", b"\xff"))
            seg_start = i = j + 2
        else:
            segs.append(data[seg_start:j].replace(b"\xff\x00", b"\xff"))
            return segs, j


def _decode_segment(seg, n_mcu, mcu0, mcux, comps, preds, out):
    """Huffman-decode `n_mcu` MCUs from one restart segment into `out` (the
    kept component's coefficients, flat, natural order). `comps`: for each
    component of the scan, (index, DC lut, AC lut, h, v, blocks a row, keep)."""
    peek = _peek16(seg)
    nbits = 8 * len(seg)
    nat = _NATURAL
    pos = 0
    try:
        for m in range(mcu0, mcu0 + n_mcu):
            my, mx = divmod(m, mcux)
            for ci, dc, ac, h, v, bw, keep in comps:
                for by in range(v):
                    for bx in range(h):
                        e = dc[peek[pos]]
                        if not e:
                            raise ValueError("JPEG: bad Huffman code")
                        pos += e >> 8
                        s = e & 0xFF
                        if s:
                            x = peek[pos] >> (16 - s)
                            pos += s
                            if x < (1 << (s - 1)):
                                x -= (1 << s) - 1
                            preds[ci] += x
                        if keep:
                            base = ((my * v + by) * bw + mx * h + bx) * 64
                            out[base] = preds[ci]
                        k = 1
                        while k < 64:
                            e = ac[peek[pos]]
                            if not e:
                                raise ValueError("JPEG: bad Huffman code")
                            pos += e >> 8
                            rs = e & 0xFF
                            s = rs & 15
                            if s:
                                k += rs >> 4
                                x = peek[pos] >> (16 - s)
                                pos += s
                                if keep:
                                    if x < (1 << (s - 1)):
                                        x -= (1 << s) - 1
                                    out[base + nat[k]] = x
                                k += 1
                            elif rs == 0xF0:
                                k += 16
                            else:
                                break
    except IndexError:
        raise ValueError("JPEG: entropy-coded data ends inside a block") from None
    if pos > nbits:
        raise ValueError("JPEG: entropy-coded data ends inside a block")


def decode_gray(blob: bytes) -> np.ndarray:
    """A baseline JPEG -> (H, W) uint8: the image for one component, the Y
    (luma) plane for three."""
    data = bytes(blob)
    if data[:2] != b"\xff\xd8":
        raise ValueError("JPEG: no SOI marker")
    n = len(data)
    i = 2
    qt, dc_tabs, ac_tabs = {}, {}, {}
    frame = None
    restart = 0
    adobe_transform = None
    y_coef = None
    while True:
        while i < n and data[i] == 0xFF and i + 1 < n and data[i + 1] == 0xFF:
            i += 1  # fill bytes
        if i + 1 >= n:
            raise ValueError("JPEG: stream ends before EOI")
        if data[i] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {i}")
        m = data[i + 1]
        i += 2
        if m == 0xD9:  # EOI
            break
        if 0xD0 <= m <= 0xD8 or m == 0x01:
            continue  # stray RSTn / SOI / TEM: no payload
        if i + 2 > n:
            raise ValueError("JPEG: truncated marker segment")
        length = (data[i] << 8) | data[i + 1]
        seg = data[i + 2:i + length]
        if length < 2 or len(seg) != length - 2:
            raise ValueError("JPEG: truncated marker segment")
        i += length
        if m == 0xC0:  # baseline
            if frame is not None or len(seg) < 6:
                raise ValueError("JPEG: a second or short frame header")
            prec, height, width, nc = seg[0], (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
            if prec != 8:
                raise NotImplementedError(f"JPEG: {prec}-bit samples (8-bit only)")
            if nc not in (1, 3):
                raise NotImplementedError(f"JPEG: {nc} components (1 or 3 only)")
            if height == 0 or width == 0 or len(seg) != 6 + 3 * nc:
                raise ValueError("JPEG: bad frame header")
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4, seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                     for c in range(nc)]
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            if any(not (1 <= c[1] <= 4 and 1 <= c[2] <= 4) for c in comps):
                raise ValueError("JPEG: bad sampling factors")
            if comps[0][1] != hmax or comps[0][2] != vmax:
                raise NotImplementedError("JPEG: a luma plane sampled below the chroma")
            if nc == 3 and adobe_transform == 0:
                raise NotImplementedError("JPEG: an RGB (Adobe transform 0) frame")
            frame = (height, width, comps, hmax, vmax)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            y_bw = mcux * hmax
            y_coef = [0] * (y_bw * mcuy * vmax * 64)
        elif m in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            kind = {0xC1: "extended", 0xC2: "progressive", 0xC3: "lossless"}.get(
                m, "hierarchical" if m in (0xC5, 0xC6, 0xC7) else "arithmetic-coded")
            raise NotImplementedError(f"JPEG: {kind} frames (SOF{m - 0xC0})")
        elif m == 0xCC:
            raise NotImplementedError("JPEG: arithmetic coding (DAC)")
        elif m == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1:p + 17])
                total = sum(counts)
                symbols = list(seg[p + 17:p + 17 + total])
                if tc > 1 or th > 3 or len(counts) != 16 or len(symbols) != total:
                    raise ValueError("JPEG: bad Huffman table")
                (dc_tabs if tc == 0 else ac_tabs)[th] = _Huffman(counts, symbols)
                p += 17 + total
        elif m == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                size = 128 if pq else 64
                raw = seg[p + 1:p + 1 + size]
                if pq > 1 or tq > 3 or len(raw) != size:
                    raise ValueError("JPEG: bad quantization table")
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int64)
                table = np.zeros(64, np.int64)
                table[_NATURAL[:64]] = vals
                qt[tq] = table
                p += 1 + size
        elif m == 0xDD:  # DRI
            if len(seg) != 2:
                raise ValueError("JPEG: bad restart interval")
            restart = (seg[0] << 8) | seg[1]
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif m == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            height, width, fcomps, hmax, vmax = frame
            ns = seg[0] if seg else 0
            if ns < 1 or len(seg) != 4 + 2 * ns:
                raise ValueError("JPEG: bad scan header")
            ids = [c[0] for c in fcomps]
            scomps = []
            for s in range(ns):
                cid, tabs = seg[1 + 2 * s], seg[2 + 2 * s]
                if cid not in ids:
                    raise ValueError("JPEG: scan names an unknown component")
                ci = ids.index(cid)
                if (tabs >> 4) not in dc_tabs or (tabs & 15) not in ac_tabs:
                    raise ValueError("JPEG: scan uses an undefined Huffman table")
                scomps.append((ci, dc_tabs[tabs >> 4].lut, ac_tabs[tabs & 15].lut))
            segs, i = _segments(data, i)
            if not any(ci == 0 for ci, _, _ in scomps):
                continue  # a chroma-only scan: nothing of it is kept
            if ns == 1:  # non-interleaved: one block an MCU over the component's own grid
                ci = scomps[0][0]
                cw = -(-width * fcomps[ci][1] // hmax)
                ch = -(-height * fcomps[ci][2] // vmax)
                bw, bh = -(-cw // 8), -(-ch // 8)
                units = [(ci, scomps[0][1], scomps[0][2], 1, 1, y_bw, True)]
                mcux_s, total = bw, bw * bh
            else:
                units = [(ci, dc, ac, fcomps[ci][1], fcomps[ci][2],
                          y_bw if ci == 0 else 0, ci == 0) for ci, dc, ac in scomps]
                mcux_s, total = mcux, mcux * mcuy
            per = restart if restart else total
            need = -(-total // per)
            if len(segs) < need:
                raise ValueError("JPEG: truncated scan (restart intervals missing)")
            for k in range(need):
                preds = [0] * len(fcomps)  # the DC predictions restart
                _decode_segment(segs[k], min(per, total - k * per), k * per, mcux_s,
                                units, preds, y_coef)
            if i >= n:
                raise ValueError("JPEG: stream ends inside a scan")
        # APPn, COM and other segments carry nothing the decoder needs
    if frame is None or y_coef is None:
        raise ValueError("JPEG: no frame")
    height, width, fcomps, hmax, vmax = frame
    qtab = qt.get(fcomps[0][3])
    if qtab is None:
        raise ValueError("JPEG: undefined quantization table")
    coef = torch.from_numpy(np.array(y_coef, np.int64)).reshape(-1, 64)
    blocks = idct_islow(coef, torch.from_numpy(qtab))
    y_bh = coef.shape[0] // y_bw
    img = blocks.reshape(y_bh, y_bw, 8, 8).permute(0, 2, 1, 3).reshape(y_bh * 8, y_bw * 8)
    return img[:height, :width].numpy()
