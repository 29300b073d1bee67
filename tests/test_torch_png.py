"""The port's PNG codec (``lvislam_tpu_torch.utils.png``) against PIL: every
row filter, greyscale, greyscale + alpha, RGB and RGBA at odd sizes decode
to PIL's bytes (``convert("L")`` for grey), the writer round-trips, and the
formats it does not read raise with their cause."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from lvislam_tpu_torch.utils import png

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def frame(h, w, c, seed=0):
    """A smooth gradient with noise (so every filter type gets chosen by an
    adaptive writer), `c` channels."""
    rng = np.random.default_rng(seed)
    base = (np.add.outer(np.arange(h) * 3, np.arange(w) * 2)[..., None]
            + rng.integers(0, 40, (h, w, c)) + np.arange(c) * 50)
    return (base % 256).astype(np.uint8)


def pil_png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr[..., 0] if arr.shape[-1] == 1 else arr,
                    MODES[arr.shape[-1]]).save(buf, "PNG")
    return buf.getvalue()


def pil_gray(blob):
    return np.asarray(Image.open(io.BytesIO(blob)).convert("L"))


def filter_types(blob):
    raw = zlib.decompress(b"".join(body for kind, body in png._chunks(blob) if kind == b"IDAT"))
    w, h = struct.unpack(">II", blob[16:24])
    c = {0: 1, 2: 3, 4: 2, 6: 4}[blob[25]]
    return set(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)[:, 0].tolist())


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "adaptive"])
def test_each_filter_decodes_like_pil(channels, ftype):
    """Every row filter of the port's writer, each colour type, odd sizes:
    the decoded pixels are the written ones, and `decode_gray` equals
    PIL's ``convert("L")`` byte for byte (PIL reads the same file)."""
    arr = frame(37, 53, channels, seed=channels)
    blob = png.encode(arr, ftype)
    if ftype != "adaptive":
        assert filter_types(blob) == {ftype}
    np.testing.assert_array_equal(png.decode(blob), arr)
    np.testing.assert_array_equal(png.decode_gray(blob), pil_gray(blob))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob))),
                                  arr[..., 0] if channels == 1 else arr)


@pytest.mark.parametrize("channels, shape", [
    (c, s) for c in (1, 2, 3, 4) for s in ((1, 1), (3, 7), (61, 83))] + [(1, (480, 752))])
def test_pil_written_files_decode_like_pil(channels, shape):
    """Files written by PIL (its own filter choice a row) decode to PIL's
    grey bytes; one full EuRoC-size grey frame."""
    arr = frame(*shape, channels, seed=7)
    blob = pil_png(arr)
    np.testing.assert_array_equal(png.decode_gray(blob), pil_gray(blob))


@pytest.mark.parametrize("types", [
    [3, 4] * 20, [(0, 1, 2, 3, 4)[r % 5] for r in range(40)], [1] * 39 + [4]],
    ids=["avg-paeth", "all-five", "one-paeth"])
def test_mixed_row_filters_decode(types):
    """A frame whose rows mix the filter types (every row Average or Paeth,
    all five in turn, one Paeth row after Sub rows) decodes to the written
    pixels, and its grey to PIL's."""
    arr = frame(40, 61, 3, seed=3)
    blob = png.encode(arr, types)
    assert filter_types(blob) == set(types)
    np.testing.assert_array_equal(png.decode(blob), arr)
    np.testing.assert_array_equal(png.decode_gray(blob), pil_gray(blob))


def _with_header(blob, depth=None, ctype=None, interlace=None):
    ihdr = bytearray(blob[16:29])
    if depth is not None:
        ihdr[8] = depth
    if ctype is not None:
        ihdr[9] = ctype
    if interlace is not None:
        ihdr[12] = interlace
    body = bytes(ihdr)
    chunk = body + struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return blob[:16] + chunk + blob[33:]


def test_unsupported_formats_raise_with_their_cause():
    grey = png.encode(frame(8, 9, 1))
    with pytest.raises(NotImplementedError, match="interlaced"):
        png.decode_gray(_with_header(grey, interlace=1))
    buf = io.BytesIO()
    Image.fromarray(frame(8, 9, 1)[..., 0].astype(np.uint16) * 200).save(buf, "PNG")
    with pytest.raises(NotImplementedError, match="16-bit"):
        png.decode_gray(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(frame(8, 9, 3)).convert("P").save(buf, "PNG")
    with pytest.raises(NotImplementedError, match="palette"):
        png.decode_gray(buf.getvalue())
    with pytest.raises(NotImplementedError, match="1-bit"):
        png.decode_gray(_with_header(grey, depth=1))


def test_corrupt_files_raise_value_error():
    blob = png.encode(frame(8, 9, 1))
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"GIF89a" + blob[6:])
    with pytest.raises(ValueError, match="CRC"):
        png.decode(blob[:40] + bytes([blob[40] ^ 1]) + blob[41:])
    with pytest.raises(ValueError):
        png.decode(blob[:-20])
