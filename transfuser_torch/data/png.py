"""PNG read and write with the standard library's zlib and numpy.

Stands in for the JAX reader's image decode (transfuser_tpu/data/dataset.py
``_imread_rgb`` / ``_imread_any``: libpng through ``native.png_read``, else
OpenCV), so the port needs no image library. ``read`` returns the file's
own channel order (RGB / RGBA), as the JAX reader returns after its
BGR->RGB conversion.

What it reads: 8- and 16-bit grayscale, RGB and RGBA, not interlaced,
with any of the five row filters. Anything else (palette, gray+alpha,
sub-byte depths, Adam7) raises ``ValueError``. zlib inflates the data;
the port's native library (``native.png_unfilter``) then undoes the row
filters. ``use_native=False`` undoes them here instead: None, Sub and Up
rows with whole-row numpy operations (Sub as a cumulative sum mod 256 per
byte lane), Average and Paeth byte by byte in Python, as they depend on
the pixel to their left as decoded. Writers with adaptive filtering
(libpng's default, which OpenCV uses) pick Average and Paeth for many
rows, and such files pay that loop on the numpy path.

``write`` stores filter None (type 0 on every row) at the given zlib
level.
"""
from __future__ import annotations

import struct
import zlib
import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples per pixel
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def decode(data: bytes, use_native: bool = True) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8 / uint16 array."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace \
            or compression or filtering:
        raise ValueError(f"unsupported PNG: colour type {color}, bit depth "
                         f"{depth}, interlace {interlace}")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    if use_native:
        from .. import native
        pix = native.png_unfilter(raw, bpp)
    else:
        pix = _unfilter(raw[:, 0], raw[:, 1:], bpp)
    if depth == 16:
        pix = pix.view(">u2").astype(np.uint16)
    return pix.reshape((h, w) if channels == 1 else (h, w, channels))


def _unfilter(kinds: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    if not kinds.any():
        return rows.copy()
    out = np.empty_like(rows)
    prev = np.zeros(rows.shape[1], np.uint8)
    for r, kind in enumerate(kinds.tolist()):
        line = rows[r]
        if kind == 0:
            out[r] = line
        elif kind == 1:
            out[r] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[r] = line + prev
        elif kind == 3:
            out[r] = _average(line, prev, bpp)
        elif kind == 4:
            out[r] = _paeth(line, prev, bpp)
        else:
            raise ValueError(f"PNG row {r}: unknown filter type {kind}")
        prev = out[r]
    return out


def _average(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(bpp):
        cur[i] = (cur[i] + (up[i] >> 1)) & 255
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + up[i]) >> 1)) & 255
    return np.frombuffer(cur, np.uint8)


def _paeth(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(bpp):                  # a = c = 0: the predictor is b
        cur[i] = (cur[i] + up[i]) & 255
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], up[i], up[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 255
    return np.frombuffer(cur, np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) or (H, W, C in 1/3/4) uint8 / uint16 -> PNG bytes, filter
    None on every row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG write takes uint8 or uint16, not {img.dtype}")
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or channels not in _COLOR_TYPE:
        raise ValueError(f"PNG write takes (H, W) or (H, W, 1/3/4), not "
                         f"{img.shape}")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))) \
        .view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[channels],
                         0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) +
            _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) +
            _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode(img, level))

