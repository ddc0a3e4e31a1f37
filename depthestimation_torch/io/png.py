"""PNG files on zlib and numpy, with no imaging package.

read_png decodes non-interlaced 8-bit gray, gray+alpha, RGB and RGBA
images and 1/2/4/8-bit gray and palette images, with all five row
filters; it raises ValueError for what it does not read (interlaced,
16-bit, a bad CRC, a broken stream). write_png writes 8-bit gray, gray +
alpha, RGB or RGBA with every row filtered with Up.

Rows filtered with None, Sub or Up decode in whole-array numpy steps:
Sub is a running sum along the row and Up a running sum down the rows,
both mod 256. Average and Paeth rows predict from the decoded pixel to
the left, so a row cannot be decoded in one step; an image that holds
any such row is decoded over anti-diagonals instead (pixel (r, x) needs
only (r, x-1), (r-1, x) and (r-1, x-1)), every pixel of a diagonal at
once.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

__all__ = ["read_png", "write_png", "is_png", "to_rgb", "SIGNATURE"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Color type -> (channels, bit depths read).
_COLOR_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8,)), 6: (4, (8,))}
_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


def is_png(path) -> bool:
    """True when the file at `path` starts with the PNG signature."""
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def _chunks(data: bytes):
    """(type, payload) of every chunk after the signature, CRC checked."""
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated chunk header")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"PNG: truncated {ctype!r} chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"PNG: bad CRC in the {ctype.decode('latin-1')} chunk")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG: no IEND chunk")


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_wavefront(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Decode (H, U, bpp) filtered bytes with any filter per row: every
    pixel of an anti-diagonal r + x = k at once, k = 0 .. H + U - 2."""
    h, u, bpp = filt.shape
    raw = np.zeros((h + 1, u + 1, bpp), np.int32)  # a zero row above, column left
    flat = raw.reshape(-1, bpp)
    f = filt.astype(np.int32).reshape(-1, bpp)
    for k in range(h + u - 1):
        r = np.arange(max(0, k - u + 1), min(h - 1, k) + 1)
        x = k - r
        here = (r + 1) * (u + 1) + x + 1
        a, b = flat[here - 1], flat[here - u - 1]
        c = flat[here - u - 2]
        t = ftype[r][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, c), 0))))
        flat[here] = (f[r * u + x] + pred) & 0xFF
    return raw[1:, 1:].astype(np.uint8)


def _unfilter(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Decode (H, U, bpp) filtered bytes, row filter types ftype (H,)."""
    if (ftype > 4).any():
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    if (ftype > 2).any():
        return _unfilter_wavefront(filt, ftype)
    # None and Up rows keep their bytes, Sub rows sum along the row; then
    # an Up row adds the decoded row above, so each run of Up rows is a
    # running sum down the rows from the last row that is not Up.
    base = filt.copy()
    sub = ftype == 1
    base[sub] = np.cumsum(filt[sub], axis=1, dtype=np.uint8)
    cum = np.cumsum(base, axis=0, dtype=np.uint8)
    before = np.concatenate([np.zeros_like(cum[:1]), cum[:-1]])
    rows = np.arange(len(ftype))
    start = np.maximum.accumulate(np.where(ftype != 2, rows, 0))
    return cum - before[start]


def read_png(source) -> Tuple[np.ndarray, dict]:
    """Decode a PNG file (a path, or its bytes).

    Returns (pixels, info): uint8 pixels (H, W) for gray, (H, W, 2) gray +
    alpha, (H, W, 3) RGB, (H, W, 4) RGBA, and for a palette image its
    indices (H, W); gray of 1, 2 or 4 bits is scaled to 0..255 as the PNG
    specification's sample scaling does. info holds "color_type",
    "bit_depth" and, for a palette image, "palette" (N, 3) uint8."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if color not in _COLOR_TYPES:
        raise ValueError(f"PNG: unknown color type {color}")
    channels, depths = _COLOR_TYPES[color]
    if depth == 16:
        raise ValueError(f"PNG: 16-bit {_NAMES[color]} images are not read")
    if depth not in depths:
        raise ValueError(f"PNG: bit depth {depth} is not valid for {_NAMES[color]}")
    if interlace != 0:
        raise ValueError("PNG: interlaced (Adam7) images are not read")
    if compression != 0 or filter_method != 0:
        raise ValueError("PNG: unknown compression or filter method")
    if color == 3 and palette is None:
        raise ValueError("PNG: palette image without a PLTE chunk")
    try:
        stream = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: broken image data ({e})") from None

    bits = channels * depth
    row_bytes = (width * bits + 7) // 8
    if len(stream) < height * (row_bytes + 1):
        raise ValueError("PNG: image data shorter than the image")
    rows = np.frombuffer(stream, np.uint8)[:height * (row_bytes + 1)].reshape(
        height, row_bytes + 1)
    bpp = max(bits // 8, 1)
    raw = _unfilter(rows[:, 1:].reshape(height, row_bytes // bpp, bpp), rows[:, 0].copy())
    raw = raw.reshape(height, row_bytes)
    if depth < 8:
        per_byte = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per_byte))).astype(np.uint8)
        samples = (raw[..., None] >> shifts) & ((1 << depth) - 1)
        pixels = samples.reshape(height, -1)[:, :width]
        if color == 0:
            pixels = pixels * np.uint8(255 // ((1 << depth) - 1))
    else:
        pixels = raw.reshape(height, width, channels)
        if channels == 1:
            pixels = pixels[..., 0]
    info = {"color_type": color, "bit_depth": depth}
    if color == 3:
        info["palette"] = palette
    return np.ascontiguousarray(pixels), info


def to_rgb(pixels: np.ndarray, info: dict) -> np.ndarray:
    """read_png's output as RGB uint8 (H, W, 3), as PIL's convert("RGB")
    gives it: alpha dropped, gray repeated, palette indices looked up
    (entries past the palette are black)."""
    if info["color_type"] == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(info["palette"])] = info["palette"][:256]
        return lut[pixels]
    if pixels.ndim == 2:
        return np.repeat(pixels[..., None], 3, axis=-1)
    if pixels.shape[-1] == 2:
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def write_png(path, pixels: np.ndarray) -> None:
    """Write uint8 pixels (H, W) gray, (H, W, 2) gray + alpha, (H, W, 3)
    RGB or (H, W, 4) RGBA as an 8-bit PNG, every row filtered with Up
    (filter 2), zlib at its default level."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f"write_png takes (H, W[, 1-4]) pixels, not {a.shape}")
    h, w, ch = a.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = a.reshape(h, w * ch)
    rows = rows - np.concatenate([np.zeros((1, w * ch), np.uint8), rows[:-1]])
    body = np.concatenate([np.full((h, 1), 2, np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(body.tobytes())))
        f.write(_chunk(b"IEND", b""))
