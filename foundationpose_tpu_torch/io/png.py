"""PNG reader and writer on the standard library's ``zlib`` and numpy.

The port's own module (the JAX package reads and writes images with cv2 and
PIL). It covers what BOP scenes, YCBInEOAT videos and the debug dumps use:

- 8-bit gray, RGB and RGBA;
- palette images and 1/2/4-bit gray (masks as PIL and cv2 write them);
- 16-bit gray (depth in millimetres, big-endian on disk).

Non-interlaced images only, all five row filters. Anything else (16-bit
colour, interlacing, a bad checksum) raises ``ValueError``.
The writer emits the same formats, every row with the "Up" filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> samples per pixel
_FORMATS = {(0, 1): 1, (0, 2): 1, (0, 4): 1, (0, 8): 1, (0, 16): 1, (2, 8): 3,
            (3, 1): 1, (3, 2): 1, (3, 4): 1, (3, 8): 1, (6, 8): 4}
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> colour type (writer)


def _chunks(data):
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError("PNG: truncated chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad checksum in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG: no IEND chunk")


def _unfilter_up_sub(ftype, filt, bpp):
    """Rows filtered with None, Sub or Up only: one vector step per row (Sub is
    a running sum, modulo 256, over the pixels of the row)."""
    H, stride = filt.shape
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(H):
        t = ftype[r]
        if t == 0:
            out[r] = filt[r]
        elif t == 1:
            out[r] = np.cumsum(filt[r].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            out[r] = filt[r] + prev  # uint8 wraps modulo 256
        prev = out[r]
    return out


def _unfilter_wavefront(ftype, filt, bpp):
    """Any mix of the five filters. A pixel depends on its left, upper and
    upper-left neighbours, so every anti-diagonal of pixels is independent:
    H + W - 1 vector steps, each over one pixel of every row it crosses."""
    H, stride = filt.shape
    W = stride // bpp
    f = filt.reshape(H, W, bpp).astype(np.int16)
    rec = np.zeros((H + 1, W + 1, bpp), np.int16)  # row 0 and column 0: the zero border
    kinds = ftype.astype(np.int16)
    for t in range(H + W - 1):
        rs = np.arange(max(0, t - W + 1), min(H, t + 1))
        xs = t - rs
        a = rec[rs + 1, xs]   # left
        b = rec[rs, xs + 1]   # up
        c = rec[rs, xs]       # upper left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = kinds[rs][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4], [a, b, (a + b) >> 1, paeth], 0)
        rec[rs + 1, xs + 1] = (f[rs, xs] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(H, stride)


def decode_png(data: bytes, expand_palette=True) -> np.ndarray:
    """PNG bytes -> array: (H,W) uint8 or uint16 gray, (H,W,3) RGB, (H,W,4)
    RGBA. A palette image gives its colours, (H,W,3) RGB, or with
    ``expand_palette=False`` its (H,W) uint8 indices."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    W, H, depth, ctype, compression, filter_method, interlace = header
    if (ctype, depth) not in _FORMATS or compression or filter_method or interlace:
        raise ValueError(f"PNG: unsupported format (colour type {ctype}, bit depth {depth}, "
                         f"interlace {interlace}); supported: 8-bit RGB / RGBA, 1-16-bit "
                         "gray, 1-8-bit palette, non-interlaced")
    if ctype == 3 and palette is None:
        raise ValueError("PNG: palette image without a PLTE chunk")
    channels = _FORMATS[(ctype, depth)]
    bpp = max(channels * depth // 8, 1)  # filter distance in bytes
    stride = (W * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"PNG: {raw.size} bytes of image data, expected {H * (stride + 1)}")
    rows = raw.reshape(H, stride + 1)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if H and ftype.max() > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    if H == 0 or ftype.max() <= 2:
        out = _unfilter_up_sub(ftype, filt, bpp)
    else:
        out = _unfilter_wavefront(ftype, filt, bpp)
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(H, W)
    if depth < 8:  # unpack the samples of each row, most significant bits first
        bits = np.unpackbits(out, axis=1).reshape(H, -1, depth)[:, :W]
        out = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        if ctype == 0:  # gray scaled to 8 bits, as libpng expands it
            out = out * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if expand_palette:
            if out.size and int(out.max()) >= len(palette):
                raise ValueError("PNG: palette index out of range")
            return palette[out]
        return out.reshape(H, W)
    return out.reshape(H, W) if channels == 1 else out.reshape(H, W, channels)


def read_png(path, expand_palette=True) -> np.ndarray:
    """Read a PNG file (see :func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), expand_palette=expand_palette)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img) -> bytes:
    """(H,W) uint8 or uint16, (H,W,3) or (H,W,4) uint8 -> PNG bytes."""
    a = np.asarray(img)
    channels = 1 if a.ndim == 2 else (a.shape[2] if a.ndim == 3 else 0)
    if a.dtype == np.uint16 and channels == 1:
        depth, rows = 16, np.ascontiguousarray(a.astype(">u2")).view(np.uint8)
    elif a.dtype == np.uint8 and channels in _COLOUR_TYPE:
        depth, rows = 8, np.ascontiguousarray(a)
    else:
        raise ValueError(f"PNG writer takes (H,W) uint8/uint16 or (H,W,3|4) uint8, "
                         f"got {a.shape} {a.dtype}")
    H, W = a.shape[:2]
    rows = rows.reshape(H, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]  # "Up" filter, modulo 256
    raw = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, _COLOUR_TYPE[channels], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path, img):
    """Write ``img`` (see :func:`encode_png`) to ``path``."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
