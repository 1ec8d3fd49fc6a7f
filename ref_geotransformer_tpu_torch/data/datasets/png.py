"""Greyscale PNG reader and writer in numpy and zlib.

The BOP tree stores depth maps as 16-bit and visibility masks as 8-bit
greyscale PNGs. `read_png` decodes exactly those: colour type 0, bit depth
8 or 16 (16-bit samples are big-endian), no interlacing, any of the five
scanline filters (None, Sub, Up, Average, Paeth) on any row, the image data
split over any number of IDAT chunks. Chunk CRCs are checked; ancillary
chunks are skipped. Any other PNG raises `PNGError` naming what it holds.

`write_png` writes the same two formats, with one filter type for every row
and the compressed stream cut into IDAT chunks of at most `idat_size` bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTERS = {0: "None", 1: "Sub", 2: "Up", 3: "Average", 4: "Paeth"}


class PNGError(ValueError):
    pass


def _chunks(blob: bytes):
    """(type, data) of each chunk after the signature, CRCs checked."""
    pos = len(SIGNATURE)
    while pos < len(blob):
        if pos + 8 > len(blob):
            raise PNGError("truncated chunk header")
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(blob):
            raise PNGError(f"truncated {kind!r} chunk")
        data = blob[pos + 8:end]
        (crc,) = struct.unpack(">I", blob[end:end + 4])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise PNGError(f"CRC mismatch in the {kind!r} chunk")
        yield kind, data
        pos = end + 4
        if kind == b"IEND":
            return
    raise PNGError("no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Filtered scanlines (height, 1 + stride) -> image bytes (height, stride)."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            row = line.copy()
        elif kind == 1:  # Sub: a running sum, modulo 256, over each byte lane
            lanes = line.reshape(-1, bpp).astype(np.int64)
            row = (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:
            row = line + prior  # uint8 arithmetic wraps modulo 256
        elif kind in (3, 4):  # Average and Paeth depend on the byte just decoded
            row = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[i - bpp] if i >= bpp else 0)
                row[i] = (row[i] + pred) & 0xFF
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise PNGError(f"unknown filter type {kind} on row {y}")
        out[y] = row
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """A greyscale PNG -> (H, W) uint8 (bit depth 8) or uint16 (bit depth 16)."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(SIGNATURE):
        raise PNGError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, data in _chunks(blob):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise PNGError(f"{path}: no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if colour != 0:
        raise PNGError(f"{path}: colour type {colour}; only greyscale (colour type 0) is read")
    if depth not in (8, 16):
        raise PNGError(f"{path}: bit depth {depth}; only 8 and 16 are read")
    if interlace != 0:
        raise PNGError(f"{path}: interlaced (Adam7); only non-interlaced images are read")
    if compression != 0 or filtering != 0:
        raise PNGError(f"{path}: compression method {compression}, filter method {filtering}; both must be 0")
    bpp = depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise PNGError(f"{path}: {raw.size} bytes of image data, expected {height * (stride + 1)}")
    image = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if depth == 8:
        return image
    return image.view(">u2").astype(np.uint16)


def _filter(image: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """Image bytes (H, stride) -> filtered scanlines (H, 1 + stride), one
    filter type on every row."""
    x = image.astype(np.int64)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    elif kind == 4:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        raise PNGError(f"unknown filter type {kind}")
    lines = ((x - pred) % 256).astype(np.uint8)
    return np.concatenate([np.full((x.shape[0], 1), kind, np.uint8), lines], axis=1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, image: np.ndarray, filter_type: int = 0, idat_size: int = 1 << 16) -> None:
    """(H, W) uint8 or uint16 -> an 8- or 16-bit greyscale PNG."""
    image = np.asarray(image)
    if image.ndim != 2 or image.dtype not in (np.uint8, np.uint16):
        raise PNGError(f"write_png takes a 2-D uint8 or uint16 array, got {image.dtype} {image.shape}")
    height, width = image.shape
    depth = 8 * image.dtype.itemsize
    data = image.astype(">u2").view(np.uint8) if depth == 16 else image
    stream = zlib.compress(_filter(data.reshape(height, -1), filter_type, depth // 8).tobytes(), 6)
    parts = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, 0, 0, 0, 0))]
    parts += [_chunk(b"IDAT", stream[i:i + idat_size]) for i in range(0, len(stream), idat_size)]
    parts.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(parts))
