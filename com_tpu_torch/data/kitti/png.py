"""A PNG reader and writer in zlib and numpy, for KITTI's ``image_2``
(``com_tpu`` reads those files with PIL, which the port does not need).

``read_png`` decodes 8-bit greyscale, grey + alpha, RGB and RGBA images,
non-interlaced, with any of the five row filters (None, Sub, Up, Average,
Paeth), as an (H, W) or (H, W, C) uint8 array; any other kind (16-bit
depth, a palette, Adam7 interlacing) raises ``NotImplementedError`` by
name.  ``write_png`` encodes an (H, W) or (H, W, 3 | 4) uint8 array, every
row filtered Up, for the seeded trees.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo each row's filter: raw (h * (1 + stride),) -> (h, stride) uint8.

    Rows filtered None or Up depend on the row above only: a pass a row.
    Sub, Average and Paeth also read the reconstructed pixel to the left,
    so an image holding any of them is reconstructed an anti-diagonal of
    pixels at a time (every pixel of one depends only on the two before)."""
    rows = raw.reshape(h, stride + 1)
    kinds = rows[:, 0].astype(np.int64)
    if ((kinds < 0) | (kinds > 4)).any():
        y = int(np.flatnonzero((kinds < 0) | (kinds > 4))[0])
        raise ValueError(f"PNG row {y}: unknown filter type {int(kinds[y])}")
    line = rows[:, 1:].astype(np.int64)
    if not np.isin(kinds, (1, 3, 4)).any():
        out = np.empty((h, stride), np.int64)
        prev = np.zeros(stride, np.int64)
        for y in range(h):
            prev = out[y] = (line[y] + prev) & 0xFF if kinds[y] == 2 else line[y]
        return out.astype(np.uint8)
    w = stride // bpp
    line = line.reshape(h, w, bpp)
    out = np.zeros((h + 1, w + 1, bpp), np.int64)  # a zero row above, a zero column left
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        left, up, ul = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        k = kinds[ys][:, None]
        pred = np.where(k == 1, left, np.where(k == 2, up, np.where(
            k == 3, (left + up) >> 1, np.where(k == 4, paeth, 0))))
        out[ys + 1, xs + 1] = (line[ys, xs] + pred) & 0xFF
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit, non-interlaced grey / grey-alpha / RGB / RGBA PNG as uint8
    (H, W) or (H, W, C)."""
    data = Path(path).read_bytes()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8:
        raise NotImplementedError(f"{path}: {depth}-bit PNG samples (only 8-bit is read)")
    if colour not in _CHANNELS:
        raise NotImplementedError(f"{path}: PNG colour type {colour} (a palette); only grey, "
                                  "grey + alpha, RGB and RGBA are read")
    if interlace:
        raise NotImplementedError(f"{path}: an interlaced (Adam7) PNG")
    c = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * c, c)
    return img.reshape(h, w) if c == 1 else img.reshape(h, w, c)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray) -> None:
    """Write uint8 (H, W) grey or (H, W, 3 | 4) RGB(A), every row filtered Up."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    c = 1 if img.ndim == 2 else img.shape[2]
    colour = {1: 0, 3: 2, 4: 6}[c]
    h, w = img.shape[:2]
    rows = img.reshape(h, w * c).astype(np.int16)
    body = rows.copy()
    body[1:] -= rows[:-1]
    lines = np.concatenate([np.full((h, 1), 2, np.int16), body & 0xFF], axis=1)
    Path(path).write_bytes(
        SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(lines.astype(np.uint8).tobytes()))
        + _chunk(b"IEND", b""))
