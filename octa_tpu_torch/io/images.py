"""Image and volume files without an imaging library.

The hosts the port runs on have no PIL: an 8-bit grayscale PNG is written
(and read back, for checks) with ``zlib`` and ``struct`` alone; volumes go
through ``numpy.save``. The JAX package writes the same files with
``PIL.Image.fromarray(img).save(path)``.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png_gray8(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write a uint8 [H, W] array as an 8-bit grayscale PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(
            f"save_png_gray8: expected uint8 [H, W], got {img.dtype} "
            f"{img.shape}")
    h, w = img.shape
    # every scanline: filter type 0 (none), then the row
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = img
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))


def load_png_gray8(path: str) -> np.ndarray:
    """Read back a PNG written by :func:`save_png_gray8` (8-bit grayscale,
    no interlace, filter type 0 on every line) as uint8 [H, W]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, colour, interlace) != (8, 0, 0):
                raise ValueError(f"{path}: not an 8-bit grayscale PNG")
            shape = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    if shape is None:
        raise ValueError(f"{path}: no IHDR chunk")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        shape[0], shape[1] + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered scanlines are not supported")
    return rows[:, 1:].copy()


def save_npy(path: str, array: np.ndarray) -> None:
    """``numpy.save`` into a directory that may not exist yet."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, array)
