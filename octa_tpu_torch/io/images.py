"""Image and volume files without an imaging library.

The hosts the port runs on have no PIL: an 8-bit grayscale PNG is written
(and read back, for checks) with ``zlib`` and ``struct`` alone; volumes go
through ``numpy.save``. The JAX package writes the same files with
``PIL.Image.fromarray(img).save(path)``.
"""
from __future__ import annotations

import functools
import os
import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    """The Paeth predictor of integer arrays: ``a`` left, ``b`` up, ``c``
    up-left."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(img: np.ndarray, kind: int) -> np.ndarray:
    """Scanlines of the uint8 [H, W] ``img`` under PNG filter ``kind`` (0
    none, 1 sub, 2 up, 3 average, 4 paeth), each led by its filter byte:
    uint8 [H, 1 + W]."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]                                    # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                                          # up
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]                                 # up-left
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[kind]
    rows = np.empty((x.shape[0], 1 + x.shape[1]), np.uint8)
    rows[:, 0] = kind
    rows[:, 1:] = (x - pred) & 0xFF
    return rows


def save_png_gray8(path: str, img: np.ndarray, level: int = 6,
                   filter_type: int = 0) -> None:
    """Write a uint8 [H, W] array as an 8-bit grayscale PNG, every scanline
    under PNG filter ``filter_type`` (0 none, 1 sub, 2 up, 3 average, 4
    paeth)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(
            f"save_png_gray8: expected uint8 [H, W], got {img.dtype} "
            f"{img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"save_png_gray8: no PNG filter {filter_type}")
    h, w = img.shape
    rows = _filter(img, filter_type)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples a pixel


def _unfilter_run(lines: np.ndarray, kinds: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo the average (3) and Paeth (4) filters of consecutive scanlines
    ``lines`` [n, W*bpp] (``kinds`` [n]) below the decoded row ``prior``.
    A byte needs the decoded byte ``bpp`` to its left, the one above and the
    one above-left, so the bytes of one anti-diagonal of the (row, pixel)
    grid are decoded together: n + W steps of numpy over a skewed copy
    (diagonal e of the grid is row e of the copy), not n * W * bpp steps of
    Python."""
    n = lines.shape[0]
    px = lines.shape[1] // bpp
    raw = lines.reshape(n, px, bpp).astype(np.int16)
    # the grid padded with the row above (i = 0) and a zero column (j = 0);
    # cell (i, j) sits at skewed[i + j, i]
    skewed = np.zeros((n + px + 1, n + 1, bpp), np.int16)
    skewed[np.arange(1, px + 1), 0] = prior.reshape(px, bpp)
    ii, jj = np.meshgrid(np.arange(1, n + 1), np.arange(1, px + 1),
                         indexing="ij")
    filtered = np.zeros_like(skewed)
    filtered[ii + jj, ii] = raw
    paeth = np.zeros(n + 1, bool)
    paeth[1:] = kinds == 4
    for e in range(2, n + px + 1):
        lo, hi = max(1, e - px), min(n, e - 1) + 1   # rows with 1 <= j <= px
        a = skewed[e - 1, lo:hi]                     # left
        b = skewed[e - 1, lo - 1:hi - 1]             # up
        c = skewed[e - 2, lo - 1:hi - 1]             # up-left
        pred = np.where(paeth[lo:hi, None], _paeth(a, b, c), (a + b) >> 1)
        skewed[e, lo:hi] = (filtered[e, lo:hi] + pred) & 0xFF
    return skewed[ii + jj, ii].reshape(n, px * bpp).astype(np.uint8)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters (0 none, 1 sub, 2 up, 3 average,
    4 paeth) of ``rows`` [H, 1 + W*bpp]; returns uint8 [H, W*bpp]."""
    h = rows.shape[0]
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"PNG: unknown filter type {int(kinds.max())}")
    out = np.zeros((h, rows.shape[1] - 1), np.uint8)
    prior = np.zeros(rows.shape[1] - 1, np.int64)
    y = 0
    while y < h:
        kind, line = kinds[y], rows[y, 1:].astype(np.int64)
        if kind in (3, 4):  # sequential along the line: the run of such rows
            end = y + 1
            while end < h and kinds[end] in (3, 4):
                end += 1
            out[y:end] = _unfilter_run(rows[y:end, 1:], kinds[y:end], prior, bpp)
            prior = out[end - 1].astype(np.int64)
            y = end
            continue
        if kind == 0:
            cur = line
        elif kind == 1:  # each byte adds the one bpp before it: cumsums
            cur = np.empty_like(line)
            for p in range(bpp):
                cur[p::bpp] = np.cumsum(line[p::bpp])
        else:
            cur = line + prior
        prior = cur & 0xFF
        out[y] = prior
        y += 1
    return out


def read_png_scanlines(path: str):
    """The filtered scanlines of a non-interlaced PNG (8- or 16-bit
    grayscale, grayscale with alpha, RGB or RGBA), each chunk's CRC checked
    and the IDAT stream inflated: ``(rows, (h, w, c), nbytes)`` with
    ``rows`` uint8 [H, 1 + W*C*nbytes], each led by its filter type."""
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
            if depth not in (8, 16) or colour not in _CHANNELS or interlace:
                raise ValueError(
                    f"{path}: only 8- or 16-bit non-interlaced grayscale, RGB "
                    f"or RGBA PNGs are read (bit depth {depth}, colour type "
                    f"{colour}, interlace {interlace})")
            shape = (h, w, _CHANNELS[colour])
            nbytes = depth // 8
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    if shape is None:
        raise ValueError(f"{path}: no IHDR chunk")
    h, w, c = shape
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * c * nbytes)
    return rows, shape, nbytes


def load_png(path: str, unfilter=None) -> np.ndarray:
    """Read a PNG that :func:`read_png_scanlines` reads as uint8 [H, W] or
    [H, W, C]. A 16-bit PNG keeps each sample's high byte, as libpng's
    ``png_set_strip_16`` (the JAX package's reader) does. ``unfilter(rows,
    bpp)`` undoes the scanline filters (by default :func:`_unfilter`, numpy;
    the native reader passes its C++ routine)."""
    rows, (h, w, c), nbytes = read_png_scanlines(path)
    img = (unfilter or _unfilter)(rows, c * nbytes).reshape(
        h, w, c, nbytes)[..., 0]
    return img[..., 0] if c == 1 else img


def drop_alpha(img: np.ndarray) -> np.ndarray:
    """Gray with alpha [H, W, 2] -> [H, W], RGBA [H, W, 4] -> [H, W, 3], as
    libpng's ``png_set_strip_alpha`` in the JAX package's reader; other
    arrays as they are."""
    if img.ndim == 3 and img.shape[2] == 2:
        return img[..., 0]
    if img.ndim == 3 and img.shape[2] == 4:
        return img[..., :3]
    return img


@functools.lru_cache(maxsize=32)
def _load_png_cached(path: str, mtime_ns: int, size: int) -> np.ndarray:
    img = load_png(path)
    img.flags.writeable = False
    return img


def load_png_cached(path: str) -> np.ndarray:
    """:func:`load_png` with the last 32 files decoded kept, read-only, by
    path, modification time and size: a training set reuses each of its
    few background images for many samples, and undoing the Paeth filter
    in numpy takes about 20 ms at 304² and 170 ms at 1216²."""
    st = os.stat(path)
    return _load_png_cached(path, st.st_mtime_ns, st.st_size)


def load_png_gray8(path: str) -> np.ndarray:
    """Read back an 8-bit grayscale PNG as uint8 [H, W]."""
    img = load_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: not an 8-bit grayscale PNG")
    return img


def save_npy(path: str, array: np.ndarray) -> None:
    """``numpy.save`` into a directory that may not exist yet."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, array)
