"""Port parity: the native host readers (``octa_tpu_torch/native``).

The C++ graph-CSV parser gives the fixture graphs exactly as the JAX
package's ``parse_graph_csv`` and the port's numpy parser do (float64, bit
for bit: each decimal rounds to its nearest double). The native PNG reader
(the scanline un-filter in C++) gives exactly the arrays of the port's
numpy decoder (``io/images.py``), of the JAX package's libpng reader and of
PIL (alpha dropped, 16-bit samples cut to their high byte, as libpng is
told to) for 8- and 16-bit gray, gray with alpha, RGB and RGBA files under
each of the five scanline filters, one file or a batch on the thread pool.
With the compiler's name monkeypatched away nothing is built, and the
loader and the CSV parser take the numpy path to the same arrays.
Libraries are built under ``build/native/`` with a hash of the source in
their names, once however many threads ask at once.
"""
import os
import struct
import threading
import zlib

import numpy as np
import pytest

from octa_tpu.ops import raster as jraster
from octa_tpu_torch import native
from octa_tpu_torch.data import transforms as tt
from octa_tpu_torch.io import images
from octa_tpu_torch.ops import raster


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _write_png(path, img, filter_type):
    """An 8- or 16-bit (``img``'s dtype) gray [H, W] or [H, W, C] PNG (C 2
    gray with alpha, 3 RGB, 4 RGBA) with every scanline under
    ``filter_type``, encoded here byte by byte."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    nbytes = img.dtype.itemsize
    bpp = c * nbytes
    rows = img.astype(f">u{nbytes}").view(np.uint8).reshape(h, w * bpp)
    rows = rows.astype(np.int64)
    out = bytearray()
    for y in range(h):
        line, prior = rows[y], rows[y - 1] if y else np.zeros_like(rows[0])
        out.append(filter_type)
        for x in range(w * bpp):
            a = int(line[x - bpp]) if x >= bpp else 0
            b = int(prior[x])
            cc = int(prior[x - bpp]) if x >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, cc))[filter_type]
            out.append((int(line[x]) - pred) & 0xFF)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8 * nbytes,
                                           colour, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(out))))
        f.write(chunk(b"IEND", b""))


def _as_read(img):
    """What the readers give for ``img``: the high byte of a 16-bit sample,
    alpha (channel 2 of 2, 4 of 4) dropped."""
    img = np.asarray(img)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] in (2, 4):
        img = img[..., 0] if img.shape[2] == 2 else img[..., :3]
    return img


@pytest.fixture
def pngs(tmp_path, rng):
    """Smooth and noisy gray, gray-with-alpha, RGB and RGBA images, 8- and
    16-bit, under each filter type: path -> the array the readers give."""
    yy, xx = np.mgrid[0:37, 0:29]
    smooth = (120 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)).astype(np.uint8)
    files = {}
    for ft in range(5):
        for name, img in (
                ("gray", rng.integers(0, 256, (37, 29), dtype=np.uint8)),
                ("smooth", smooth),
                ("gray_alpha", rng.integers(0, 256, (19, 27, 2),
                                            dtype=np.uint8)),
                ("rgb", rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)),
                ("rgba", rng.integers(0, 256, (21, 17, 4), dtype=np.uint8)),
                ("gray16", rng.integers(0, 1 << 16, (13, 11),
                                        dtype=np.uint16)),
                ("rgba16", rng.integers(0, 1 << 16, (9, 7, 4),
                                        dtype=np.uint16))):
            path = str(tmp_path / f"{name}_f{ft}.png")
            _write_png(path, img, ft)
            files[path] = _as_read(img)
    return files


def test_csv_parsers_match_the_jax_package():
    paths = raster.fixture_graph_paths()
    assert len(paths) == 4
    for path in paths:
        ours = native.parse_graph_csv_native(path)
        ref = jraster.parse_graph_csv(path)
        before = dict(native.READS)
        via = raster.parse_graph_csv(path)
        assert native.READS["csv_native"] == before.get("csv_native", 0) + 1
        for k in ("node1", "node2", "radius"):
            assert ours[k].dtype == np.float64 and len(ours[k]) > 1000
            np.testing.assert_array_equal(ours[k], np.asarray(ref[k]))
            np.testing.assert_array_equal(via[k], ours[k])
    assert native.GRAPH_CSV.library_path().parent == native.BUILD_DIR


def test_png_decoder_matches_numpy_and_pil(pngs):
    from PIL import Image

    from octa_tpu.native import read_png_native as jax_read_png

    for path, img in pngs.items():
        ours = native.read_png_native(path)
        assert ours is not None, path
        np.testing.assert_array_equal(ours, img, err_msg=path)
        np.testing.assert_array_equal(images.drop_alpha(images.load_png(path)),
                                      ours, err_msg=path)
        pil = np.asarray(Image.open(path))
        if "16" not in path:  # PIL keeps 16-bit gray whole, drops RGBA's low bytes
            np.testing.assert_array_equal(_as_read(pil), ours, err_msg=path)
        ref = jax_read_png(path)  # libpng, where its headers are installed
        if ref is not None:
            np.testing.assert_array_equal(ref, ours, err_msg=path)
    batch = native.read_png_batch_native(list(pngs), threads=4)
    assert len(batch) == len(pngs)
    for got, img in zip(batch, pngs.values()):
        np.testing.assert_array_equal(got, img)


def test_png_written_by_pil_and_refused_files(tmp_path, rng):
    """PIL's own adaptive filtering, and files the decoder refuses (not a
    PNG; missing), which the numpy path then handles or reports."""
    from PIL import Image

    for mode, shape in (("L", (40, 33)), ("RGB", (40, 33, 3))):
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / f"pil_{mode}.png")
        Image.fromarray(arr, mode).save(path)
        np.testing.assert_array_equal(native.read_png_native(path), arr)
        np.testing.assert_array_equal(images.load_png(path), arr)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    assert native.read_png_native(str(bad)) is None
    assert native.read_png_native(str(tmp_path / "missing.png")) is None
    assert native.read_png_batch_native([str(bad)]) is None
    with pytest.raises(ValueError):
        images.load_png(str(bad))


def test_loader_takes_the_native_decoder_first(pngs):
    before = native.READS["png_native"]
    load = tt.LoadImaged(keys=["image"])
    for path, img in pngs.items():
        out = load({"image": path})["image"]
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, img.astype(np.float32))
    assert native.READS["png_native"] == before + len(pngs)


def test_without_a_compiler_the_numpy_path_gives_the_same(tmp_path, pngs,
                                                          monkeypatch):
    monkeypatch.setattr(native, "COMPILER", "no-such-compiler-here")
    for name in ("GRAPH_CSV", "PNG_LOADER"):
        lib = getattr(native, name)
        monkeypatch.setattr(native, name, native.NativeLib(
            lib.source, lib.libs, lib.bind, build_dir=tmp_path / "build"))
    path = raster.fixture_graph_paths()[1]
    assert native.parse_graph_csv_native(path) is None
    assert native.GRAPH_CSV.status.startswith("unavailable")
    before = dict(native.READS)
    got = raster.parse_graph_csv(path)
    ref = jraster.parse_graph_csv(path)
    for k in ("node1", "node2", "radius"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    load = tt.LoadImaged(keys=["image"])
    for p, img in pngs.items():
        assert native.read_png_native(p) is None
        np.testing.assert_array_equal(load({"image": p})["image"],
                                      img.astype(np.float32))
    assert native.READS["csv_numpy"] == before.get("csv_numpy", 0) + 1
    assert native.READS["png_numpy"] == before.get("png_numpy", 0) + len(pngs)
    assert native.READS["png_native"] == before.get("png_native", 0)
    assert not (tmp_path / "build").exists() or not os.listdir(
        tmp_path / "build")


def test_one_build_however_many_threads_ask(tmp_path):
    lib = native.NativeLib("graph_csv.cpp", (), native._bind_csv,
                           build_dir=tmp_path)
    out = lib.library_path()
    assert out.parent == tmp_path and out.name.startswith("libgraph_csv_")
    assert len(out.stem.rsplit("_", 1)[1]) == 12  # the source's hash
    got = []
    threads = [threading.Thread(target=lambda: got.append(lib.get()))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 6 and all(g is got[0] for g in got) and got[0] is not None
    assert lib.status.startswith("built")
    assert sorted(os.listdir(tmp_path)) == [out.name]
    again = native.NativeLib("graph_csv.cpp", (), native._bind_csv,
                             build_dir=tmp_path)
    assert again.get() is not None and again.status.startswith("loaded")
