"""The files a training cell reads, made from the seed in the run's scratch
directory: vessel graphs (links to the frozen fixture graphs, as many as
an epoch longer than the window needs), background crops, stand-ins for
real OCTA images and validation pairs, all 8-bit grayscale PNGs.
"""
from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

from octa_bench.adapt import DATA


def write_png(path, img: np.ndarray) -> None:
    """An 8-bit grayscale PNG, every scanline unfiltered."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[i].astype(np.uint8).tobytes()
                   for i in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1))
                + chunk(b"IEND", b""))


def smooth_noise(rng, n: int, res: int, cells: int = 16) -> np.ndarray:
    """[n, res, res] uint8: coarse uniform noise, bilinearly enlarged, plus
    fine noise; OCTA backgrounds and textures are of that kind."""
    coarse = rng.random((n, cells + 1, cells + 1))
    x = np.linspace(0, cells, res)
    i0 = np.minimum(x.astype(int), cells - 1)
    f = x - i0
    rows = coarse[:, i0] * (1 - f)[None, :, None] + coarse[:, i0 + 1] * f[None, :, None]
    img = rows[:, :, i0] * (1 - f) + rows[:, :, i0 + 1] * f
    img = 0.7 * img + 0.3 * rng.random((n, res, res))
    return (img * 255).astype(np.uint8)


def make(root: str, seed: int, spec: dict) -> dict[str, str]:
    """The data set under ``root`` as ``spec`` (the traffic's ``data``)
    asks: ``graphs`` links, ``backgrounds`` / ``images`` PNGs of ``res``²
    and as many label PNGs; returns the glob of each kind and the
    validation split's path."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    out = {}
    graphs = sorted(DATA.glob("graph_seed*.csv"))
    d = root / "vessel_graphs"
    d.mkdir(parents=True)
    for i in range(int(spec["graphs"])):
        os.symlink(graphs[i % len(graphs)], d / f"graph_{i:05d}.csv")
    out["vessel_graphs"] = str(d / "*.csv")
    res = int(spec["res"])
    for kind in ("background_images", "images", "labels"):
        d = root / kind
        d.mkdir()
        n = int(spec["backgrounds"] if kind == "background_images"
                else spec["images"])
        imgs = smooth_noise(rng, n, res)
        if kind == "labels":
            imgs = np.where(imgs > 140, 255, 0).astype(np.uint8)
        for i, img in enumerate(imgs):
            write_png(d / f"{i:05d}.png", img)
        out[kind] = str(d / "*.png")
    split = root / "val_0.txt"
    split.write_text("".join(f"{i}\n" for i in range(int(spec["images"]))))
    out["split"] = str(split)
    return out
