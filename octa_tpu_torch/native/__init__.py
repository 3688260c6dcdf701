"""Native (C++) host readers, loaded through ctypes: the port's
counterpart of ``octa_tpu/native/``.

- ``graph_csv.cpp``: a one-pass parser of vessel-graph CSVs
  (:func:`parse_graph_csv_native`), which ``ops/raster.py::parse_graph_csv``
  tries first;
- ``edge_dropout.cpp``: hierarchical edge dropout's per-edge pass
  (:func:`edge_dropout_native`), which ``ops/raster.py::edge_dropout``
  tries first where an edge can drop;
- ``png_loader.cpp``: the PNG scanline un-filter, the loop of the numpy
  decoder (``io/images.py``) that numpy takes a diagonal at a time. The
  chunks are parsed and inflated by ``io/images.py::read_png_scanlines``
  (Python's zlib) on both paths, so the two give the same arrays on every
  file. :func:`read_png_native` reads one file,
  :func:`read_png_batch_native` a batch on a thread pool (zlib and the
  ctypes call release the GIL). ``data/transforms.py::LoadImaged`` tries
  it first for ``.png`` files. Unlike the JAX package's libpng decoder it
  needs no library headers, so it builds on any host with g++.

Each library is built with ``g++`` at its first use into ``build/native/``
at the root of the checkout, named by a hash of its source and flags (as
``ops/_cuda.py`` names the kernels), so that an edited source is rebuilt and
no library built elsewhere (the JAX package's, in its own directory) is ever
loaded. The build runs once a process under a lock, since the loader thread
and the main thread may both ask first. Where the library is unavailable
(no compiler, a failed build or load) each reader returns None, and so it
does for a file it refuses; the callers then take the numpy parser and
decoder, as the JAX package takes its Python ones. :data:`READS` counts
which path each read took.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from octa_tpu_torch.io import images

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
#: the compiler's name; a test sets it to a name that does not exist
COMPILER = "g++"
CXXFLAGS = ("-O3", "-shared", "-fPIC")

#: reads by path taken: ``csv_native``, ``csv_numpy``, ``png_native``,
#: ``png_numpy``
READS: collections.Counter = collections.Counter()
_lock = threading.Lock()


class NativeLib:
    """One C++ source, its library under ``build_dir`` and its ctypes
    bindings; ``status`` says whether it was loaded and, where not, why."""

    def __init__(self, source: str, libs: tuple, bind, build_dir=None):
        self.source = source
        self.libs = tuple(libs)
        self.bind = bind
        self.build_dir = Path(build_dir) if build_dir else None
        self.status = "not built"
        self._lib = None
        self._failed = False

    def library_path(self) -> Path:
        src = (SOURCE_DIR / self.source).read_bytes()
        flags = " ".join((*CXXFLAGS, *self.libs)).encode()
        digest = hashlib.sha256(src + flags).hexdigest()[:12]
        return (self.build_dir or BUILD_DIR) / \
            f"lib{Path(self.source).stem}_{digest}.so"

    def _build(self, out: Path) -> None:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [COMPILER, *CXXFLAGS, "-o", str(tmp),
               str(SOURCE_DIR / self.source), *self.libs]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            errors = [ln for ln in proc.stderr.splitlines() if "error" in ln]
            raise RuntimeError(errors[0].strip() if errors
                               else f"{COMPILER} exit {proc.returncode}")
        os.replace(tmp, out)  # a concurrent process never loads half a file

    def get(self):
        """The loaded library, built on first use; None where unavailable."""
        if self._lib is not None or self._failed:
            return self._lib
        with _lock:
            if self._lib is not None or self._failed:
                return self._lib
            out = self.library_path()
            try:
                if not out.exists():
                    self._build(out)
                    self.status = f"built {out.name}"
                else:
                    self.status = f"loaded {out.name}"
                lib = ctypes.CDLL(str(out))
                self.bind(lib)
                self._lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
                self._failed = True
                self.status = f"unavailable: {type(exc).__name__}: {exc}"
        return self._lib


def _bind_csv(lib) -> None:
    lib.parse_graph_csv.restype = ctypes.c_int64
    lib.parse_graph_csv.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int64]
    lib.count_graph_csv_rows.restype = ctypes.c_int64
    lib.count_graph_csv_rows.argtypes = [ctypes.c_char_p]


def _bind_png(lib) -> None:
    i64 = ctypes.c_int64
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [u8, i64, i64, i64, u8]


def _bind_dropout(lib) -> None:
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.edge_dropout.restype = ctypes.c_int64
    lib.edge_dropout.argtypes = [
        f64, f64, i64, ctypes.c_int64, f64, ctypes.c_double, f64,
        ctypes.c_int64, np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        i64, ctypes.POINTER(ctypes.c_int64)]


GRAPH_CSV = NativeLib("graph_csv.cpp", (), _bind_csv)
PNG_LOADER = NativeLib("png_loader.cpp", (), _bind_png)
EDGE_DROPOUT = NativeLib("edge_dropout.cpp", (), _bind_dropout)


def _unfilter(lib, rows: np.ndarray, bpp: int) -> np.ndarray:
    """``io/images.py::_unfilter`` in C++: uint8 [H, 1 + S] -> [H, S]."""
    h, s = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, s), np.uint8)
    if lib.png_unfilter(np.ascontiguousarray(rows), h, s, bpp, out) != 0:
        raise ValueError(f"PNG: unknown filter type {int(rows[:, 0].max())}")
    return out


def read_png_native(path: str):
    """Decode one PNG as ``io/images.py::load_png`` does, un-filtered in
    C++, alpha dropped (``drop_alpha``): uint8 [H, W] or [H, W, 3], as the
    JAX package's libpng reader gives it. Returns None if the library is
    unavailable or the file is not one ``load_png`` reads."""
    lib = PNG_LOADER.get()
    if lib is None:
        return None
    try:
        return images.drop_alpha(images.load_png(
            path, unfilter=functools.partial(_unfilter, lib)))
    except (OSError, ValueError, struct.error, zlib.error):
        return None


def read_png_batch_native(paths: list[str], threads: int | None = None):
    """:func:`read_png_native` over a batch on a thread pool: a list of
    arrays, or None if the library is unavailable or refuses any of the
    files."""
    if PNG_LOADER.get() is None or not paths:
        return None
    with ThreadPoolExecutor(threads or min(len(paths), os.cpu_count() or 4)) \
            as pool:
        out = list(pool.map(read_png_native, paths))
    return None if any(o is None for o in out) else out


def parse_graph_csv_native(path: str):
    """Parse a vessel-graph CSV with the C++ parser: float64 ``{"node1":
    [E, 3], "node2": [E, 3], "radius": [E]}``, or None if the parser is
    unavailable or refuses the file."""
    lib = GRAPH_CSV.get()
    if lib is None:
        return None
    cap = lib.count_graph_csv_rows(path.encode())
    if cap < 0:
        return None
    cap = max(int(cap), 1)
    out = np.empty((cap, 7), np.float64)
    n = lib.parse_graph_csv(path.encode(), out.reshape(-1), cap)
    if n < 0:
        return None
    vals = out[:n]
    return {"node1": vals[:, 0:3].copy(), "node2": vals[:, 3:6].copy(),
            "radius": vals[:, 6].copy()}


def edge_dropout_native(node1, node2, keep: np.ndarray, draws: np.ndarray,
                        p: float, black: np.ndarray):
    """The per-edge pass of ``ops/raster.py::edge_dropout`` in C++, over the
    edges ``keep`` (a bool [E] array, the radius filter) marks, with the
    blacklisted nodes ``black`` [M, 3] and ``draws`` (one a kept edge at
    most) in the order ``rng.random()`` gives them. Clears ``keep`` of the
    dropped edges; returns ``(draws taken, the dropped edges in order)``,
    or None where the library is unavailable or the nodes are not [E, 3]."""
    lib = EDGE_DROPOUT.get()
    n1 = np.ascontiguousarray(node1, dtype=np.float64)
    n2 = np.ascontiguousarray(node2, dtype=np.float64)
    if lib is None or n1.ndim != 2 or n1.shape[1:] != (3,) \
            or n2.shape != n1.shape or keep.shape != (len(n1),):
        return None
    kept = np.flatnonzero(keep).astype(np.int64)
    dropped = np.empty(len(kept), np.int64)
    n_dropped = ctypes.c_int64(0)
    taken = lib.edge_dropout(
        n1, n2, kept, len(kept), np.ascontiguousarray(draws, np.float64),
        float(p), np.ascontiguousarray(black, np.float64).reshape(-1, 3),
        len(black), keep.view(np.uint8), dropped, ctypes.byref(n_dropped))
    return int(taken), dropped[:n_dropped.value]
