"""Host-side vessel-graph utilities for 2D rasterization.

Counterpart of the host half of ``octa_tpu/ops/raster.py``:
``parse_graph_csv`` (:48), ``forest_to_arrays`` (:74), ``edge_dropout``
(:99), ``pad_edges`` (:136), ``select_k_2d`` (:160) and ``_edges_to_px_2d``
(:436), plus the batch edge prep of ``bench.py`` ``_pad_batch_edges``
(:77-96). The splat itself is :mod:`octa_tpu_torch.ops.splat`.

All of it is numpy on the host, as in the reference; the CSV is parsed
here with numpy alone (the JAX package's native C++ parser is not used).
"""
from __future__ import annotations

import glob
import os
import random as _pyrandom
from typing import Sequence

import numpy as np

_DPI = 100.0
_PT_TO_PX = _DPI / 72.0
_RADIUS_FUDGE = 1.3  # reference: tree2img.py:82

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "assets", "vessel_graphs")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fixture_graph_paths() -> list[str]:
    """The vessel graphs grown by the JAX package and shipped with the port
    (``assets/vessel_graphs/graph_seed{0..3}.csv``)."""
    return sorted(glob.glob(os.path.join(FIXTURE_DIR, "*.csv")))


def parse_graph_csv(path: str) -> dict[str, np.ndarray]:
    """Parse a vessel-graph CSV (header ``node1,node2,radius``; nodes stored
    as ``[x y z]`` strings). Returns float64 ``{"node1": [E,3], "node2":
    [E,3], "radius": [E]}``."""
    with open(path, "r") as f:
        text = f.read()
    body = text.split("\n", 1)[1] if "\n" in text else ""
    body = body.replace("[", " ").replace("]", " ").replace(",", " ")
    vals = np.array(body.split(), dtype=np.float64)
    if vals.size % 7 != 0:
        raise ValueError(f"Malformed graph CSV {path}: {vals.size} values")
    vals = vals.reshape(-1, 7)
    return {"node1": vals[:, 0:3], "node2": vals[:, 3:6], "radius": vals[:, 6]}


def forest_to_arrays(forest: Sequence[dict]) -> dict[str, np.ndarray]:
    """Reference-style edge list (dicts with ``node1``, ``node2``,
    ``radius``; nodes as arrays, lists or legacy ``"[x y z]"`` strings) to
    float64 arrays."""
    n1, n2, rr = [], [], []
    for edge in forest:
        a, b = edge["node1"], edge["node2"]
        if isinstance(a, str):
            a = [float(c) for c in a[1:-1].split(" ") if c]
            b = [float(c) for c in b[1:-1].split(" ") if c]
        n1.append(tuple(a))
        n2.append(tuple(b))
        rr.append(float(edge["radius"]))
    if not n1:
        return {"node1": np.zeros((0, 3)), "node2": np.zeros((0, 3)),
                "radius": np.zeros((0,))}
    return {"node1": np.asarray(n1, dtype=np.float64),
            "node2": np.asarray(n2, dtype=np.float64),
            "radius": np.asarray(rr, dtype=np.float64)}


def edge_dropout(
    node1: np.ndarray,
    node2: np.ndarray,
    radius_keep: np.ndarray,
    max_dropout_prob: float = 0.0,
    blackdict: dict | None = None,
    rng: _pyrandom.Random | None = None,
) -> tuple[np.ndarray, dict]:
    """Hierarchical edge dropout (reference ``tree2img.py:60-84``).

    ``p = U(0,1)**10 * max_dropout_prob`` is drawn once per image; an edge is
    dropped if its proximal node is blacklisted (which cascades, since edges
    are stored parents first) or with probability ``p``, and a dropped edge
    blacklists its distal node. A ``blackdict`` passed in (the paired second
    render) means no new random drops. Edges outside the radius filter
    (``radius_keep`` false) are skipped entirely.
    """
    rng = rng or _pyrandom
    if blackdict is None:
        blackdict = {}
        p = rng.random() ** 10 * max_dropout_prob
    else:
        p = 0.0
    keep = np.zeros(len(radius_keep), dtype=bool)
    for i in range(len(radius_keep)):
        if not radius_keep[i]:
            continue
        if tuple(node2[i]) in blackdict or rng.random() < p:
            blackdict[tuple(node1[i])] = True
            continue
        keep[i] = True
    return keep, blackdict


def pad_edges(
    node1: np.ndarray,
    node2: np.ndarray,
    radius: np.ndarray,
    valid: np.ndarray | None = None,
    multiple: int = 512,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad edge arrays to a multiple of ``multiple`` (float32 / bool)."""
    e = len(radius)
    dim = node1.shape[1] if node1.ndim == 2 else 3
    if valid is None:
        valid = np.ones(e, dtype=bool)
    epad = max(multiple, _cdiv(max(e, 1), multiple) * multiple)
    out1 = np.zeros((epad, dim), np.float32)
    out2 = np.zeros((epad, dim), np.float32)
    outr = np.zeros((epad,), np.float32)
    outv = np.zeros((epad,), bool)
    out1[:e] = node1
    out2[:e] = node2
    outr[:e] = radius
    outv[:e] = valid
    return out1, out2, outr, outv


def select_k_2d(a, b, width_px, valid, shape, tile=128, cap=16384):
    """Largest per-tile edge count, rounded up to a power of two (at least
    64, at most ``cap``): a ``k_max`` under which no tile drops an edge."""
    h, w = shape
    reach = width_px * 0.5 + 1.0
    lo = np.minimum(a, b) - reach[:, None]
    hi = np.maximum(a, b) + reach[:, None]
    nty, ntx = _cdiv(h, tile), _cdiv(w, tile)
    counts = []
    for ti in range(nty):
        for tj in range(ntx):
            t_lo = np.array([ti * tile, tj * tile], np.float32)
            t_hi = t_lo + tile
            sep = np.any((hi < t_lo) | (lo > t_hi), axis=-1)
            counts.append(int((~sep & valid).sum()))
    k = max(64, max(counts))
    return min(cap, 1 << (k - 1).bit_length())


def edges_to_px_2d(arrays, image_resolution, mip_axis):
    """Map [0,1]^3 edge coordinates to 2D pixel (row, col) coordinates: the
    two non-MIP axes, row = coord[axes[0]] * ny, col = coord[axes[1]] * nx
    (the reference's matplotlib mapping, ``tree2img.py:46,85``)."""
    axes = [ax for ax in (0, 1, 2) if ax != mip_axis]
    nx, ny = image_resolution
    n1, n2 = arrays["node1"], arrays["node2"]
    a = np.stack([n1[:, axes[0]] * ny, n1[:, axes[1]] * nx], axis=-1)
    b = np.stack([n2[:, axes[0]] * ny, n2[:, axes[1]] * nx], axis=-1)
    return a, b


def pad_batch_edges(samples, res_in, res_lab, multiple=2048):
    """Unit-cube edges of each sample -> pixel coordinates at both
    resolutions, zero-padded to a common edge count (``bench.py:77-96``).

    Returns ``{"in": (a, b, w, v), "lab": (a, b, w, v)}`` with ``a, b``
    [N,E,2] float32, stroke width ``w = radius*1.3*res*100/72`` [N,E] float32
    and ``v`` [N,E] bool.
    """
    e_max = max(len(s["radius"]) for s in samples)
    e_pad = _cdiv(max(e_max, 1), multiple) * multiple
    n = len(samples)
    out = {}
    for res, tag in ((res_in, "in"), (res_lab, "lab")):
        a = np.zeros((n, e_pad, 2), np.float32)
        b = np.zeros((n, e_pad, 2), np.float32)
        w = np.zeros((n, e_pad), np.float32)
        v = np.zeros((n, e_pad), bool)
        for i, s in enumerate(samples):
            e = len(s["radius"])
            a[i, :e] = s["node1"][:, :2] * res
            b[i, :e] = s["node2"][:, :2] * res
            w[i, :e] = s["radius"] * _RADIUS_FUDGE * res * _PT_TO_PX
            v[i, :e] = True
        out[tag] = (a, b, w, v)
    return out
