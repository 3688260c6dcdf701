"""Vessel-graph utilities and the reference-compatible renderers.

Counterpart of ``octa_tpu/ops/raster.py``: the host half,
``parse_graph_csv`` (:48), ``forest_to_arrays`` (:74), ``edge_dropout``
(:99), ``pad_edges`` (:136), ``select_k_2d`` (:160), ``_select_k_3d_xy``
(:182), ``select_k_3d`` (:199) and ``_edges_to_px_2d`` (:436), the batch edge
prep of ``bench.py`` ``_pad_batch_edges`` (:77-96), and the two renderers
``rasterize_forest`` (:451) and ``voxelize_forest`` (:508). The splats
themselves are :mod:`octa_tpu_torch.ops.splat` (K1) and
:mod:`octa_tpu_torch.ops.splat3d` (K4).

The edge preparation is numpy on the host, as in the reference; the CSV is
parsed by the native C++ parser (``octa_tpu_torch/native``) where it
builds, else by numpy. The renderers move the prepared edges to ``device``
(the card unless the caller asks for ``"cpu"``) and splat there: CUDA
tensors go through the kernels, CPU tensors through their plain versions.
"""
from __future__ import annotations

import glob
import math
import os
import random as _pyrandom
from typing import Sequence

import numpy as np
import torch

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.ops.splat import splat_lines_2d
from octa_tpu_torch.ops.splat3d import splat_capsules_3d

_DPI = 100.0
_PT_TO_PX = _DPI / 72.0
_RADIUS_FUDGE = 1.3  # reference: tree2img.py:82
# the most edges a 128² bin of a rendered image keeps (select_k_2d's cap)
K_CAP_2D = 16384

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
    [E,3], "radius": [E]}``.

    The native C++ parser (``octa_tpu_torch/native/graph_csv.cpp``) reads
    the file where it is available; else numpy does, to the same arrays
    (both round each decimal to the nearest float64)."""
    from octa_tpu_torch import native

    arrays = native.parse_graph_csv_native(path)
    if arrays is not None:
        native.READS["csv_native"] += 1
        return arrays
    native.READS["csv_numpy"] += 1
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

    Where nothing can be dropped (``p == 0``, as whenever
    ``max_dropout_prob`` is 0, and an empty ``blackdict`` on entry) the kept
    edges are the radius filter's and the blacklist stays empty, with no
    per-edge loop; :func:`_skip_draws` still takes the one ``random()`` per
    radius-kept edge that the loop draws, so that ``rng`` ends in the loop's
    state. Any other case takes the per-edge pass, in order: a dropped
    edge's cascade depends on edge order. The pass runs in C++ with the
    interpreter lock released (``native.edge_dropout_native``), which the
    training step's launches share with the loader's thread: the draws are
    made beforehand from ``rng``'s state by numpy's Mersenne Twister, whose
    numbers are ``random.Random``'s, and ``rng`` is then advanced by the
    draws taken. Where the library, ``rng`` (not a ``random.Random``) or a
    blacklisted key (not three floats) does not allow that, Python's loop
    runs, over the radius-kept edges alone, making keys only once the
    blacklist has one (as Python floats, which hash and compare as the
    numpy scalars do). The blacklist's keys are Python floats either way.
    """
    rng = rng or _pyrandom
    if blackdict is None:
        blackdict = {}
        p = rng.random() ** 10 * max_dropout_prob
    else:
        p = 0.0
    keep = np.asarray(radius_keep, dtype=bool).copy()
    if p == 0 and not blackdict:
        _skip_draws(rng, int(keep.sum()))
        return keep, blackdict
    if _dropout_native(node1, node2, keep, p, blackdict, rng):
        return keep, blackdict

    def as_lists():
        return np.asarray(node1).tolist(), np.asarray(node2).tolist()

    draw = rng.random
    nodes = as_lists() if blackdict else None
    for i in np.flatnonzero(keep).tolist():
        if (nodes is not None and tuple(nodes[1][i]) in blackdict
                or draw() < p):
            nodes = nodes or as_lists()
            blackdict[tuple(nodes[0][i])] = True
            keep[i] = False
    return keep, blackdict


def _dropout_native(node1, node2, keep, p, blackdict, rng) -> bool:
    """:func:`edge_dropout`'s per-edge pass in C++: ``keep`` cleared of the
    dropped edges, their distal nodes added to ``blackdict`` in order and
    ``rng`` advanced by the draws taken; False (nothing changed) where it
    cannot run."""
    from octa_tpu_torch import native

    twister = _twister(rng)
    black = _blacklisted(blackdict)
    if twister is None or black is None:
        return False
    out = native.edge_dropout_native(node1, node2, keep,
                                     twister.random_sample(int(keep.sum())),
                                     p, black)
    if out is None:
        return False
    taken, dropped = out
    _advance(rng, taken)
    for row in np.asarray(node1)[dropped].tolist():
        blackdict[tuple(row)] = True
    return True


def _blacklisted(blackdict: dict):
    """The blacklist's keys as float64 [M, 3], or None where one is not a
    tuple of three floats."""
    keys = list(blackdict)
    if not all(type(k) is tuple and len(k) == 3
               and all(isinstance(v, float) for v in k) for k in keys):
        return None
    return np.asarray(keys, dtype=np.float64).reshape(-1, 3)


def _twister(rng):
    """numpy's Mersenne Twister in the state of ``rng`` (a ``random.Random``
    or the ``random`` module), whose ``random_sample`` gives the numbers
    ``rng.random()`` would; None for another generator."""
    inst = getattr(rng, "_inst", rng)
    if type(inst) is not _pyrandom.Random:
        return None
    state = inst.getstate()[1]
    twister = np.random.RandomState()
    twister.set_state(("MT19937", np.asarray(state[:-1], dtype=np.uint32),
                       state[-1]))
    return twister


def _advance(rng, n: int) -> bool:
    """``rng`` moved on by ``n`` numbers of ``rng.random()`` without drawing
    them in Python; False (unmoved) where it is not a ``random.Random``."""
    twister = _twister(rng)
    if twister is None:
        return False
    twister.random_sample(n)
    inst = getattr(rng, "_inst", rng)
    version, _, gauss = inst.getstate()
    key, pos = twister.get_state()[1:3]
    inst.setstate((version, (*key.tolist(), int(pos)), gauss))
    return True


def _skip_draws(rng, n: int) -> None:
    """Draw and drop ``n`` numbers of ``rng.random()``: the draws of the
    dropout loop, by :func:`_advance` where ``rng`` allows, else one by
    one."""
    if not _advance(rng, n):
        for _ in range(n):
            rng.random()


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


def select_k_2d(a, b, width_px, valid, shape, tile=128, cap=K_CAP_2D):
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


def _select_k_3d_xy(a, b, radius, valid, dims, tile_xy, cap=8192):
    """Largest per-(x, y)-tile edge count (z untiled), rounded up to a power
    of two (at least 64, at most ``cap``)."""
    off = np.asarray(radius) * math.sqrt(2.0)
    an, bn = np.asarray(a), np.asarray(b)
    lo = np.floor(np.minimum(an, bn)[:, :2] - off[:, None])
    hi = np.ceil(np.maximum(an, bn)[:, :2] + off[:, None] + 1.0) - 1.0
    ntx, nty = _cdiv(dims[0], tile_xy[0]), _cdiv(dims[1], tile_xy[1])
    tx = np.arange(ntx * nty) // nty
    tyv = np.arange(ntx * nty) % nty
    t_lo = np.stack([tx * tile_xy[0], tyv * tile_xy[1]], -1)[:, None, :]
    t_hi = t_lo + np.array(tile_xy) - 1.0
    sep = (hi[None] < t_lo) | (lo[None] > t_hi)          # [NT, E, 2]
    counts = ((~sep.any(-1)) & np.asarray(valid)[None]).sum(-1)
    k = max(64, int(counts.max(initial=64)))
    return min(cap, 1 << (k - 1).bit_length())


def select_k_3d(a, b, radius, valid, dims, tile=(64, 64, 16), cap=8192):
    """Largest per-tile edge count of a 3D tiling, rounded up to a power of
    two (at least 64, at most ``cap``). K4 has no per-tile limit and needs
    no ``k``; this is the count a tiled voxelizer would need."""
    off = radius * math.sqrt(2.0)
    lo = np.floor(np.minimum(a, b) - off[:, None])
    hi = np.ceil(np.maximum(a, b) + off[:, None] + 1.0) - 1.0
    nts = [_cdiv(d, t) for d, t in zip(dims, tile)]
    counts = [0]
    for ti in range(nts[0]):
        for tj in range(nts[1]):
            for tk in range(nts[2]):
                t_lo = np.array(
                    [ti * tile[0], tj * tile[1], tk * tile[2]], np.float32)
                t_hi = t_lo + np.array(tile, np.float32) - 1.0
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


# ---------------------------------------------------------------------------
# Reference-compatible renderers
# ---------------------------------------------------------------------------

def _kept_edges(forest, min_radius, max_radius, max_dropout_prob, blackdict,
                rng):
    arrays = forest if isinstance(forest, dict) else forest_to_arrays(forest)
    radius = arrays["radius"]
    rkeep = (radius >= min_radius) & (radius <= max_radius)
    keep, blackdict = edge_dropout(
        arrays["node1"], arrays["node2"], rkeep, max_dropout_prob, blackdict,
        rng)
    return arrays, keep, blackdict


def rasterize_forest_device(
    forest,
    image_resolution: Sequence[int],
    MIP_axis: int = 2,
    radius_list: list | None = None,
    min_radius: float = 0,
    max_radius: float = 1,
    max_dropout_prob: float = 0,
    blackdict: dict | None = None,
    rng: _pyrandom.Random | None = None,
    device="cuda",
):
    """:func:`rasterize_forest` with the image left on ``device``: returns
    (float32 tensor [ny, nx] with values in [0, 255], blackdict).

    Every 128² bin keeps up to ``K_CAP_2D`` edges. The reference sizes the
    splat's ``k_max`` with :func:`select_k_2d` (a loop over every bin on the
    host); that gives ``min(K_CAP_2D, a power of two >= the largest bin
    count)``, under which no bin drops an edge unless the cap does, so the
    cap itself gives the same image without the loop."""
    dev = resolve_device(device)
    arrays, keep, blackdict = _kept_edges(
        forest, min_radius, max_radius, max_dropout_prob, blackdict, rng)
    radius = arrays["radius"]
    if radius_list is not None:
        radius_list.extend((radius[keep] * _RADIUS_FUDGE).tolist())
    nx, ny = image_resolution
    img = splat_lines_2d(*(torch.from_numpy(x).to(dev) for x in splat_inputs_2d(
        arrays, keep, image_resolution, MIP_axis)),
        height=ny, width=nx, k_max=K_CAP_2D)
    return img * 255.0, blackdict


def splat_inputs_2d(arrays, keep, image_resolution: Sequence[int],
                    MIP_axis: int = 2):
    """K1's inputs for one rendered image: end points in pixel (row, col)
    coordinates, stroke widths ``radius*1.3*max(nx, ny)*100/72`` and the
    kept-edge mask, zero-padded by :func:`pad_edges`."""
    nx, ny = image_resolution
    a, b = edges_to_px_2d(arrays, image_resolution, MIP_axis)
    w_px = arrays["radius"] * _RADIUS_FUDGE * max(nx, ny) * _PT_TO_PX
    return pad_edges(a, b, w_px, keep)


def rasterize_forest(forest, image_resolution: Sequence[int],
                     MIP_axis: int = 2, **kwargs):
    """Drop-in equivalent of the reference ``rasterize_forest``
    (``tree2img.py:12-114``, grayscale path), through K1. Returns (float32
    numpy image [ny, nx] with values in [0, 255], blackdict). Keyword
    arguments as :func:`rasterize_forest_device`."""
    img, blackdict = rasterize_forest_device(
        forest, image_resolution, MIP_axis, **kwargs)
    return img.cpu().numpy().astype(np.float32), blackdict


def voxel_edges(arrays, keep, volume_dimensions: Sequence[int],
                ignore_z: bool = False):
    """Unit-cube edges -> K4's inputs: end points and radii in voxel
    coordinates of the padded volume, zero-padded to a multiple of 512, and
    the padded volume's dims. Every axis shorter than ``min_dim`` (a 76th of
    the longest axis plus twice the largest radius) is padded up to it, with
    the vessels centred; ``ignore_z`` puts every node on the middle slice."""
    MAX_RADIUS = 0.015
    scale_factor = max(volume_dimensions)
    min_dim = math.ceil((1 / 76) * scale_factor + 2 * MAX_RADIUS * scale_factor)
    image_dim = np.array([max(min_dim, d) for d in volume_dimensions])
    pos_correction = (image_dim - np.array(volume_dimensions)) / 2

    n1 = arrays["node1"] * scale_factor + pos_correction
    n2 = arrays["node2"] * scale_factor + pos_correction
    if ignore_z:
        n1 = n1.copy()
        n2 = n2.copy()
        n1[:, 2] = image_dim[2] // 2
        n2[:, 2] = image_dim[2] // 2
    r = arrays["radius"] * scale_factor
    return (*pad_edges(n1, n2, r, keep), tuple(int(d) for d in image_dim))


def voxelize_forest_device(
    forest,
    volume_dimensions: Sequence[int],
    radius_list: list | None = None,
    min_radius: float = 0,
    max_radius: float = 1,
    max_dropout_prob: float = 0,
    blackdict: dict | None = None,
    ignore_z: bool = False,
    rng: _pyrandom.Random | None = None,
    device="cuda",
):
    """:func:`voxelize_forest` with the volume left on ``device``: returns
    (uint8 tensor scaled to [0, 255], blackdict). K4 stores the uint8 levels
    ``(vol * 255.0).clamp(0, 255).to(torch.uint8)`` itself, so that no float
    volume is made and one byte per voxel, not four, crosses to the host."""
    dev = resolve_device(device)
    arrays, keep, blackdict = _kept_edges(
        forest, min_radius, max_radius, max_dropout_prob, blackdict, rng)
    radius = arrays["radius"]
    if radius_list is not None:
        radius_list.extend(radius[keep].tolist())

    a_p, b_p, r_p, v_p, dims = voxel_edges(arrays, keep, volume_dimensions,
                                           ignore_z)
    vol = splat_capsules_3d(*(torch.from_numpy(x).to(dev)
                              for x in (a_p, b_p, r_p, v_p)), dims=dims,
                            out_dtype=torch.uint8)
    # the padded volume is kept, as in the reference; callers that need the
    # original dims crop with pos_correction
    return vol, blackdict


def voxelize_forest(forest, volume_dimensions: Sequence[int], **kwargs):
    """Drop-in equivalent of the reference ``voxelize_forest``
    (``tree2img.py:176-280``), through K4. Returns (uint16 numpy volume
    scaled to [0, 255], blackdict). Keyword arguments as
    :func:`voxelize_forest_device`."""
    vol, blackdict = voxelize_forest_device(forest, volume_dimensions,
                                            **kwargs)
    return vol.cpu().numpy().astype(np.uint16), blackdict
