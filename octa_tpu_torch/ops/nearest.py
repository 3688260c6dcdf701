"""K2 and K5: masked nearest-neighbour distances, full and banded — plain
PyTorch versions, CUDA kernels.

Counterpart of the TPU kernel ``octa_tpu/ops/pallas_nearest.py``
``masked_nearest_pallas`` (:110, body ``_nearest_kernel`` :46) and of its CPU
oracles ``octa_tpu/sim/greenhouse.py`` ``_chunked_nearest`` (:185) and
``_chunked_nearest2`` (:233).

For every row ``r``, mask ``m`` and query ``q`` the function returns the
distance to the nearest point that the mask admits, and that point's index
(the lowest one on ties). The squared distance is the exact difference form
``(qx-px)² + (qy-py)² + (qz-pz)²``, summed in that order with every product
and sum rounded on its own; the expanded ``|q|²+|p|²-2q·p`` is never used
(it cancels for close pairs and flips accept decisions near the eps/delta
thresholds of the growth loop). A query with no valid point gets **+inf and
index 0** on both paths, as ``_chunked_nearest`` returns; every consumer
only tests ``d <= bound`` or ``d > bound``.

:func:`masked_nearest` dispatches on the device of its inputs: CPU tensors go
to :func:`masked_nearest_plain`, CUDA tensors to the kernel in
``csrc/nearest.cu``, which is built at first use. There is no fallback from
one to the other. Kernel and plain version round at the same places, so they
agree bit for bit. :func:`nearest_plan` chooses how the kernel's point range
is split over several blocks where the grid would not fill the card (the
split launches share a scratch buffer per device and stream).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from octa_tpu_torch.ops._cuda import CudaKernel, multiprocessors

_VP, _I = ctypes.c_void_p, ctypes.c_int
NEAREST = CudaKernel(
    "nearest.cu", "nearest_launch",
    [_VP] * 8 + [_I] * 6 + [_VP])
# K2's threads per block, queries per thread and points per staged chunk:
# the kernel's constants
NEAREST_THREADS, NEAREST_QPT, NEAREST_CHUNK = 128, 4, 1024
NEAREST_BANDED = CudaKernel(
    "nearest_banded.cu", "nearest_banded_launch",
    [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP])
MAX_MASKS = 4
# K5's pruning tile (queries) and granule (points): the kernel's constants
BAND_TILE, BAND_CHUNK = 128, 1024
# elements of one [R, Q, chunk] intermediate of the plain version
_PLAIN_BUDGET = 1 << 26


def _check(query, points, masks):
    if (query.dim() != 3 or points.dim() != 3 or masks.dim() != 3
            or query.shape[-1] != 3 or points.shape[-1] != 3
            or points.shape[0] != query.shape[0]
            or masks.shape[0] != query.shape[0]
            or masks.shape[2] != points.shape[1]):
        raise ValueError(
            "masked_nearest: expected query [R,Q,3], points [R,N,3], masks "
            f"[R,M,N]; got {tuple(query.shape)}, {tuple(points.shape)}, "
            f"{tuple(masks.shape)}")
    if masks.dtype != torch.bool:
        raise ValueError(f"masked_nearest: masks must be bool, got {masks.dtype}")
    if query.shape[1] < 1 or points.shape[1] < 1 or masks.shape[1] < 1:
        raise ValueError("masked_nearest: Q, N and M must be at least 1")


def masked_nearest_plain(query, points, masks, *, want_idx: bool = True,
                         chunk: int | None = None):
    """Plain PyTorch K2: the chunked scan of ``_chunked_nearest2``, batched
    over rows, with ``[R, Q, chunk]`` intermediates only.

    query [R,Q,3] f32, points [R,N,3] f32, masks [R,M,N] bool. Returns
    ``d`` [R,M,Q] f32 (+inf where a mask admits no point) and, with
    ``want_idx``, ``idx`` [R,M,Q] int32 (0 there).
    """
    _check(query, points, masks)
    query, points = query.float(), points.float()
    r, qn, _ = query.shape
    n, m = points.shape[1], masks.shape[1]
    if chunk is None:
        chunk = max(16, min(2048, _PLAIN_BUDGET // max(r * qn, 1)))
    dev = query.device
    inf = torch.tensor(float("inf"), device=dev)
    best = torch.full((r, m, qn), float("inf"), device=dev)
    besti = torch.zeros((r, m, qn), dtype=torch.int64, device=dev)
    qx, qy, qz = (query[:, :, a, None] for a in range(3))        # [R,Q,1]
    for c0 in range(0, n, chunk):
        p = points[:, c0:c0 + chunk]
        dx = qx - p[:, None, :, 0]
        dy = qy - p[:, None, :, 1]
        dz = qz - p[:, None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz                          # [R,Q,C]
        for k in range(m):
            dm = torch.where(masks[:, k, None, c0:c0 + chunk], d2, inf)
            dmin, imin = torch.min(dm, dim=-1)  # first minimum of the chunk
            upd = dmin < best[:, k]             # strict: earlier chunk wins ties
            best[:, k] = torch.where(upd, dmin, best[:, k])
            if want_idx:
                besti[:, k] = torch.where(upd, imin + c0, besti[:, k])
    d = torch.sqrt(best.clamp(min=0.0))
    return (d, besti.to(torch.int32)) if want_idx else d


class NearestPlan(NamedTuple):
    """How K2's point range is split: ``splits`` ranges of ``per_split``
    points, one block each."""
    splits: int
    per_split: int

    def grid(self, r: int, qn: int) -> tuple:
        return (-(-qn // (NEAREST_THREADS * NEAREST_QPT)), r, self.splits)


def nearest_plan(r: int, qn: int, n: int, sms: int) -> NearestPlan:
    """K2's launch for [R, Q] queries over N points on a card of ``sms``
    SMs: a grid of fewer than 8 blocks an SM has its point range split over
    up to that many blocks, in whole chunks."""
    blocks = -(-qn // (NEAREST_THREADS * NEAREST_QPT)) * r
    splits = 1
    if blocks < 8 * sms:
        splits = min(-(-8 * sms // blocks), -(-n // NEAREST_CHUNK))
    per = -(-n // splits)
    per = -(-per // NEAREST_CHUNK) * NEAREST_CHUNK
    return NearestPlan(-(-n // per), per)


_SCRATCH: dict = {}  # (device, stream) -> (partial d2, partial idx, counters)


def _scratch(dev, stream: int, n_part: int, n_tiles: int):
    """Cached scratch of the split launches on one stream, grown on demand.
    The counters are zero between calls (the kernel's last block of a tile
    resets its own), and launches on one stream run one after another, so
    they may share them."""
    key = (dev, stream)
    part_d, part_i, counters = _SCRATCH.get(key, (None, None, None))
    if part_d is None or part_d.numel() < n_part:
        part_d = torch.empty(n_part, dtype=torch.float32, device=dev)
        part_i = torch.empty(n_part, dtype=torch.int32, device=dev)
    if counters is None or counters.numel() < n_tiles:
        counters = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    _SCRATCH[key] = (part_d, part_i, counters)
    return part_d, part_i, counters


def _nearest_cuda(query, points, masks, want_idx):
    dev = query.device
    if points.device != dev or masks.device != dev:
        raise ValueError("masked_nearest: inputs on different devices")
    query = query.float().contiguous()
    points = points.float().contiguous()
    masks = masks.contiguous()
    r, qn, _ = query.shape
    n, m = points.shape[1], masks.shape[1]
    if m > MAX_MASKS:
        raise ValueError(f"masked_nearest: at most {MAX_MASKS} masks, got {m}")
    if r > 65535:
        raise ValueError(f"masked_nearest: at most 65535 rows, got {r}")
    plan = nearest_plan(r, qn, n, multiprocessors(dev))
    d = torch.empty((r, m, qn), dtype=torch.float32, device=dev)
    idx = (torch.empty((r, m, qn), dtype=torch.int32, device=dev)
           if want_idx else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = NEAREST.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part_d = part_i = counters = None
        if plan.splits > 1:
            part_d, part_i, counters = _scratch(
                dev, stream, plan.splits * r * m * qn, r * plan.grid(r, qn)[0])
        err = fn(query.data_ptr(), points.data_ptr(), masks.data_ptr(),
                 d.data_ptr(), ptr(idx), ptr(part_d), ptr(part_i),
                 ptr(counters), r, qn, n, m, plan.splits, plan.per_split,
                 stream)
    if err != 0:
        # a launch cut short may leave a tile's counter set: start afresh
        _SCRATCH.pop((dev, stream), None)
        raise RuntimeError(f"nearest kernel launch failed: cudaError_t {err}")
    NEAREST.launches += 1
    return (d, idx) if want_idx else d


def masked_nearest(query, points, masks, *, want_idx: bool = True):
    """Masked nearest-neighbour distances (K2). Inputs and outputs as
    :func:`masked_nearest_plain`.

    CPU tensors run the plain version; CUDA tensors launch the hand-written
    kernel (built at first use), or raise. A query whose mask admits no
    point gets +inf and index 0 on both paths.
    """
    if query.device.type == "cpu":
        return masked_nearest_plain(query, points, masks, want_idx=want_idx)
    if query.device.type != "cuda":
        raise ValueError(f"masked_nearest: unsupported device {query.device}")
    _check(query, points, masks)
    return _nearest_cuda(query, points, masks, want_idx)


# ---------------------------------------------------------------------------
# K5: the banded variant
# ---------------------------------------------------------------------------

def _check_banded(query, points, masks, q_alive, band):
    _check(query, points, masks)
    r, qn = query.shape[:2]
    if masks.shape[1] != 1:
        raise ValueError("masked_nearest_banded: exactly one mask, got "
                         f"{masks.shape[1]}")
    if q_alive.shape != (r, qn) or q_alive.dtype != torch.bool:
        raise ValueError("masked_nearest_banded: q_alive must be bool [R,Q], "
                         f"got {q_alive.dtype} {tuple(q_alive.shape)}")
    if band.shape != (r,):
        raise ValueError("masked_nearest_banded: band must be [R], got "
                         f"{tuple(band.shape)}")


def _chunk_yranges(points, valid):
    """Per chunk of ``BAND_CHUNK`` points, the y-range of its valid points:
    ``(plo, phi)`` [R, n_chunks], +inf / -inf for a chunk with none."""
    r, n = valid.shape
    pad = -n % BAND_CHUNK
    py = torch.nn.functional.pad(points[:, :, 1], (0, pad))
    v = torch.nn.functional.pad(valid, (0, pad))
    py, v = py.reshape(r, -1, BAND_CHUNK), v.reshape(r, -1, BAND_CHUNK)
    inf = float("inf")
    return (torch.where(v, py, inf).amin(-1).contiguous(),
            torch.where(v, py, -inf).amax(-1).contiguous())


def banded_hits(query, points, masks, q_alive, band):
    """Which chunks each query tile scans: bool [R, n_tiles, n_chunks], by
    K5's rule (the tile's alive queries' ``y -/+ band`` against the chunk's
    valid points' y-range)."""
    query, points, band = query.float(), points.float(), band.float()
    r, qn = q_alive.shape
    qy = query[:, :, 1]
    inf = float("inf")
    pad = -qn % BAND_TILE
    ylo = torch.nn.functional.pad(
        torch.where(q_alive, qy - band[:, None], inf), (0, pad), value=inf)
    yhi = torch.nn.functional.pad(
        torch.where(q_alive, qy + band[:, None], -inf), (0, pad), value=-inf)
    lo = ylo.reshape(r, -1, BAND_TILE).amin(-1)                  # [R, nT]
    hi = yhi.reshape(r, -1, BAND_TILE).amax(-1)
    plo, phi = _chunk_yranges(points, masks[:, 0])
    return (phi[:, None, :] >= lo[:, :, None]) & (plo[:, None, :]
                                                  <= hi[:, :, None])


def masked_nearest_banded_plain(query, points, masks, q_alive, band, *,
                                want_idx: bool = True):
    """Plain PyTorch K5: K2's scan in chunks of ``BAND_CHUNK`` points, with
    every chunk that :func:`banded_hits` rules out for a query's tile masked
    out for that query.

    query [R,Q,3] f32, points [R,N,3] f32, masks [R,1,N] bool, q_alive [R,Q]
    bool (the queries whose results are consumed), band [R] f32. Returns
    ``d`` [R,1,Q] (+inf where nothing valid was scanned) and, with
    ``want_idx``, ``idx`` [R,1,Q] int32 (0 there).
    """
    _check_banded(query, points, masks, q_alive, band)
    query, points = query.float(), points.float()
    r, qn, _ = query.shape
    n = points.shape[1]
    dev = query.device
    hit = banded_hits(query, points, masks, q_alive, band)
    hit_q = hit.repeat_interleave(BAND_TILE, dim=1)[:, :qn]      # [R,Q,nC]
    valid = masks[:, 0]
    # a chunk is taken in slices so that [R, Q, slice] stays in the budget
    step = max(16, min(BAND_CHUNK, _PLAIN_BUDGET // max(r * qn, 1)))
    inf = torch.tensor(float("inf"), device=dev)
    best = torch.full((r, qn), float("inf"), device=dev)
    besti = torch.zeros((r, qn), dtype=torch.int64, device=dev)
    qx, qy, qz = (query[:, :, a, None] for a in range(3))        # [R,Q,1]
    for ci, c0 in enumerate(range(0, n, BAND_CHUNK)):
        for s0 in range(c0, min(c0 + BAND_CHUNK, n), step):
            s1 = min(s0 + step, c0 + BAND_CHUNK, n)
            p = points[:, s0:s1]
            dx = qx - p[:, None, :, 0]
            dy = qy - p[:, None, :, 1]
            dz = qz - p[:, None, :, 2]
            d2 = dx * dx + dy * dy + dz * dz                      # [R,Q,S]
            ok = valid[:, None, s0:s1] & hit_q[:, :, ci, None]
            dmin, imin = torch.min(torch.where(ok, d2, inf), dim=-1)
            upd = dmin < best                   # strict: earlier point wins
            best = torch.where(upd, dmin, best)
            if want_idx:
                besti = torch.where(upd, imin + s0, besti)
    d = torch.sqrt(best.clamp(min=0.0))[:, None]
    return (d, besti.to(torch.int32)[:, None]) if want_idx else d


def _banded_cuda(query, points, masks, q_alive, band, want_idx):
    dev = query.device
    if any(t.device != dev for t in (points, masks, q_alive, band)):
        raise ValueError("masked_nearest_banded: inputs on different devices")
    query = query.float().contiguous()
    points = points.float().contiguous()
    valid = masks[:, 0].contiguous()
    q_alive = q_alive.contiguous()
    band = band.float().contiguous()
    r, qn, _ = query.shape
    n = points.shape[1]
    if r > 65535:
        raise ValueError(f"masked_nearest_banded: at most 65535 rows, got {r}")
    plo, phi = _chunk_yranges(points, valid)
    d = torch.empty((r, 1, qn), dtype=torch.float32, device=dev)
    idx = (torch.empty((r, 1, qn), dtype=torch.int32, device=dev)
           if want_idx else None)
    fn = NEAREST_BANDED.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(query.data_ptr(), points.data_ptr(), valid.data_ptr(),
                 q_alive.data_ptr(), band.data_ptr(), plo.data_ptr(),
                 phi.data_ptr(), d.data_ptr(),
                 idx.data_ptr() if want_idx else None, r, qn, n, stream)
    if err != 0:
        raise RuntimeError(
            f"nearest_banded kernel launch failed: cudaError_t {err}")
    NEAREST_BANDED.launches += 1
    return (d, idx) if want_idx else d


def masked_nearest_banded(query, points, masks, q_alive, band, *,
                          want_idx: bool = True):
    """Banded masked nearest-neighbour distances (K5). Inputs and outputs as
    :func:`masked_nearest_banded_plain`.

    Contract: for every query marked in ``q_alive``, wherever the masked
    nearest distance is at most ``band[r]`` the result equals
    :func:`masked_nearest`'s, distance and index; beyond the band it may be
    any larger distance or +inf. Callers consume it only under ``d <= bound``
    with ``bound <= band[r]``. The pruning pays when ``points`` arrive sorted
    by y; unsorted points degrade to a full scan.

    CPU tensors run the plain version; CUDA tensors launch the hand-written
    kernel (built at first use), or raise.
    """
    if query.device.type == "cpu":
        return masked_nearest_banded_plain(query, points, masks, q_alive,
                                           band, want_idx=want_idx)
    if query.device.type != "cuda":
        raise ValueError(
            f"masked_nearest_banded: unsupported device {query.device}")
    _check_banded(query, points, masks, q_alive, band)
    return _banded_cuda(query, points, masks, q_alive, band, want_idx)
