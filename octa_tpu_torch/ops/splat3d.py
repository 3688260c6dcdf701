"""K4: 3D capsule voxelizer — plain PyTorch version, CUDA kernels.

Counterpart of ``octa_tpu/ops/raster.py`` ``splat_capsules_3d`` (:334), the
oracle, and of the TPU kernel ``octa_tpu/ops/pallas_splat.py``
``splat_capsules_3d_pallas`` (:284, body ``_splat3d_tile_kernel`` :222).

For every voxel ``v`` (centre ``v + 0.5``) the volume holds
``clip(max over edges of contrib, 0, 1)`` with ``contrib = 1 - (d - (r -
sqrt3/2)) / sqrt3``: ``d`` is the distance to the nearer end point, and where
the projection parameter lies strictly inside ``0 < t < 1`` the smaller of
that and the orthogonal distance. An edge counts only for voxels whose
*index* lies in its bbox ``[floor(min(a, b) - r sqrt2), ceil(max(a, b) + r
sqrt2 + 1))`` on all three axes; invalid edges count nowhere. With
``out_dtype=torch.uint8`` the volume is stored as the renderers store it,
``(vol * 255.0).clamp(0, 255).to(torch.uint8)``.

Both versions here have no per-tile edge limit: every valid edge counts. The
oracle and the TPU kernel gather per tile and drop a tile's edges beyond
``k_max`` (each by its own order); ``voxelize_forest`` picks ``k_max`` so
that no tile overflows, and there all agree.

Both take the orthogonal distance as ``|(c - a) - t (b - a)|`` with ``t =
((c - a) . s) * (1 / max(|s|², 1e-12))``, as the TPU kernel does; the oracle
writes ``|c - (a + t s)|`` with a division, whose intermediate near coordinate
1000 rounds by 1.2e-4. Both take one square root and one division a pair:
``f(sqrt(min(d_a², d_b², inside ? d_orth² : inf)))``, which is bit for bit
the oracle's ``max`` of the three terms' ``f(sqrt(.))`` (``sqrt`` is
correctly rounded and monotone, ``f`` rounded step by step is monotone).
Kernel and plain version round every operation at the same place (the plain
version divides by a sqrt3 held in a tensor: by a Python scalar PyTorch
multiplies with the reciprocal on the card, one rounding apart), so on one
device they agree bit for bit.

:func:`splat_capsules_3d` dispatches on the device of its inputs: CPU tensors
go to :func:`splat_capsules_3d_plain`, CUDA tensors to the kernels in
``csrc/splat3d.cu``, which are built at first use: one host call launches a
binning kernel and a gather kernel that stores each voxel once, with no
sort and no host sync. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from octa_tpu_torch.ops._cuda import CudaKernel, on_device, scratch, stream_handle

_VP, _I = ctypes.c_void_p, ctypes.c_int
SPLAT3D = CudaKernel("splat3d.cu", "splat3d_launch", [_VP] * 7 + [_I] * 6 + [_VP])
_SQRT2 = math.sqrt(2.0)
_DIAG = math.sqrt(3.0)
# (voxel, edge) pairs of one chunk of the plain version
_PLAIN_PAIRS = 1 << 22
_OUT_DTYPES = (torch.float32, torch.uint8)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bin_tile(x: int, y: int) -> int:
    """Columns a side of one bin of the binning kernel: about ten bins a
    side, a multiple of 16 (the gather's sub-tiles), from 16 to 128."""
    return 16 * min(8, max(1, round(max(x, y) / 160)))


def _check(a, b, radius, valid, dims, out_dtype):
    if (a.dim() != 2 or a.shape[-1] != 3 or b.shape != a.shape
            or radius.shape != a.shape[:1] or valid.shape != a.shape[:1]):
        raise ValueError(
            "splat_capsules_3d: expected a, b [E,3] and radius, valid [E]; got "
            f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(radius.shape)}, "
            f"{tuple(valid.shape)}")
    if len(dims) != 3 or min(dims) < 1 or dims[0] * dims[1] * dims[2] >= 2 ** 31:
        raise ValueError(f"splat_capsules_3d: bad dims {tuple(dims)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"splat_capsules_3d: out_dtype {out_dtype} is not "
                         "torch.float32 or torch.uint8")
    return a.float(), b.float(), radius.float(), valid.bool()


def edge_bboxes(a, b, radius, dims):
    """Each edge's voxel-index bbox clipped to the volume: ``(lo, n)`` int64
    [E, 3], first index and extent (0 where the bbox misses the volume)."""
    off = (radius * _SQRT2)[:, None]
    lim = torch.tensor(dims, dtype=torch.float32, device=a.device)
    zero = torch.zeros_like(lim)
    lo = torch.floor(torch.minimum(a, b) - off).clamp(zero, lim).long()
    hi = torch.ceil(torch.maximum(a, b) + off + 1.0).clamp(zero, lim).long()
    n = (hi - lo).clamp(min=0)
    return lo, torch.where((n > 0).all(-1, keepdim=True), n, 0)


def quantise(vol):
    """The renderers' uint8 levels of a float volume in [0, 1]."""
    return (vol * 255.0).clamp(0, 255).to(torch.uint8)


def capsule_contrib(c, a, b, seg, invd, base, diag):
    """Contribution of edges to voxel centres, pair by pair: ``c``, ``a``,
    ``b``, ``seg = b - a`` [P, 3], ``invd = 1 / max(|seg|², 1e-12)`` and
    ``base = r - sqrt3/2`` [P], ``diag`` sqrt3 as a tensor. One root and one
    division: ``1 - (sqrt(min(d_a², d_b², inside ? d_orth² : inf)) - base) /
    diag``, not yet clipped."""
    d = c - a
    tpar = (d[:, 0] * seg[:, 0] + d[:, 1] * seg[:, 1]
            + d[:, 2] * seg[:, 2]) * invd
    p = d - tpar[:, None] * seg
    e = c - b
    sq = lambda v: v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
    inside = (tpar > 0.0) & (tpar < 1.0)
    q = torch.minimum(sq(d), sq(e))
    q = torch.where(inside, torch.minimum(q, sq(p)), q)
    return 1.0 - (torch.sqrt(q) - base) / diag


def splat_capsules_3d_plain(a, b, radius, valid, *, dims,
                            out_dtype=torch.float32,
                            pairs: int = _PLAIN_PAIRS):
    """Plain PyTorch K4: chunks of edges, each chunk's (voxel, edge) pairs
    laid out flat (at most about ``pairs`` of them at a time, so that memory
    stays bounded at any volume size), reduced to one maximum per voxel and
    merged into a volume that starts at 0. The chunks are planned on the
    host, so a call on a CUDA tensor reads the pair counts back (a host
    sync); the kernel needs none.

    a, b: [E, 3] end points in voxel coordinates; radius: [E] voxels; valid:
    [E] bool. Returns the [X, Y, Z] volume: float32 in [0, 1], or with
    ``out_dtype=torch.uint8`` that volume quantised by :func:`quantise`.
    """
    a, b, radius, valid = _check(a, b, radius, valid, dims, out_dtype)
    dev = a.device
    x, y, z = (int(d) for d in dims)
    vol = torch.zeros(x * y * z, device=dev)
    lo, n = edge_bboxes(a, b, radius, dims)
    cnt = n.prod(-1) * valid
    live = torch.nonzero(cnt > 0)[:, 0]
    # chunk boundaries on the host: each chunk's pairs stay near the budget
    cum = np.cumsum(cnt[live].cpu().numpy())
    cuts = [0]
    while cuts[-1] < len(cum):
        done = cum[cuts[-1] - 1] if cuts[-1] else 0
        nxt = int(np.searchsorted(cum, done + pairs, side="right"))
        cuts.append(max(nxt, cuts[-1] + 1))
    seg = b - a
    invd = 1.0 / (seg[:, 0] * seg[:, 0] + seg[:, 1] * seg[:, 1]
                  + seg[:, 2] * seg[:, 2]).clamp(min=1e-12)
    base = radius - _DIAG / 2
    # a tensor on the device, so that the division is a division: by a
    # Python scalar PyTorch multiplies with the reciprocal on the card
    diag = torch.full((), _DIAG, device=dev)
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        e = live[c0:c1]
        c = cnt[e]
        total = int(cum[c1 - 1] - (cum[c0 - 1] if c0 else 0))
        g = torch.repeat_interleave(e, c, output_size=total)   # edge per pair
        first = torch.repeat_interleave(torch.cumsum(c, 0) - c, c,
                                        output_size=total)
        j = torch.arange(total, device=dev) - first
        ng, log = n[g], lo[g]
        vz = log[:, 2] + j % ng[:, 2]
        j = j // ng[:, 2]
        vy = log[:, 1] + j % ng[:, 1]
        vx = log[:, 0] + j // ng[:, 1]
        centre = torch.stack([vx, vy, vz], -1).float() + 0.5
        contrib = capsule_contrib(centre, a[g], b[g], seg[g], invd[g],
                                  base[g], diag)
        # the maximum per voxel: sort the pairs by voxel and reduce each run
        # (a scatter with repeated indices is not safe on every backend)
        lin, order = torch.sort((vx * y + vy) * z + vz)
        vox, runs = torch.unique_consecutive(lin, return_counts=True)
        top = torch.segment_reduce(contrib[order], "max", lengths=runs)
        vol[vox] = torch.maximum(vol[vox], top.clamp(max=1.0))
    vol = vol.reshape(x, y, z)
    return quantise(vol) if out_dtype == torch.uint8 else vol


def _splat3d_cuda(a, b, radius, valid, dims, out_dtype):
    dev = a.device
    if any(t.device != dev for t in (b, radius, valid)):
        raise ValueError("splat_capsules_3d: inputs on different devices")
    x, y, z = (int(d) for d in dims)
    if max(x, y, z) > 0xFFFF:
        raise ValueError(f"splat_capsules_3d: dims {tuple(dims)} above 65535")
    a, b, radius, valid = (t.contiguous() for t in (a, b, radius, valid))
    e = a.shape[0]
    tile = bin_tile(x, y)
    nbins = _cdiv(x, tile) * _cdiv(y, tile)
    out = torch.empty((x, y, z), dtype=out_dtype, device=dev)
    fn = SPLAT3D.function()
    with on_device(dev):
        stream = stream_handle(dev)
        # room for every edge in every bin: [nbins, E] int4 entries
        entries, counts = scratch(
            dev, stream, k4_entries=(nbins * max(e, 1) * 4, torch.int32),
            k4_counts=(nbins, torch.int32))
        err = fn(a.data_ptr(), b.data_ptr(), radius.data_ptr(),
                 valid.data_ptr(), entries.data_ptr(), counts.data_ptr(),
                 out.data_ptr(), int(out_dtype == torch.uint8), e, x, y, z,
                 tile, stream)
    if err != 0:
        raise RuntimeError(f"splat3d kernel launch failed: cudaError_t {err}")
    SPLAT3D.launches += 1
    return out


def splat_capsules_3d(a, b, radius, valid, *, dims, out_dtype=torch.float32):
    """3D capsule voxelization (K4). Inputs and output as
    :func:`splat_capsules_3d_plain`.

    CPU tensors run the plain version; CUDA tensors launch the hand-written
    kernels (built at first use), or raise.
    """
    if a.device.type == "cpu":
        return splat_capsules_3d_plain(a, b, radius, valid, dims=dims,
                                       out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"splat_capsules_3d: unsupported device {a.device}")
    a, b, radius, valid = _check(a, b, radius, valid, dims, out_dtype)
    return _splat3d_cuda(a, b, radius, valid, dims, out_dtype)
