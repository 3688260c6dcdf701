"""K4: 3D capsule voxelizer — plain PyTorch version, CUDA kernel.

Counterpart of ``octa_tpu/ops/raster.py`` ``splat_capsules_3d`` (:334), the
oracle, and of the TPU kernel ``octa_tpu/ops/pallas_splat.py``
``splat_capsules_3d_pallas`` (:284, body ``_splat3d_tile_kernel`` :222).

For every voxel ``v`` (centre ``v + 0.5``) the volume holds
``clip(max over edges of contrib, 0, 1)`` with ``contrib = 1 - (d - (r -
sqrt3/2)) / sqrt3``: ``d`` is the distance to the nearer end point, and where
the projection parameter lies strictly inside ``0 < t < 1`` the larger of
that term and the one at the orthogonal distance. An edge counts only for
voxels whose *index* lies in its bbox ``[floor(min(a, b) - r sqrt2),
ceil(max(a, b) + r sqrt2 + 1))`` on all three axes; invalid edges count
nowhere.

Both versions here scatter edge by edge and have no per-tile edge limit:
every valid edge counts. The oracle and the TPU kernel gather per tile and
drop a tile's edges beyond ``k_max`` (each by its own order);
``voxelize_forest`` picks ``k_max`` so that no tile overflows, and there all
agree.

Both take the orthogonal distance as ``|(c - a) - t (b - a)|`` with ``t =
((c - a) . s) * (1 / max(|s|², 1e-12))``, as the TPU kernel does; the oracle
writes ``|c - (a + t s)|`` with a division, whose intermediate near coordinate
1000 rounds by 1.2e-4. Kernel and plain version round every operation at the
same place (the plain version divides by a sqrt3 held in a tensor: by a
Python scalar PyTorch multiplies with the reciprocal on the card, one
rounding apart), so on one device they agree bit for bit; they are held to
1e-4.

:func:`splat_capsules_3d` dispatches on the device of its inputs: CPU tensors
go to :func:`splat_capsules_3d_plain`, CUDA tensors to the kernel in
``csrc/splat3d.cu``, which is built at first use. There is no fallback from
one to the other.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from octa_tpu_torch.ops._cuda import CudaKernel

_VP, _I = ctypes.c_void_p, ctypes.c_int
SPLAT3D = CudaKernel(
    "splat3d.cu", "splat3d_launch", [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP])
_SQRT2 = math.sqrt(2.0)
_DIAG = math.sqrt(3.0)
# (voxel, edge) pairs of one chunk of the plain version
_PLAIN_PAIRS = 1 << 22


def _check(a, b, radius, valid, dims):
    if (a.dim() != 2 or a.shape[-1] != 3 or b.shape != a.shape
            or radius.shape != a.shape[:1] or valid.shape != a.shape[:1]):
        raise ValueError(
            "splat_capsules_3d: expected a, b [E,3] and radius, valid [E]; got "
            f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(radius.shape)}, "
            f"{tuple(valid.shape)}")
    if len(dims) != 3 or min(dims) < 1 or dims[0] * dims[1] * dims[2] >= 2 ** 31:
        raise ValueError(f"splat_capsules_3d: bad dims {tuple(dims)}")
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


def splat_capsules_3d_plain(a, b, radius, valid, *, dims,
                            pairs: int = _PLAIN_PAIRS):
    """Plain PyTorch K4: chunks of edges, each chunk's (voxel, edge) pairs
    laid out flat (at most about ``pairs`` of them at a time, so that memory
    stays bounded at any volume size), reduced to one maximum per voxel and
    merged into a volume that starts at 0.

    a, b: [E, 3] end points in voxel coordinates; radius: [E] voxels; valid:
    [E] bool. Returns the [X, Y, Z] float32 volume in [0, 1].
    """
    a, b, radius, valid = _check(a, b, radius, valid, dims)
    dev = a.device
    x, y, z = (int(d) for d in dims)
    vol = torch.zeros(x * y * z, device=dev)
    lo, n = edge_bboxes(a, b, radius, dims)
    cnt = n.prod(-1) * valid
    live = torch.nonzero(cnt > 0)[:, 0]
    if live.numel() == 0:
        return vol.reshape(x, y, z)
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
    # a tensor on the device, so that the division below is a division: by a
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
        ag, bg, sg = a[g], b[g], seg[g]
        cx, cy, cz = vx.float() + 0.5, vy.float() + 0.5, vz.float() + 0.5
        dx, dy, dz = cx - ag[:, 0], cy - ag[:, 1], cz - ag[:, 2]
        tpar = (dx * sg[:, 0] + dy * sg[:, 1] + dz * sg[:, 2]) * invd[g]
        px = dx - tpar * sg[:, 0]
        py = dy - tpar * sg[:, 1]
        pz = dz - tpar * sg[:, 2]
        d_orth = torch.sqrt(px * px + py * py + pz * pz)
        d_a = torch.sqrt(dx * dx + dy * dy + dz * dz)
        ex, ey, ez = cx - bg[:, 0], cy - bg[:, 1], cz - bg[:, 2]
        d_b = torch.sqrt(ex * ex + ey * ey + ez * ez)
        d_end = torch.minimum(d_a, d_b)
        bs = base[g]
        c_end = 1.0 - (d_end - bs) / diag
        c_seg = 1.0 - (d_orth - bs) / diag
        inside = (tpar > 0.0) & (tpar < 1.0)
        contrib = torch.where(inside, torch.maximum(c_seg, c_end), c_end)
        # the maximum per voxel: sort the pairs by voxel and reduce each run
        # (a scatter with repeated indices is not safe on every backend)
        lin, order = torch.sort((vx * y + vy) * z + vz)
        vox, runs = torch.unique_consecutive(lin, return_counts=True)
        top = torch.segment_reduce(contrib[order], "max", lengths=runs)
        vol[vox] = torch.maximum(vol[vox], top.clamp(max=1.0))
    return vol.reshape(x, y, z)


def _splat3d_cuda(a, b, radius, valid, dims):
    dev = a.device
    if any(t.device != dev for t in (b, radius, valid)):
        raise ValueError("splat_capsules_3d: inputs on different devices")
    a, b, radius, valid = (t.contiguous() for t in (a, b, radius, valid))
    x, y, z = (int(d) for d in dims)
    vol = torch.zeros((x, y, z), dtype=torch.float32, device=dev)
    e = a.shape[0]
    if e == 0:
        return vol
    fn = SPLAT3D.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), radius.data_ptr(),
                 valid.data_ptr(), vol.data_ptr(), e, x, y, z, stream)
    if err != 0:
        raise RuntimeError(f"splat3d kernel launch failed: cudaError_t {err}")
    SPLAT3D.launches += 1
    return vol


def splat_capsules_3d(a, b, radius, valid, *, dims):
    """3D capsule voxelization (K4). Inputs and output as
    :func:`splat_capsules_3d_plain`.

    CPU tensors run the plain version; CUDA tensors launch the hand-written
    kernel (built at first use), or raise.
    """
    if a.device.type == "cpu":
        return splat_capsules_3d_plain(a, b, radius, valid, dims=dims)
    if a.device.type != "cuda":
        raise ValueError(f"splat_capsules_3d: unsupported device {a.device}")
    a, b, radius, valid = _check(a, b, radius, valid, dims)
    return _splat3d_cuda(a, b, radius, valid, dims)
