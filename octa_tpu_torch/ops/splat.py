"""K1: antialiased 2D line splat — plain PyTorch version, binning, CUDA kernels.

Counterpart of ``octa_tpu/ops/raster.py`` ``splat_lines_2d`` (:253), the
oracle, and of the TPU kernel ``octa_tpu/ops/pallas_splat.py``
``splat_lines_2d_pallas`` (:93, body ``_splat_tile_kernel`` :41).

Semantics held on both paths (the oracle's, not the ``span_``-limited Pallas
call's): every ``tile``² bin an edge's dilated bbox ``min/max(a, b) -/+
(w/2 + 1)`` touches, by the closed-interval rule of ``_tile_topk_edges``
(``raster.py:223-237``), gets the edge; each bin keeps its first ``k_max``
such edges in edge-index order, and the product ``prod(1 - alpha)`` runs in
that order.

Both paths take the distance as ``|(p - a) - t (b - a)|``, where the oracle
writes ``|p - (a + t (b - a))|``: the same function, but at 1216² the
oracle's intermediate ``a + t (b - a)`` is a coordinate near 1000 whose float32
rounding (2**-13 = 1.2e-4 px) passes into the coverage. Relative to ``a``
every term stays small, so kernel and plain version agree far inside 1e-4
at every image size.

:func:`splat_lines_2d` dispatches on the device of its inputs: CPU tensors go
to :func:`splat_lines_2d_plain`, CUDA tensors to the kernels in
``csrc/splat2d.cu``, which are built at first use: one host call launches
the binning (:func:`bin_edges_plain` is its plain version) and the splat,
with no sort and no host sync. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from octa_tpu_torch.ops._cuda import CudaKernel, on_device, scratch, stream_handle

_VP, _I = ctypes.c_void_p, ctypes.c_int
SPLAT2D = CudaKernel("splat2d.cu", "splat2d_launch", [_VP] * 7 + [_I] * 6 + [_VP])
SUB_TILE = 32  # pixels per side of one CUDA block's sub-tile


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _as_batched(a, b, width_px, valid):
    batched = a.dim() == 3
    if not batched:
        a, b, width_px, valid = a[None], b[None], width_px[None], valid[None]
    if a.shape[-1] != 2 or b.shape != a.shape or width_px.shape != a.shape[:2] \
            or valid.shape != a.shape[:2]:
        raise ValueError(
            f"splat_lines_2d: expected a, b [B,E,2] and width, valid [B,E]; got "
            f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(width_px.shape)}, "
            f"{tuple(valid.shape)}")
    return (batched, a.float(), b.float(), width_px.float(), valid.bool())


def _dilated_bbox(a, b, width_px):
    reach = width_px * 0.5 + 1.0  # AA fringe
    lo = torch.minimum(a, b) - reach[..., None]
    hi = torch.maximum(a, b) + reach[..., None]
    return lo, hi


def bin_edges_plain(a, b, width_px, valid, *, height: int, width: int,
                    tile: int = 128, k_max: int):
    """Plain PyTorch version of K1's binning kernel: for every ``tile``² bin
    the first ``k_max`` edges, in edge-index order, whose dilated bbox
    touches it by the closed-interval rule of ``_tile_topk_edges``
    (``raster.py:223-237``).

    a, b: [B, E, 2]; width_px, valid: [B, E]. Returns ``(ids, counts)``:
    int32 ``ids`` [B, nbins, k] with k = min(k_max, E), each bin's edge ids
    in order in its first ``counts`` slots (0 after them), and int32
    ``counts`` [B, nbins], at most k. Bins run row-major within an image.
    """
    bsz, e = valid.shape
    dev = a.device
    k = min(k_max, e)
    nty, ntx = _cdiv(height, tile), _cdiv(width, tile)
    lo, hi = _dilated_bbox(a, b, width_px)
    t_lin = torch.arange(nty * ntx, device=dev)
    tile_lo = torch.stack([(t_lin // ntx) * tile, (t_lin % ntx) * tile],
                          -1).float()                       # [nt, 2]
    tile_hi = tile_lo + float(tile)
    sep = (hi[:, None] < tile_lo[None, :, None]) | (
        lo[:, None] > tile_hi[None, :, None])               # [B, nt, E, 2]
    overlap = ~sep.any(-1) & valid[:, None]                 # [B, nt, E]
    # a hit's place in its bin's list is the number of hits before it
    pos = torch.cumsum(overlap, -1, dtype=torch.int64) - 1
    kept = overlap & (pos < k)
    ids = torch.zeros(bsz, nty * ntx, k + 1, dtype=torch.int32, device=dev)
    eid = torch.arange(e, device=dev, dtype=torch.int32).expand_as(overlap)
    ids.scatter_(-1, torch.where(kept, pos, k), torch.where(kept, eid, 0))
    counts = overlap.sum(-1).clamp(max=k).to(torch.int32)
    return ids[..., :k], counts


def splat_lines_2d_plain(a, b, width_px, valid, *, height: int, width: int,
                         tile: int = 128, k_max: int = 768, chunk: int = 16):
    """Plain PyTorch splat, the oracle's algorithm step for step.

    a, b: [E, 2] or [B, E, 2] endpoints in pixel (row, col) coordinates;
    width_px: [E] / [B, E] stroke widths in pixels; valid: matching bool
    mask. Returns coverage [height, width] (or [B, height, width]) in [0, 1].
    """
    batched, a, b, width_px, valid = _as_batched(a, b, width_px, valid)
    bsz, e = valid.shape
    dev = a.device
    nty, ntx = _cdiv(height, tile), _cdiv(width, tile)
    nt = nty * ntx
    half = width_px * 0.5
    idx, counts = bin_edges_plain(a, b, width_px, valid, height=height,
                                  width=width, tile=tile, k_max=k_max)
    idx = idx.long()
    mask = torch.arange(idx.shape[-1], device=dev) < counts[..., None]
    used = int(counts.max()) if counts.numel() else 0

    t_lin = torch.arange(nt, device=dev)
    tile_lo = torch.stack([(t_lin // ntx) * tile, (t_lin % ntx) * tile],
                          -1).float()                       # [nt, 2]
    rr = torch.arange(tile, device=dev, dtype=torch.float32) + 0.5
    offs = torch.stack(torch.meshgrid(rr, rr, indexing="ij"), -1)  # [T, T, 2]
    pts = (tile_lo[:, None, None, None, :]
           + offs[None, :, :, None, :])                     # [nt, T, T, 1, 2]
    bi = torch.arange(bsz, device=dev)[:, None, None]
    acc = torch.ones(bsz, nt, tile, tile, device=dev)
    for c0 in range(0, used, chunk):
        ic, mc = idx[..., c0:c0 + chunk], mask[..., c0:c0 + chunk]
        ea = a[bi, ic][:, :, None, None]                    # [B, nt, 1, 1, C, 2]
        eb = b[bi, ic][:, :, None, None]
        eh = half[bi, ic][:, :, None, None]                 # [B, nt, 1, 1, C]
        ab = eb - ea
        rel = pts - ea
        tpar = (rel * ab).sum(-1) / (ab * ab).sum(-1).clamp(min=1e-12)
        diff = rel - tpar.clamp(0.0, 1.0)[..., None] * ab
        d = torch.sqrt((diff * diff).sum(-1))               # [B, nt, T, T, C]
        alpha = (torch.minimum(d + eh, torch.tensor(0.5, device=dev))
                 - torch.maximum(d - eh, torch.tensor(-0.5, device=dev))
                 ).clamp(0.0, 1.0)
        alpha = torch.where(mc[:, :, None, None, :], alpha, 0.0)
        acc = acc * torch.prod(1.0 - alpha, dim=-1)
    img = (1.0 - acc).reshape(bsz, nty, ntx, tile, tile).permute(0, 1, 3, 2, 4)
    img = img.reshape(bsz, nty * tile, ntx * tile)[:, :height, :width]
    return img if batched else img[0]


def _splat_cuda(a, b, width_px, valid, *, height, width, tile, k_max):
    if tile % SUB_TILE:
        raise ValueError(f"splat_lines_2d: tile {tile} not a multiple of {SUB_TILE}")
    dev = a.device
    if any(t.device != dev for t in (b, width_px, valid)):
        raise ValueError("splat_lines_2d: inputs on different devices")
    a, b, width_px, valid = (t.contiguous() for t in (a, b, width_px, valid))
    if a.data_ptr() % 8 or b.data_ptr() % 8:
        raise ValueError("splat_lines_2d: a and b must be 8-byte aligned")
    bsz, e = valid.shape
    if bsz > 65535:
        raise ValueError(f"splat_lines_2d: at most 65535 images, got {bsz}")
    k = min(k_max, e)
    nbins = _cdiv(height, tile) * _cdiv(width, tile)
    out = torch.empty(bsz, height, width, device=dev, dtype=torch.float32)
    fn = SPLAT2D.function()
    with on_device(dev):
        stream = stream_handle(dev)
        ids, counts = scratch(dev, stream,
                              ids=(bsz * nbins * max(k, 1), torch.int32),
                              counts=(bsz * nbins, torch.int32))
        err = fn(a.data_ptr(), b.data_ptr(), width_px.data_ptr(),
                 valid.data_ptr(), ids.data_ptr(), counts.data_ptr(),
                 out.data_ptr(), bsz, e, height, width, tile, k, stream)
    if err != 0:
        raise RuntimeError(f"splat2d kernel launch failed: cudaError_t {err}")
    SPLAT2D.launches += 1
    return out


def splat_lines_2d(a, b, width_px, valid, *, height: int, width: int,
                   tile: int = 128, k_max: int):
    """Antialiased 2D line splat (K1). Inputs as :func:`splat_lines_2d_plain`.

    CPU tensors run the plain version; CUDA tensors launch the hand-written
    kernel (built at first use), or raise.
    """
    if a.device.type == "cpu":
        return splat_lines_2d_plain(a, b, width_px, valid, height=height,
                                    width=width, tile=tile, k_max=k_max)
    if a.device.type != "cuda":
        raise ValueError(f"splat_lines_2d: unsupported device {a.device}")
    batched, a, b, width_px, valid = _as_batched(a, b, width_px, valid)
    out = _splat_cuda(a, b, width_px, valid, height=height, width=width,
                      tile=tile, k_max=k_max)
    return out if batched else out[0]
