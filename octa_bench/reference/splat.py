"""The antialiased 2D line splat (K1's semantics), tile by tile.

Every ``tile``² bin keeps the first ``k_max`` valid edges, in edge order,
whose bbox dilated by ``w/2 + 1`` touches it (closed intervals); a pixel's
coverage is ``1 - prod(1 - alpha)`` over its bin's edges, with ``alpha =
clip(min(d + w/2, 0.5) - max(d - w/2, -0.5), 0, 1)`` and ``d`` the distance
from the pixel centre to the segment. Points are (row, col) pixels.
"""
from __future__ import annotations

import torch


def splat(a, b, width, valid, height: int, wid: int, k_max: int,
          tile: int = 128, dtype=torch.float32, chunk: int = 64):
    """a, b [B, E, 2]; width, valid [B, E] -> coverage [B, height, wid]
    (float32), computed in ``dtype``."""
    bsz, e = valid.shape
    dev = a.device
    a, b, width = a.float(), b.float(), width.float()
    reach = width * 0.5 + 1.0
    lo = torch.minimum(a, b) - reach[..., None]
    hi = torch.maximum(a, b) + reach[..., None]
    nty, ntx = -(-height // tile), -(-wid // tile)
    out = torch.zeros(bsz, nty * tile, ntx * tile, device=dev)
    r = torch.arange(tile, device=dev, dtype=torch.float32) + 0.5
    grid = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1).view(-1, 2)
    bi = torch.arange(bsz, device=dev)[:, None]
    for ty in range(nty):
        for tx in range(ntx):
            t_lo = torch.tensor([ty * tile, tx * tile], device=dev,
                                dtype=torch.float32)
            t_hi = t_lo + tile
            touch = valid & ~((hi < t_lo) | (lo > t_hi)).any(-1)   # [B, E]
            keep = touch & (torch.cumsum(touch, 1) <= k_max)
            cnt = keep.sum(1)
            kk = int(cnt.max())
            acc = torch.ones(bsz, tile * tile, device=dev, dtype=dtype)
            if kk:
                order = torch.argsort((~keep).to(torch.int8), dim=1,
                                      stable=True)[:, :kk]
                used = torch.arange(kk, device=dev)[None] < cnt[:, None]
                pts = (grid + t_lo).to(dtype)[None, :, None]     # [1, P, 1, 2]
                for c0 in range(0, kk, chunk):
                    ids = order[:, c0:c0 + chunk]
                    m = used[:, c0:c0 + chunk]
                    ea = a[bi, ids].to(dtype)[:, None]            # [B, 1, C, 2]
                    eb = b[bi, ids].to(dtype)[:, None]
                    eh = (width[bi, ids] * 0.5).to(dtype)[:, None]  # [B, 1, C]
                    ab = eb - ea
                    rel = pts - ea
                    t = ((rel * ab).sum(-1)
                         / (ab * ab).sum(-1).clamp(min=1e-12)).clamp(0, 1)
                    diff = rel - t[..., None] * ab
                    d = torch.sqrt((diff * diff).sum(-1))        # [B, P, C]
                    alpha = (torch.clamp(d + eh, max=0.5)
                             - torch.clamp(d - eh, min=-0.5)).clamp(0, 1)
                    alpha = torch.where(m[:, None], alpha, 0)
                    acc = acc * torch.prod(1 - alpha, -1)
            cov = (1 - acc.float()).view(bsz, tile, tile)
            out[:, ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile] = cov
    return out[:, :height, :wid]


def graph_edges(node1, node2, radius, res: int, keep=None):
    """Unit-cube edges -> K1's inputs at ``res``: rows from x, columns from
    y, stroke width ``radius * 1.3 * res * 100 / 72`` (the renderer's
    matplotlib points)."""
    w = radius * 1.3 * res * (100.0 / 72.0)
    valid = torch.ones_like(radius, dtype=torch.bool) if keep is None else keep
    return node1[..., :2] * res, node2[..., :2] * res, w, valid
