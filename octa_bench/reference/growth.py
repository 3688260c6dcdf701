"""What can be checked of a grown forest without growing it again: the
structure of each tree, how far it grew, its radii under Murray's law, the
edges taken from it, and the nearest-point scans (K2) and segment sums (K3)
the growth made on its way, from their recorded inputs.

A forest holds ``pos`` [B, NC, 3], ``radius`` [B, NC], ``parent`` [B, NC]
(-1 for a root), ``n_children`` [B, NC], ``is_root`` [B, NC] and
``n_nodes`` [B]; the first ``n_nodes`` slots of a sample exist. Nodes are
appended, so a node's parent comes before it.
"""
from __future__ import annotations

import math

import torch


def faults(f, kappas=None) -> int:
    """The structural faults of a batch of forests: existing slots whose
    root flag and parent disagree, whose parent is not an earlier existing
    node, whose radius is not positive and finite, whose position is not
    finite, or whose count of children differs from the nodes naming it;
    samples holding more nodes than slots; and, given the Murray exponents
    the configuration allows (``kappas``), nodes whose exponent is none of
    them or whose parent's exponent, as the node keeps it, is not the
    parent's."""
    b, nc = f.parent.shape
    n = f.n_nodes.long()
    idx = torch.arange(nc, device=f.parent.device)
    exists = idx[None] < n[:, None]
    par = f.parent.long()
    root = f.is_root.bool()
    bad = exists & (root != (par < 0))
    bad |= exists & ~root & ~((par >= 0) & (par < idx[None]))
    bad |= exists & ~(torch.isfinite(f.radius) & (f.radius > 0))
    bad |= exists & ~torch.isfinite(f.pos).all(-1)
    kids = torch.zeros(b, nc + 1, dtype=torch.long, device=par.device)
    named = torch.where(exists & (par >= 0), par, nc)
    kids.scatter_add_(1, named, torch.ones_like(named))
    bad |= exists & (kids[:, :nc] != f.n_children.long())
    if kappas is not None:
        allowed = torch.tensor(sorted(kappas), dtype=f.kappa.dtype,
                               device=f.kappa.device)
        bad |= exists & ~(f.kappa[..., None] == allowed).any(-1)
        pk = torch.gather(f.kappa, 1, par.clamp(0, nc - 1))
        bad |= exists & ~root & (f.pkappa != pk)
    return int(bad.sum()) + int((n > nc).sum())


def stump_share(forests, n_trees: int) -> float:
    """The largest share that a sample's initial stumps (a root and its
    first node, for each of ``n_trees`` trees of each forest) take of its
    nodes, all forests together: 1 where nothing grew."""
    nodes = sum(f.n_nodes.double() for f in forests)
    return float((2.0 * n_trees * len(forests) / nodes.clamp(min=1)).max())


def _children(f):
    """Each existing non-root node, and its parent (``nc`` elsewhere)."""
    nc = f.parent.shape[-1]
    exists = torch.arange(nc, device=f.parent.device)[None] < f.n_nodes[:, None]
    child = exists & (f.parent >= 0)
    return exists, child, torch.where(child, f.parent.long(), nc)


def murray_radii(f, sweeps: int, dtype=torch.float64):
    """The radii relaxed by ``sweeps`` sweeps of Murray's law on the
    forest's own tree, in ``dtype``: each internal node's radius is
    ``(sum of its children's r**k)**(1/k)``, ``k`` its own exponent."""
    nc = f.parent.shape[-1]
    exists, child, par = _children(f)
    internal = exists & ~f.is_root.bool() & (f.n_children >= 1)
    k = f.kappa.to(dtype)
    kp = torch.gather(k, 1, par.clamp(max=nc - 1))
    r = f.radius.to(dtype)
    for _ in range(sweeps):
        rk = torch.where(child, r ** kp, torch.zeros((), dtype=dtype,
                                                     device=r.device))
        sums = torch.zeros(r.shape[0], nc + 1, dtype=dtype, device=r.device)
        sums.scatter_add_(1, par, rk)
        r = torch.where(internal, sums[:, :nc] ** (1.0 / k), r)
    return r


def murray_gap(f, r0: float, radius=None) -> float:
    """The largest relative gap of a radius from Murray's law on the final
    tree (float64): an internal node's from ``(sum of its children's
    r**k)**(1/k)``, a leaf's from the initial radius ``r0``. ``radius``
    stands in for the forest's own."""
    nc = f.parent.shape[-1]
    exists, child, par = _children(f)
    root = f.is_root.bool()
    internal = exists & ~root & (f.n_children >= 1)
    leaf = exists & ~root & (f.n_children == 0)
    r = (f.radius if radius is None else radius).double()
    k = f.kappa.double()
    kp = torch.gather(k, 1, par.clamp(max=nc - 1))
    rk = torch.where(child, r ** kp, torch.zeros((), dtype=r.dtype,
                                                 device=r.device))
    sums = torch.zeros(r.shape[0], nc + 1, dtype=r.dtype, device=r.device)
    sums.scatter_add_(1, par, rk)
    target = sums[:, :nc] ** (1.0 / k)
    gap = torch.where(internal, (r - target).abs() / target.clamp(min=1e-30),
                      torch.zeros_like(r))
    gap = torch.maximum(gap, torch.where(leaf, (r - r0).abs() / r0,
                                         torch.zeros_like(r)))
    return float(gap.max())


def nearest(query, points, masks, q_idx, dtype=torch.float64,
            budget: int = 1 << 25):
    """The nearest point each mask admits, for the queries ``q_idx`` of
    every row, by the difference form over all points in ``dtype``:
    ``d`` [R, M, Qs] (+inf where a mask admits none) and its index, the
    lowest on ties."""
    q = query[:, q_idx].to(dtype)
    p = points.to(dtype)
    r, qs, n, m = q.shape[0], q.shape[1], p.shape[1], masks.shape[1]
    d = torch.empty(r, m, qs, dtype=dtype, device=q.device)
    idx = torch.empty(r, m, qs, dtype=torch.long, device=q.device)
    inf = torch.tensor(float("inf"), dtype=dtype, device=q.device)
    step = max(1, budget // max(qs * n, 1))
    for a in range(0, r, step):
        sl = slice(a, a + step)
        d2 = None
        for c in range(3):
            dc = q[sl, :, None, c] - p[sl, None, :, c]
            d2 = dc * dc if d2 is None else d2 + dc * dc
        for k in range(m):
            best, i = torch.min(torch.where(masks[sl, k, None, :], d2, inf),
                                dim=-1)
            d[sl, k], idx[sl, k] = torch.sqrt(best), i
    return d, idx


def nearest_gap(call, q_idx, got=None) -> float:
    """How far a K2 call's answers lie from the nearest admitted point, in
    the simulation space's units, over the queries ``q_idx``: the gap of
    the distance returned, and of the distance to the point whose index it
    returned, from the reference's (float64). A query that no mask admits
    must read +inf. ``got`` (``d``, ``idx`` or None, at the queries
    ``q_idx``) stands in for the call's own answers."""
    query, points, masks, d_got, i_got = call
    if got is None:
        d_got = d_got[:, :, q_idx]
        i_got = None if i_got is None else i_got[:, :, q_idx]
    else:
        d_got, i_got = got
    d_ref, _ = nearest(query, points, masks, q_idx)
    d_got = d_got.double()
    none = torch.isinf(d_ref)
    gap = torch.where(none, torch.where(torch.isinf(d_got), 0.0, math.inf),
                      (d_got - d_ref).abs())
    if i_got is not None:
        i = i_got.long().clamp(0, points.shape[1] - 1)
        q = query[:, q_idx].double()
        p = points.double()
        at = torch.gather(p[:, None].expand(-1, i.shape[1], -1, -1), 2,
                          i[..., None].expand(-1, -1, -1, 3))
        d_at = (q[:, None] - at).pow(2).sum(-1).sqrt()
        admitted = torch.gather(masks, 2, i)
        d_at = torch.where(admitted, d_at, math.inf)
        gap = torch.maximum(gap, torch.where(none, 0.0, d_at - d_ref))
    return float(gap.max())


def segsum(seg, feats, nc: int, dtype=torch.float64):
    """``out[r, n, f]``: the sum of ``feats[r, s, f]`` over ``seg[r, s] ==
    n``, in ``dtype``; ids equal to ``nc`` go nowhere."""
    r, _, f = feats.shape
    out = torch.zeros(r, nc + 1, f, dtype=dtype, device=feats.device)
    out.scatter_add_(1, seg.long()[..., None].expand(-1, -1, f),
                     feats.to(dtype))
    return out[:, :nc]


def segsum_gap(call, got=None) -> float:
    """The largest gap of a K3 call's sums from the reference's (float64),
    over the sum of the magnitudes added into each. ``got`` stands in for
    the call's own sums."""
    seg, feats, nc, out = call
    out = out if got is None else got
    ref = segsum(seg, feats, nc)
    scale = segsum(seg, feats.abs(), nc)
    return float(((out.double() - ref).abs() / scale.clamp(min=1e-30)).max())


def edges(f):
    """One edge slot per node: the node's and its parent's (x, y), its
    radius, and whether it is an edge (an existing node with a parent)."""
    nc = f.pos.shape[-2]
    exists = torch.arange(nc, device=f.pos.device)[None] < f.n_nodes[:, None]
    par = f.parent.long().clamp(0, nc - 1)
    ppos = torch.gather(f.pos, 1, par[..., None].expand(-1, -1, 3))
    return f.pos[..., :2], ppos[..., :2], f.radius, exists & (f.parent >= 0)


def forest_edges(state):
    """Both forests' edges, arterial then venous, on the edge axis."""
    parts = [edges(f) for f in (state.art, state.ven)]
    return tuple(torch.cat([p[i] for p in parts], 1) for i in range(4))


def edges_mismatch(got, ref) -> int:
    """Edge slots where the program's edges differ from the reference's:
    validity, or any coordinate or radius of a valid edge."""
    a, b, r, v = got
    ra, rb, rr, rv = ref
    diff = v != rv
    both = v & rv
    diff |= both & ((a != ra).any(-1) | (b != rb).any(-1) | (r != rr))
    return int(diff.sum())
