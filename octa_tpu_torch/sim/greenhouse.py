"""Batched space-colonization vessel growth in PyTorch.

Counterpart of ``octa_tpu/sim/greenhouse.py``, function for function and
under the same names. The forest is a fixed-capacity structure of arrays and
every step is a masked, vectorized computation:

- oxygen-sink sampling with the Schneider-2012 oxygen heuristic and mutual
  ``eps_s`` spacing by a blocked greedy accept,
- nearest-active-node attraction assignment (K2,
  :func:`octa_tpu_torch.ops.nearest.masked_nearest`),
- per-node growth: leaf elongation with the FAZ rotation field, Murray-law
  bifurcation with a power-iteration PCA split direction, Rodrigues
  inter-node sprouting; the per-node attraction statistics are one
  18-feature segment sum (K3, :func:`octa_tpu_torch.ops.segsum.segment_sum`),
- Murray radius back-propagation as parallel segment-sum sweeps (K3, F = 1),
- simulation-space expansion by rescaling the distance parameters.

Where the JAX package maps a function over the batch with ``vmap``, the
arrays here carry explicit leading axes: ``[B]`` for a batch of samples and
``[B, 2]`` inside an iteration (row 0 arterial forest + oxygen sinks, row 1
venous forest + CO2 sources). Where it loops with ``scan``/``fori_loop``,
this is a Python loop. The helpers up to :func:`murray_sweep` take any
leading axes, none included; :func:`_iteration` takes exactly ``[B]``.

Random numbers: the JAX package threads a key through the state. Here a
``torch.Generator`` held by the :class:`Greenhouse` draws each iteration's
numbers (:func:`draw_iteration`), and every function that consumes draws
takes them as arguments, so a test can hand both packages the same numbers.

The banded configuration (``Greenhouse(..., banded=True)``, off by default;
the JAX package switches it with ``OCTA_TPU_BANDED=1``) prunes three of an
iteration's four nearest scans by a y-band (K5,
:func:`octa_tpu_torch.ops.nearest.masked_nearest_banded`): node and sink
slots are y-sorted at every segment boundary (:func:`_restage_spatial`), the
candidates are y-sorted inside the iteration, and sink appends fill the
tail-most free slots first, so that the sorted prefix stays coherent.

An iteration makes no host sync. :meth:`Greenhouse.develop_forest` reads a
few counters back once per capacity-staging segment, as the JAX package's
``develop_forest`` does.
"""
from __future__ import annotations

import warnings as _warnings
from typing import NamedTuple

import numpy as np
import torch

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.ops.nearest import masked_nearest, masked_nearest_banded
from octa_tpu_torch.ops.segsum import segment_sum, segment_sum_plain

GEOMETRY_SIZE = 76


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

class ForestState(NamedTuple):
    pos: torch.Tensor          # [..., NC, 3] f32
    radius: torch.Tensor       # [..., NC] f32
    parent: torch.Tensor       # [..., NC] int32, -1 for roots/empty
    first_child: torch.Tensor  # [..., NC] int32, -1 if none
    n_children: torch.Tensor   # [..., NC] int32
    is_root: torch.Tensor      # [..., NC] bool
    n_nodes: torch.Tensor      # [...] int32
    # per-node Murray exponents, fixed at creation: the current mode's for
    # grown nodes, 4 for stump/root nodes; the parent's own kappa is used for
    # both the child sum and the 1/kappa of the radius update
    kappa: torch.Tensor        # [..., NC] f32 — this node's creation kappa
    pkappa: torch.Tensor       # [..., NC] f32 — the parent's kappa


class SinkState(NamedTuple):
    pos: torch.Tensor    # [..., SC, 3] f32
    alive: torch.Tensor  # [..., SC] bool


class GrowthState(NamedTuple):
    """The JAX package's ``GrowthState`` without its ``key``: the random
    stream is the :class:`Greenhouse`'s generator."""
    art: ForestState
    ven: ForestState
    oxy: SinkState
    co2: SinkState
    sigma_t: torch.Tensor
    d_cur: torch.Tensor       # current inter-node distance (compounds per mode)
    d_start: torch.Tensor     # d at the current mode's entry (fixed per mode)
    faz_radius: torch.Tensor  # per-sim sampled FAZ radius (sim units)
    sat: torch.Tensor         # int32 bitmask: 1 = emission/append window hit,
    #                           2 = sink-capacity hit (the segment is redone)


class StackedState(NamedTuple):
    """Iteration-internal state with the arterial and venous forests stacked
    on an axis of 2 after the batch axis (row 0 = arterial + oxygen sinks,
    row 1 = venous + CO2 sources), so every per-forest op chain is issued
    once instead of twice."""
    forests: ForestState  # arrays [B, 2, NC, ...], n_nodes [B, 2]
    sinks: SinkState      # pos [B, 2, SC, 3], alive [B, 2, SC]
    sigma_t: torch.Tensor
    d_cur: torch.Tensor
    d_start: torch.Tensor
    faz_radius: torch.Tensor
    sat: torch.Tensor


def _stack_state(s: GrowthState) -> StackedState:
    ax = s.sigma_t.dim()  # the forest axis goes right after the batch axes
    f = ForestState(*(torch.stack([a, v], ax) for a, v in zip(s.art, s.ven)))
    sk = SinkState(*(torch.stack([a, v], ax) for a, v in zip(s.oxy, s.co2)))
    return StackedState(f, sk, s.sigma_t, s.d_cur, s.d_start, s.faz_radius,
                        s.sat)


def _unstack_state(s: StackedState) -> GrowthState:
    ax = s.sigma_t.dim()
    art = ForestState(*(x.select(ax, 0) for x in s.forests))
    ven = ForestState(*(x.select(ax, 1) for x in s.forests))
    oxy = SinkState(*(x.select(ax, 0) for x in s.sinks))
    co2 = SinkState(*(x.select(ax, 1) for x in s.sinks))
    return GrowthState(art, ven, oxy, co2, s.sigma_t, s.d_cur, s.d_start,
                       s.faz_radius, s.sat)


_FOREST_DTYPES = ForestState(
    torch.float32, torch.float32, torch.int32, torch.int32, torch.int32,
    torch.bool, torch.int32, torch.float32, torch.float32)


def state_from_numpy(state, device="cuda") -> GrowthState:
    """A growth state given as numpy-convertible arrays (the JAX package's
    ``GrowthState``, batched or not; its ``key`` is ignored) -> the port's
    ``GrowthState`` on ``device``."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.from_numpy(np.array(x)).to(device=dev, dtype=dtype)

    def forest(f):
        return ForestState(*(t(getattr(f, k), dt) for k, dt in
                             zip(ForestState._fields, _FOREST_DTYPES)))

    def sinks(s):
        return SinkState(t(s.pos, torch.float32), t(s.alive, torch.bool))

    return GrowthState(
        forest(state.art), forest(state.ven), sinks(state.oxy),
        sinks(state.co2), t(state.sigma_t, torch.float32),
        t(state.d_cur, torch.float32), t(state.d_start, torch.float32),
        t(state.faz_radius, torch.float32), t(state.sat, torch.int32))


def state_to_numpy(state: GrowthState) -> GrowthState:
    """The same state with every leaf a numpy array on the host."""
    def n(x):
        return x.detach().cpu().numpy()

    return GrowthState(
        ForestState(*(n(x) for x in state.art)),
        ForestState(*(n(x) for x in state.ven)),
        SinkState(*(n(x) for x in state.oxy)),
        SinkState(*(n(x) for x in state.co2)),
        n(state.sigma_t), n(state.d_cur), n(state.d_start),
        n(state.faz_radius), n(state.sat))


class ModeParams(NamedTuple):
    """Static per-mode parameters. eps/delta are the RAW config values: the
    reference uses them *undivided* on the first iteration of each mode and
    only applies /(param_scale * sigma_t) after the first expansion."""
    I: int
    N: int
    eps_n: float
    eps_s: float
    eps_k: float
    delta_art: float
    delta_ven: float
    gamma_art: float
    gamma_ven: float
    phi: float
    omega: float
    kappa: float
    delta_sigma: float
    first_mode: bool


class IterationDraws(NamedTuple):
    """The random numbers one iteration consumes."""
    vox: torch.Tensor       # [B, N, 2] int64 candidate voxels in [0, gsize)
    jitter: torch.Tensor    # [B, N, 3] f32 uniform [0, 1)
    u_bif: torch.Tensor     # [B, 2, NC] f32 uniform [0, 1)
    u_sprout: torch.Tensor  # [B, 2, NC] f32 uniform [0, 1)


def draw_iteration(generator: torch.Generator, batch: int, n_cand: int,
                   nc: int, gsize: int, device) -> IterationDraws:
    """Draw one iteration's numbers on ``device`` from ``generator``."""
    return IterationDraws(
        torch.randint(0, gsize, (batch, n_cand, 2), generator=generator,
                      device=device),
        torch.rand((batch, n_cand, 3), generator=generator, device=device),
        torch.rand((batch, 2, nc), generator=generator, device=device),
        torch.rand((batch, 2, nc), generator=generator, device=device))


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------

def _vnorm(v, keepdim=False):
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def _norm(v, eps=1e-12):
    return v / (_vnorm(v, keepdim=True) + eps)


def _angle_deg(u, v):
    """Angle in degrees between vectors along the last axis."""
    cos = (_norm(u) * _norm(v)).sum(-1).clamp(-1.0, 1.0)
    return torch.rad2deg(torch.acos(cos))


def _acos_deg(x):
    return torch.rad2deg(torch.acos(x.clamp(-1.0, 1.0)))


def _ipow(x, n: int):
    """``x ** n`` for a small positive integer by repeated squaring, the
    multiplication order XLA's ``integer_pow`` takes."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _oxygen_distance(r, param_scale):
    """Schneider-2012 oxygen concentration heuristic."""
    c_oxygen = 203.9e-3
    kappa = 0.02 * c_oxygen
    r0 = 3.5e-3
    x = r * param_scale / r0
    c1 = kappa * x * torch.exp(1.0 - x)
    return c1 * 6.0 / param_scale


def _take(arr, idx):
    """Gather along the node axis: ``arr`` [..., N] or [..., N, C] at ``idx``
    [..., K] (same leading axes)."""
    idx = idx.long()
    if arr.dim() == idx.dim():
        return torch.gather(arr, -1, idx)
    return torch.gather(arr, -2,
                        idx[..., None].expand(*idx.shape, arr.shape[-1]))


def _count_before(cum, k: int):
    """For each j in [0, k): how many entries of the ascending ``cum``
    [..., n] are <= j (``searchsorted(cum, j, side="right")``), [..., k]."""
    j = torch.arange(k, device=cum.device, dtype=cum.dtype)
    return torch.searchsorted(
        cum.contiguous(), j.expand(*cum.shape[:-1], k).contiguous(),
        right=True)


# ---------------------------------------------------------------------------
# Oxygen sink sampling
# ---------------------------------------------------------------------------

def _sample_candidates(vox, jitter, faz_center, faz_radius_sim, size_z,
                       nerve_center=None, nerve_radius=0.0, geometry=None):
    """Candidate sink positions from drawn voxels ``vox`` [..., N, 2] (int)
    and ``jitter`` [..., N, 3]: jittered voxels of the 76x76x1 grid with the
    FAZ disc (and optionally the optic-nerve disc) carved out. When a
    ``geometry`` boolean voxel mask is given, validity comes from the mask
    lookup instead. ``faz_radius_sim`` has the leading axes of ``vox``."""
    gsize = GEOMETRY_SIZE if geometry is None else max(geometry.shape)
    vx, vy = vox[..., 0], vox[..., 1]
    if geometry is not None:
        gx = vx.clamp(0, geometry.shape[0] - 1)
        gy = vy.clamp(0, geometry.shape[1] - 1)
        valid = geometry[gx, gy]
    else:
        cx = faz_center[0] * gsize
        cy = faz_center[1] * gsize
        rr = (torch.as_tensor(faz_radius_sim, device=vox.device)
              * gsize * 0.5)[..., None]
        valid = (_ipow(vx - cx, 2) + _ipow(vy - cy, 2)) > rr * rr
        if nerve_center is not None:
            ncx = nerve_center[0] * gsize
            ncy = nerve_center[1] * gsize
            nrr = nerve_radius * gsize
            valid = valid & ((_ipow(vx - ncx, 2) + _ipow(vy - ncy, 2))
                             > nrr ** 2)
    pos = torch.cat(
        [(vox.float() + jitter[..., :2]) / gsize,
         (jitter[..., 2:3] * size_z * gsize) / gsize], dim=-1)
    return pos, valid


def _blocked_greedy_spacing(pos, valid, eps_s, n_blocks=64):
    """Accept candidates in order; a candidate is rejected if it conflicts
    (dist <= eps_s) with an accepted earlier candidate. Processed in
    ``n_blocks`` sequential blocks; within a block the conservative rule
    (conflict with any earlier *valid* candidate) is used.

    The JAX package takes the pairwise distances block by block inside its
    scan; here all of them are taken once ([..., n, n], the same arithmetic
    per pair) and the sequential loop only combines boolean masks, a few
    launches per block.

    pos [..., n, 3], valid [..., n], eps_s a scalar or [...]."""
    n = pos.shape[-2]
    lead = pos.shape[:-2]
    dev = pos.device
    bs = -(-n // n_blocks)
    n_pad = n_blocks * bs
    pos_p = torch.nn.functional.pad(pos, (0, 0, 0, n_pad - n))
    val_p = torch.nn.functional.pad(valid, (0, n_pad - n))
    eps = torch.as_tensor(eps_s, dtype=torch.float32,
                          device=dev).expand(lead)[..., None, None]
    close = _vnorm(pos_p[..., :, None, :] - pos_p[..., None, :, :]) <= eps
    k = torch.arange(n_pad, device=dev)
    earlier_in_block = ((k[:, None] // bs == k[None, :] // bs)
                        & (k[None, :] < k[:, None]))
    conflict_intra = (close & earlier_in_block & val_p[..., None, :]).any(-1)
    ok = val_p & ~conflict_intra
    acc_mask = torch.zeros(*lead, n_pad, dtype=torch.bool, device=dev)
    for i in range(n_blocks):
        blk = slice(i * bs, (i + 1) * bs)
        conflict_prev = (close[..., blk, :] & acc_mask[..., None, :]).any(-1)
        acc_mask[..., blk] = ok[..., blk] & ~conflict_prev
    return acc_mask[..., :n]


def _append_sinks(sinks: SinkState, pos, accept, max_append=2048,
                  tail_first: bool = False):
    """Place accepted candidates into free sink slots (both in index order;
    with ``tail_first`` the free slots are taken from the end of the array).

    The (few) accepted candidates and the free slots they go to are
    compacted by two prefix-sum inversions, then ``max_append`` rows are
    scattered. Returns (state, sat_window, sat_capacity): ``sat_window``
    trips the caller's segment redo with a doubled append window;
    ``sat_capacity`` trips a redo with a larger sink array.

    ``tail_first`` is the banded configuration's rule: after a restage the
    alive prefix is y-sorted and the free slots lie at the tail, so filling
    from the tail keeps the prefix coherent, and interior holes left by
    deaths are reused only once the tail is exhausted. The set of sinks
    placed is the same either way; only the slots differ.

    sinks.pos [..., SC, 3], pos [..., Sq, 3], accept [..., Sq]."""
    sc = sinks.pos.shape[-2]
    sq = pos.shape[-2]
    k = min(max_append, sq)
    cum_acc = torch.cumsum(accept.long(), -1)                  # [..., Sq]
    n_acc = cum_acc[..., -1:]
    r = torch.arange(k, device=pos.device)
    cand_idx = _count_before(cum_acc, k).clamp(0, sq - 1)      # r-th accept
    free = ~sinks.alive
    if tail_first:
        cum_free = torch.cumsum(free.flip(-1).long(), -1)      # [..., SC]
        slot_idx = sc - 1 - _count_before(cum_free, k).clamp(0, sc - 1)
    else:
        cum_free = torch.cumsum(free.long(), -1)
        slot_idx = _count_before(cum_free, k).clamp(0, sc - 1)  # r-th free
    n_free = cum_free[..., -1:]
    place = (r < n_acc) & (r < n_free)
    tgt = torch.where(place, slot_idx, sc)  # sc: one padded row, sliced off
    posal = torch.cat([sinks.pos, sinks.alive[..., None].float()], -1)
    posal = torch.nn.functional.pad(posal, (0, 0, 0, 1))
    upd = torch.cat([_take(pos, cand_idx),
                     torch.ones(*cand_idx.shape, 1, device=pos.device)], -1)
    posal = posal.scatter(-2, tgt[..., None].expand(*tgt.shape, 4), upd)
    return (SinkState(posal[..., :sc, :3], posal[..., :sc, 3] > 0.5),
            n_acc[..., 0] > k, n_acc[..., 0].clamp(max=k) > n_free[..., 0])


# ---------------------------------------------------------------------------
# Growth
# ---------------------------------------------------------------------------

def _power_iteration_3x3(M, iters=24):
    """Principal eigenvector of symmetric 3x3 matrices [..., 3, 3]."""
    # filled on the device: a host list would be copied over, and the copy
    # waits for the device
    v = torch.cat([torch.full_like(M[..., :1, 0], c)
                   for c in (0.6, 0.7, 0.38)], -1)
    for _ in range(iters):
        v = _norm((M * v[..., None, :]).sum(-1))
    return v


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _rodrigues(v, axis, theta_deg):
    th = torch.deg2rad(theta_deg)[..., None]
    cos, sin = torch.cos(th), torch.sin(th)
    return (v * cos + _cross(axis, v) * sin
            + axis * (axis * v).sum(-1, keepdim=True) * (1 - cos))


def _grow_core(forest: ForestState, sink_pos, sink_alive, dist, idx, *,
               gamma, delta, d, r, kappa, phi, omega, faz_center, faz_radius,
               rotation_radius, first_mode, t, u_bif, u_sprout,
               murray_sweeps=8, new_cap=1024):
    """One growth pass for forests with any leading axes ``[...]``; the
    attraction assignment (``dist, idx`` = nearest active node per sink,
    [..., Sq]) is computed by the caller. ``gamma``, ``delta``, ``d`` and
    ``faz_radius`` are scalars or ``[...]``; ``r``, ``kappa``, ``phi``,
    ``omega``, ``rotation_radius`` Python floats; ``t`` a Python int;
    ``u_bif``, ``u_sprout`` [..., NC] uniform draws. Returns
    (forest', window-overflow flag [...])."""
    nc = forest.pos.shape[-2]
    dev = forest.pos.device
    lead = forest.n_nodes.shape

    def per_row(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).expand(lead)

    gamma, delta, d, faz_radius = (per_row(x)[..., None] for x in
                                   (gamma, delta, d, faz_radius))
    n_nodes = forest.n_nodes.long()[..., None]
    n_children = forest.n_children

    assigned = torch.where(sink_alive & (dist <= delta), idx.long(), -1)
    has_assign = assigned >= 0
    aidx = assigned.clamp(0, nc - 1)

    # node-level gathered tables (2 gathers), then one per-sink gather
    par = forest.parent.clamp(0, nc - 1)
    child = forest.first_child.clamp(0, nc - 1)
    pos_par = _take(forest.pos, par)                             # [..,NC,3]
    pc = torch.cat([forest.pos, forest.radius[..., None]], -1)
    pc_child = _take(pc, child)                                  # [..,NC,4]
    pos_child, r_child = pc_child[..., :3], pc_child[..., 3]

    node_tbl = torch.cat([
        forest.pos, pos_par, pos_child, r_child[..., None],
        n_children.float()[..., None],
        forest.is_root.float()[..., None]], -1)                  # [..,NC,12]
    stbl = _take(node_tbl, aidx)                                 # [..,Sq,12]
    npos = stbl[..., 0:3]
    v_prox = npos - stbl[..., 3:6]
    v_dist = stbl[..., 6:9] - npos
    nr_child = stbl[..., 9]
    n_nch = stbl[..., 10]
    n_isroot = stbl[..., 11] > 0.5

    att_vec = sink_pos - npos
    att_dir = _norm(att_vec)
    ang_prox = _angle_deg(v_prox, att_vec)
    ang_dist = _angle_deg(v_dist, att_vec)

    node_is_leaf = (n_nch == 0) & ~n_isroot
    node_is_inter = (n_nch == 1) & ~n_isroot

    # Murray angles per assigned node. A node without a child has
    # r_child = 0 and the quotient below is 0/0 = NaN: every comparison with
    # it is false and the selects discard it. Guarding it would change
    # decisions.
    r1_inter = nr_child
    rp_inter = (r1_inter ** kappa + r ** kappa) ** (1.0 / kappa)
    phi1_i = _acos_deg((_ipow(rp_inter, 4) + _ipow(r1_inter, 4) - r ** 4)
                       / (2 * _ipow(rp_inter, 2) * _ipow(r1_inter, 2)))
    phi2_i = _acos_deg((_ipow(rp_inter, 4) + r ** 4 - _ipow(r1_inter, 4))
                       / (2 * _ipow(rp_inter, 2) * r ** 2))

    leaf_ok = ang_prox <= (gamma / 2).clamp(min=0.0)
    inter_ok = ((phi1_i + phi2_i - gamma / 2 <= ang_dist)
                & (ang_dist <= phi1_i + phi2_i + gamma / 2)
                & (ang_prox <= phi2_i + gamma / 2))
    valid_sink = has_assign & torch.where(node_is_leaf, leaf_ok,
                                          node_is_inter & inter_ok)

    seg = torch.where(valid_sink, aidx, nc)  # target node (nc = dropped)

    # six segment sums fused into ONE 18-feature reduction (K3)
    sq = sink_pos.shape[-2]
    feats = torch.cat([
        torch.ones(*lead, sq, 1, device=dev), att_dir, ang_prox[..., None],
        (ang_prox * ang_prox)[..., None], sink_pos,
        (sink_pos[..., :, None] * sink_pos[..., None, :]).reshape(
            *lead, sq, 9),
    ], dim=-1)                                                    # [..,Sq,18]
    sums = segment_sum(seg.reshape(-1, sq), feats.reshape(-1, sq, 18),
                       nc).reshape(*lead, nc, 18)
    cnt = sums[..., 0]
    sum_dir = sums[..., 1:4]
    sum_ang = sums[..., 4]
    sum_ang2 = sums[..., 5]
    sum_att = sums[..., 6:9]
    sum_outer = sums[..., 9:18].reshape(*lead, nc, 3, 3)

    has = cnt > 0
    n = cnt.clamp(min=1.0)
    mean_ang = sum_ang / n
    std_ang = torch.sqrt((sum_ang2 / n - mean_ang * mean_ang).clamp(min=0.0))
    avg_attr = sum_dir  # unnormalized sum of unit vectors (reference)
    c_mean = sum_att / n[..., None]
    # covariance of (atts - c): reference divides by (n-1); direction-invariant
    M = sum_outer - n[..., None, None] * (c_mean[..., :, None]
                                          * c_mean[..., None, :])

    active = (n_children < 2) & (torch.arange(nc, device=dev) < n_nodes)
    is_leaf_n = (n_children == 0) & ~forest.is_root & active
    is_inter_n = (n_children == 1) & ~forest.is_root & active

    zeros_n = torch.zeros(*lead, nc, device=dev)
    vec_center = torch.cat([faz_center - forest.pos[..., :2],
                            zeros_n[..., None]], dim=-1)
    dist_center = _vnorm(vec_center[..., :2])
    ang_center_attr = _angle_deg(vec_center[..., :2], avg_attr[..., :2])

    faz_term = _ipow(dist_center / (2 * faz_radius + 1e-12), 5)
    bif_rand_ok = (faz_radius == 0) | ((faz_term > u_bif)
                                       & (ang_center_attr > 90.0))

    # ---- leaf bifurcation ----
    bifurcate = is_leaf_n & has & (std_ang > phi) & bif_rand_ok
    rp_leaf = (2.0 * r ** kappa) ** (1.0 / kappa)
    phi_leaf = torch.deg2rad(_acos_deg(torch.tensor(
        rp_leaf ** 2 / (2 * r ** 2), dtype=torch.float32)))
    cosp, sinp = torch.cos(phi_leaf).item(), torch.sin(phi_leaf).item()
    d_parent_c = _norm(c_mean - forest.pos)
    d_l = _power_iteration_3x3(M)
    dd = d[..., None]
    p_new_1 = forest.pos + _norm(cosp * d_parent_c + sinp * d_l) * dd
    p_new_2 = forest.pos + _norm(cosp * d_parent_c - sinp * d_l) * dd

    # ---- leaf elongation ----
    v_prox_n = forest.pos - pos_par
    g = omega * _norm(v_prox_n) + (1 - omega) * _norm(avg_attr)
    if rotation_radius > 0 and t > 15:
        gn = _norm(g)
        center_vec = _norm(vec_center)
        new_pos_tmp = forest.pos + dd * gn
        dist_new = _vnorm(faz_center - new_pos_tmp[..., :2])
        floor = 0.0 if first_mode else 0.01
        weight = torch.sqrt((rotation_radius - dist_new).clamp(min=floor))
        ort = torch.stack([-center_vec[..., 1], center_vec[..., 0], zeros_n],
                          dim=-1)
        flip = _angle_deg(gn[..., :2], ort[..., :2]) > 90.0
        ort = torch.where(flip[..., None], -ort, ort)
        out_vec = torch.stack([-center_vec[..., 0], -center_vec[..., 1],
                               zeros_n], dim=-1)
        g = ((1 - weight)[..., None] * gn + 0.7 * weight[..., None] * ort
             + 0.3 * weight[..., None] * out_vec)
    p_elong = forest.pos + dd * _norm(g)
    elongate = is_leaf_n & has & ~bifurcate

    # ---- inter-node sprouting (Rodrigues) ----
    distal = _norm(pos_child - forest.pos)
    cross = _cross(distal, avg_attr)
    cross_zero = (cross == 0.0).all(-1)
    sprout_rand_skip = ((faz_term <= u_sprout)
                        & (ang_center_attr <= 90.0)) & (faz_radius != 0)
    sprout = is_inter_n & has & ~cross_zero & ~sprout_rand_skip
    rot_axis = _norm(cross)
    r1_n = r_child
    rp_n = (r1_n ** kappa + r ** kappa) ** (1.0 / kappa)
    phi2_n = _acos_deg((_ipow(rp_n, 4) + r ** 4 - _ipow(r1_n, 4))
                       / (2 * _ipow(rp_n, 2) * r ** 2))
    v_rot = _rodrigues(distal, rot_axis, phi2_n)
    g_s = omega * _norm(v_rot) + (1 - omega) * _norm(avg_attr)
    p_sprout = forest.pos + dd * _norm(g_s)

    # ---- emit new nodes ----
    # New nodes land in the contiguous window [n_nodes, n_nodes+total_new):
    # for each window slot j the source node is searchsorted(cumsum(n_emit),
    # j), every per-slot value is a gather, and one scatter at n_nodes + j
    # into an array padded by new_cap rows writes the window.
    new_cap = min(new_cap, nc)
    n_emit_raw = 2 * bifurcate.long() + elongate.long() + sprout.long()
    cum_raw = torch.cumsum(n_emit_raw, -1)
    fits = ((n_nodes + cum_raw) <= nc) & (cum_raw <= new_cap)
    # window overflow -> segment redo with a bigger window; once the window
    # equals node capacity a bigger window cannot help, so don't signal
    if new_cap < nc:
        sat = cum_raw[..., -1] > new_cap
    else:
        sat = torch.zeros(lead, dtype=torch.bool, device=dev)
    n_emit = torch.where(fits, n_emit_raw, 0)
    cum = torch.cumsum(n_emit, -1)
    offs = n_nodes + cum - n_emit
    total_new = cum[..., -1:]

    first_pos = torch.where(bifurcate[..., None], p_new_1,
                            torch.where(elongate[..., None], p_elong,
                                        p_sprout))
    emit1 = n_emit >= 1

    j = torch.arange(new_cap, device=dev)
    src = _count_before(cum, new_cap).clamp(0, nc - 1)
    valid = j < total_new
    rank2 = (j - (_take(cum, src) - _take(n_emit, src))) == 1  # 2nd bif. child
    win_pos = torch.where(rank2[..., None], _take(p_new_2, src),
                          _take(first_pos, src))
    slot = n_nodes + j                                          # [.., new_cap]

    def _append(arr, vals, fill):
        two_d = arr.dim() > slot.dim()
        pad = (0, 0, 0, new_cap) if two_d else (0, new_cap)
        ext = torch.nn.functional.pad(arr, pad, value=fill)
        at = slot[..., None].expand(*slot.shape, arr.shape[-1]) if two_d \
            else slot
        dim = -2 if two_d else -1
        old = torch.gather(ext, dim, at)
        upd = torch.where(valid[..., None] if two_d else valid,
                          vals.to(arr.dtype), old)
        return ext.scatter(dim, at, upd).narrow(dim, 0, nc)

    ones_w = torch.ones(*lead, new_cap, device=dev)
    pos = _append(forest.pos, win_pos, 0.0)
    radius = _append(forest.radius, ones_w * r, 0.0)
    parent = _append(forest.parent, src, -1)
    # new nodes carry the current mode's kappa; their parent's kappa is
    # frozen at the parent's creation
    kap = _append(forest.kappa, ones_w * kappa, 4.0)
    pkap = _append(forest.pkappa, _take(forest.kappa, src), 4.0)

    # child pointers / counts are per-source-node -> pure elementwise
    set_fc = emit1 & (n_children == 0)
    first_child = torch.where(set_fc, offs.to(torch.int32),
                              forest.first_child)
    n_children = n_children + n_emit.to(torch.int32)
    n_nodes_new = forest.n_nodes + total_new[..., 0].to(torch.int32)

    new_forest = ForestState(pos, radius, parent, first_child, n_children,
                             forest.is_root, n_nodes_new, kap, pkap)
    new_forest = murray_sweep(new_forest, murray_sweeps)
    return new_forest, sat


def murray_sweep(forest: ForestState, sweeps: int,
                 exact: bool | None = None) -> ForestState:
    """``sweeps`` parallel Murray-law radius relaxation sweeps: each sweep
    recomputes every internal node's radius from its children, r_p =
    (sum r_c^kappa_p)^(1/kappa_p) with kappa_p the PARENT node's
    creation-mode kappa, propagating changes one level root-ward per sweep.

    The per-parent child sum is a 1-feature segment sum (K3): on a CUDA
    tensor the in-loop sweeps launch the kernel, on a CPU tensor they take
    its plain version. ``exact=True`` (the final deep convergence sweep)
    takes the plain scatter-add on either device, as the JAX package does.
    Each parent has at most two children, so any order of adding gives the
    same bits.

    The radii have a UNIQUE fixed point given the tree (leaf radii are
    pinned at r), so the deep final sweep after growth recovers the
    converged radii regardless of how much in-loop sweeping lagged."""
    nc = forest.pos.shape[-2]
    lead = forest.n_nodes.shape
    summer = segment_sum_plain if exact else segment_sum
    exists = (torch.arange(nc, device=forest.pos.device)
              < forest.n_nodes[..., None])
    # each child contributes radius^(parent's kappa); pkappa was frozen at
    # creation so no per-sweep gather is needed
    par_t = torch.where(exists & (forest.parent >= 0), forest.parent,
                        nc).reshape(-1, nc)
    is_internal = (forest.n_children >= 1) & ~forest.is_root & exists
    inv_kappa = 1.0 / forest.kappa
    radius = forest.radius
    for _ in range(sweeps):
        rk = torch.where(exists, radius ** forest.pkappa, 0.0)
        child_sum = summer(par_t, rk.reshape(-1, nc, 1), nc).reshape(
            *lead, nc)
        radius = torch.where(is_internal, child_sum ** inv_kappa, radius)
    return forest._replace(radius=radius)


# ---------------------------------------------------------------------------
# One iteration, one mode
# ---------------------------------------------------------------------------

def _iteration(state: StackedState, mp: ModeParams, i: int, t: int, *,
               param_scale, r0, rotation_radius, faz_center, size_z,
               n_cand, murray_sweeps=8, nerve_center=None,
               nerve_radius=0.0, geometry=None, new_cap=1024,
               draws: IterationDraws | None = None,
               generator: torch.Generator | None = None,
               banded: bool = False) -> StackedState:
    """One greenhouse iteration for a batch ``[B]`` of samples, with both
    forests grown in one stacked pass.

    ``i`` is the within-mode index: at i == 0 the raw mode parameters apply;
    afterwards params = raw/(param_scale*sigma). ``draws`` are the
    iteration's random numbers; when absent they come from ``generator``.
    ``banded`` takes three of the four nearest scans through K5.

    Scheduling vs the reference: candidates accepted at step 1 participate
    in arterial growth and the satisfied-sink check of the same iteration,
    but venous growth sees the CO2 set from *before* this iteration's
    conversions."""
    F, S = state.forests, state.sinks
    bsz, _, nc = F.radius.shape
    sc = S.pos.shape[2]
    dev = F.pos.device
    if draws is None:
        gsize = GEOMETRY_SIZE if geometry is None else max(geometry.shape)
        draws = draw_iteration(generator, bsz, n_cand, nc, gsize, dev)

    if i == 0:
        denom = torch.ones_like(state.sigma_t)
        d = state.d_start
    else:
        denom = param_scale * state.sigma_t
        d = (state.d_start / state.sigma_t).clamp(min=0.04 / param_scale)
    eps_n = mp.eps_n / denom                                      # [B]
    eps_s = mp.eps_s / denom
    eps_k = mp.eps_k / denom
    delta = torch.stack([mp.delta_art / denom, mp.delta_ven / denom], -1)

    exists = torch.arange(nc, device=dev) < F.n_nodes[..., None]  # [B,2,NC]
    active = (F.n_children < 2) & exists

    # --- 1a. sample oxygen-sink candidates ---
    cand, valid = _sample_candidates(
        draws.vox, draws.jitter, faz_center, state.faz_radius, size_z,
        nerve_center=nerve_center, nerve_radius=nerve_radius,
        geometry=geometry)
    if banded:
        # y-sort the candidates so that their query tiles are spatially
        # coherent in every banded scan below. The blocked greedy spacing is
        # order-sensitive, so it runs in the ORIGINAL sample order through
        # `order` and its inverse; only the distance scans see the sorted
        # layout.
        order = torch.argsort(cand[..., 1], dim=-1, stable=True)  # [B,N]
        inv_order = torch.empty_like(order).scatter_(
            -1, order, torch.arange(cand.shape[1], device=dev).expand_as(order))
        cand = _take(cand, order)
        valid = _take(valid, order)

    # --- fused nearest-neighbour pass (K2, or K5 when banded). Call 1,
    # rows = (0) [oxy;cand]
    # -> art active (growth assignment), (1) [oxy;cand] -> ven existing
    # (CO2-eligibility distance), (2) [co2;cand] -> ven active (venous
    # assignment); call 2 = candidates -> art existing (candidate rejection),
    # which only needs the candidate suffix ---
    q01 = torch.cat([S.pos[:, 0], cand], dim=1)                   # [B,Sq,3]
    q2 = torch.cat([S.pos[:, 1], cand], dim=1)
    sq = q01.shape[1]
    q = torch.stack([q01, q01, q2], 1)                            # [B,3,Sq,3]
    pts = torch.stack([F.pos[:, 0], F.pos[:, 1], F.pos[:, 1]], 1)
    mask1 = torch.stack([active[:, 0], exists[:, 1], active[:, 1]], 1)
    if banded:
        # every consumer of these rows is gated on a radius bound (row 0:
        # dist <= delta_art in _grow_core; row 1: dd[:, 1] > eps_k in the CO2
        # conversion; row 2: dist <= delta_ven), so skipping point chunks
        # beyond the per-row band is exact. Query aliveness mirrors the
        # downstream gates: sink rows use the alive masks; the candidate
        # suffix is consumed (through `accept`) on rows 0-1, never on row 2.
        ones_c = torch.ones(cand.shape[:2], dtype=torch.bool, device=dev)
        alive01 = torch.cat([S.alive[:, 0], ones_c], 1)
        alive_q = torch.stack(
            [alive01, alive01,
             torch.cat([S.alive[:, 1], torch.zeros_like(ones_c)], 1)], 1)
        band = torch.stack([delta[:, 0], eps_k, delta[:, 1]], 1)   # [B,3]
        dd, ii = masked_nearest_banded(
            q.reshape(3 * bsz, sq, 3), pts.reshape(3 * bsz, nc, 3),
            mask1.reshape(3 * bsz, 1, nc), alive_q.reshape(3 * bsz, sq),
            band.reshape(3 * bsz))
        # candidate rejection is gated on d <= max(eps_n, eps_k) (and on the
        # nearest trunk's oxygen radius, which only matters when that
        # already holds), so it bands exactly too
        d_cand_art, i_cand_art = masked_nearest_banded(
            cand, F.pos[:, 0], exists[:, 0, None], ones_c,
            torch.maximum(eps_n, eps_k))
    else:
        dd, ii = masked_nearest(q.reshape(3 * bsz, sq, 3),
                                pts.reshape(3 * bsz, nc, 3),
                                mask1.reshape(3 * bsz, 1, nc))
        d_cand_art, i_cand_art = masked_nearest(cand, F.pos[:, 0],
                                                exists[:, 0, None])
    dd, ii = dd.reshape(bsz, 3, sq), ii.reshape(bsz, 3, sq)
    d_cand_art, i_cand_art = d_cand_art[:, 0], i_cand_art[:, 0]

    # --- 1b. candidate filtering ---
    # reject near arterial nodes (within eps_n AND inside the oxygen radius)
    i_cand_art = i_cand_art.clamp(0, nc - 1)
    oxy_d = _oxygen_distance(_take(F.radius[:, 0], i_cand_art), param_scale)
    near_bad = ((d_cand_art <= torch.maximum(eps_n, eps_k)[:, None])
                & (d_cand_art <= oxy_d))
    valid = valid & ~near_bad
    # reject near existing oxygen sinks
    if banded:
        # consumed only through `d_oxy > eps_s`, so an eps_s band is exact;
        # the sink array's alive prefix is y-sorted between restages
        d_oxy = masked_nearest_banded(
            cand, S.pos[:, 0], S.alive[:, 0, None], ones_c, eps_s,
            want_idx=False)[:, 0]
    else:
        d_oxy = masked_nearest(cand, S.pos[:, 0], S.alive[:, 0, None],
                               want_idx=False)[:, 0]
    valid = valid & (d_oxy > eps_s[:, None])
    # mutual spacing (blocked greedy), in the original sample order
    if banded:
        accept = _take(_blocked_greedy_spacing(
            _take(cand, inv_order), _take(valid, inv_order), eps_s), order)
    else:
        accept = _blocked_greedy_spacing(cand, valid, eps_s)

    # --- 2+4. stacked growth: arterial on [oxy; accepted cand], venous on
    # [co2; -] ---
    view_alive = torch.stack([
        torch.cat([S.alive[:, 0], accept], 1),
        torch.cat([S.alive[:, 1], torch.zeros_like(accept)], 1)], 1)
    view_pos = torch.stack([q01, q2], 1)                          # [B,2,Sq,3]
    gamma = torch.where(torch.arange(2, device=dev) == 0,
                        float(mp.gamma_art), float(mp.gamma_ven))
    newF, sat = _grow_core(
        F, view_pos, view_alive, torch.stack([dd[:, 0], dd[:, 2]], 1),
        torch.stack([ii[:, 0], ii[:, 2]], 1), gamma=gamma,
        delta=delta, d=d[:, None], r=r0, kappa=mp.kappa, phi=mp.phi,
        omega=mp.omega, faz_center=faz_center,
        faz_radius=state.faz_radius[:, None],
        rotation_radius=rotation_radius, first_mode=mp.first_mode, t=t,
        u_bif=draws.u_bif, u_sprout=draws.u_sprout,
        murray_sweeps=murray_sweeps, new_cap=new_cap)

    # --- 3+5. satisfied sinks (within eps_k of this iteration's new nodes).
    # New nodes are a dense window [n_nodes_old, n_nodes_new): gather it
    # (from an array padded so a near-capacity window stays in range)
    # instead of distance-scanning the whole node array ---
    k_new = min(new_cap, nc)
    jw = torch.arange(k_new, device=dev)
    win_pos = _take(torch.nn.functional.pad(newF.pos, (0, 0, 0, k_new)),
                    F.n_nodes.long()[..., None] + jw)             # [B,2,K,3]
    win_valid = jw < (newF.n_nodes - F.n_nodes)[..., None]
    d_new = masked_nearest(
        view_pos.reshape(2 * bsz, sq, 3), win_pos.reshape(2 * bsz, k_new, 3),
        win_valid.reshape(2 * bsz, 1, k_new),
        want_idx=False).reshape(bsz, 2, sq)
    satisfied = view_alive & (d_new <= eps_k[:, None, None])
    # oxygen sinks satisfied by new arterial nodes convert to CO2 when no
    # venous node (pre-growth, as in the reference) is within eps_k
    to_co2 = satisfied[:, 0] & (dd[:, 1] > eps_k[:, None])

    base = SinkState(S.pos, S.alive & ~satisfied[:, :, :sc])
    # one stacked append: row 0 stores surviving new candidates as oxygen
    # sinks, row 1 stores converted CO2 sources (from oxy slots or new cands)
    acc0 = torch.cat([torch.zeros(bsz, sc, dtype=torch.bool, device=dev),
                      accept & ~satisfied[:, 0, sc:]], 1)
    props = torch.stack([q01, q01], 1)
    # append window doubles with the emission cap from 2048 so the first
    # ecap doubling already enlarges it
    newS, sat_win, sat_cap = _append_sinks(
        base, props, torch.stack([acc0, to_co2], 1),
        max_append=max(2048, 2 * new_cap), tail_first=banded)

    # --- 6. simulation space expansion ---
    sigma = state.sigma_t + mp.delta_sigma
    d_cur = (state.d_start / sigma).clamp(min=0.04 / param_scale)

    sat_bits = ((sat.any(-1) | sat_win.any(-1)).to(torch.int32)
                + 2 * sat_cap.any(-1).to(torch.int32))
    return StackedState(newF, newS, sigma, d_cur, state.d_start,
                        state.faz_radius, state.sat | sat_bits)


def run_mode(state: GrowthState, mp: ModeParams, t0: int, *, param_scale,
             r0, rotation_radius, faz_center, size_z, murray_sweeps=8,
             collect_stats: bool = False, i0: int = 0,
             seg_len: int | None = None, nerve_center=None,
             nerve_radius=0.0, geometry=None, new_cap=1024,
             generator: torch.Generator | None = None, draws=None,
             banded: bool = False):
    """Run iterations ``i0 .. i0+seg_len`` of one mode on a batch ``[B]``.
    Sigma resets to 1 at mode entry (i0 == 0) and ``d`` continues
    (compounds) from the previous mode. Segmenting (i0 > 0) lets
    ``develop_forest`` grow the node capacity between segments.

    Random numbers come from ``generator``, or from ``draws``, a sequence
    of one :class:`IterationDraws` per iteration. With ``collect_stats``
    also returns per-iteration counters [B, seg_len, 5] (node counts, alive
    sink counts, sigma)."""
    seg_len = mp.I if seg_len is None else seg_len
    if i0 == 0:
        state = state._replace(sigma_t=torch.ones_like(state.sigma_t),
                               d_start=state.d_cur)
    st = _stack_state(state)
    stats = []
    for k in range(seg_len):
        i = i0 + k
        st = _iteration(
            st, mp, i, t0 + i, param_scale=param_scale, r0=r0,
            rotation_radius=rotation_radius, faz_center=faz_center,
            size_z=size_z, n_cand=int(mp.N), murray_sweeps=murray_sweeps,
            nerve_center=nerve_center, nerve_radius=nerve_radius,
            geometry=geometry, new_cap=new_cap,
            draws=None if draws is None else draws[k], generator=generator,
            banded=banded)
        if collect_stats:
            n_alive = st.sinks.alive.sum(-1)
            stats.append(torch.stack([
                st.forests.n_nodes[:, 0].float(),
                st.forests.n_nodes[:, 1].float(),
                n_alive[:, 0].float(), n_alive[:, 1].float(),
                st.sigma_t], -1))
    state = _unstack_state(st)
    return (state, torch.stack(stats, 1)) if collect_stats else state


# ---------------------------------------------------------------------------
# Forest initialization + Greenhouse
# ---------------------------------------------------------------------------

def _forest_from_host(pos, radius, parent, first_child, n_children, is_root,
                      n, kap, device) -> ForestState:
    def t(x):
        return torch.from_numpy(x).to(device)

    return ForestState(t(pos), t(radius), t(parent), t(first_child),
                       t(n_children), t(is_root),
                       torch.tensor(n, dtype=torch.int32, device=device),
                       t(kap), t(kap.copy()))


def init_forest_stumps(rng: np.random.Generator, n_trees: int,
                       source_walls: list[str], d0: float, r0: float,
                       sizes: tuple[float, float, float],
                       node_capacity: int, device="cpu") -> ForestState:
    """'stumps' initialization: tree roots on the lateral faces of the
    cuboid, first segment pointing inward. Host-side numpy (tiny); the same
    ``rng`` gives the same forest as the JAX package."""
    sx, sy, sz = sizes
    pos = np.zeros((node_capacity, 3), np.float32)
    radius = np.zeros((node_capacity,), np.float32)
    parent = np.full((node_capacity,), -1, np.int32)
    first_child = np.full((node_capacity,), -1, np.int32)
    n_children = np.zeros((node_capacity,), np.int32)
    is_root = np.zeros((node_capacity,), bool)
    # stump/root nodes carry the reference Node's default kappa=4
    kap = np.full((node_capacity,), 4.0, np.float32)
    i = 0
    for _ in range(n_trees):
        wall = source_walls[int(rng.integers(0, len(source_walls)))]
        ax = {"x": 0, "y": 1, "z": 2}[wall[0]]
        hi = wall[1] == "1"
        other = [a for a in range(3) if a != ax]
        sizes_arr = np.array([sx, sy, sz])
        p = np.zeros(3)
        p[ax] = sizes_arr[ax] - 1e-6 if hi else 0.0
        p[other[0]] = rng.uniform(0, sizes_arr[other[0]])
        p[other[1]] = rng.uniform(0, sizes_arr[other[1]])
        direction = np.zeros(3)
        direction[ax] = rng.uniform(-1, -0.1) if hi else rng.uniform(0.1, 1)
        for o in other:
            lo_ok = p[o] - d0 > 0
            hi_ok = p[o] + d0 < sizes_arr[o]
            direction[o] = rng.uniform(-1 if lo_ok else 0, 1 if hi_ok else 0)
        direction = direction / np.linalg.norm(direction) * d0
        # root
        pos[i] = p
        radius[i] = r0
        is_root[i] = True
        n_children[i] = 1
        first_child[i] = i + 1
        # stump node
        pos[i + 1] = p + direction
        radius[i + 1] = r0
        parent[i + 1] = i
        i += 2
    return _forest_from_host(pos, radius, parent, first_child, n_children,
                             is_root, i, kap, device)


def init_forest_nerve(rng: np.random.Generator, n_trees: int, d0: float,
                      r0: float, nerve_center: np.ndarray,
                      nerve_radius: float, size_z: float,
                      node_capacity: int, device="cpu") -> ForestState:
    """'nerve' initialization: every tree root packed inside the optic-nerve
    disc (uniform over the disc via sqrt-radius sampling), z uniform over
    the slab, first segment a random in-plane (z=0) unit direction scaled by
    d0. The reference swaps the center components (x uses nerve_center[1],
    y uses nerve_center[0]); replicated for parity. Host-side numpy."""
    pos = np.zeros((node_capacity, 3), np.float32)
    radius = np.zeros((node_capacity,), np.float32)
    parent = np.full((node_capacity,), -1, np.int32)
    first_child = np.full((node_capacity,), -1, np.int32)
    n_children = np.zeros((node_capacity,), np.int32)
    is_root = np.zeros((node_capacity,), bool)
    kap = np.full((node_capacity,), 4.0, np.float32)
    i = 0
    for _ in range(n_trees):
        alpha = 2 * np.pi * rng.random()
        rr = nerve_radius * np.sqrt(rng.random())
        p = np.array([rr * np.cos(alpha) + nerve_center[1],
                      rr * np.sin(alpha) + nerve_center[0],
                      rng.random() * size_z])
        direction = np.array([rng.random() - 0.5, rng.random() - 0.5, 0.0])
        direction = direction / np.linalg.norm(direction) * d0
        pos[i] = p
        radius[i] = r0
        is_root[i] = True
        n_children[i] = 1
        first_child[i] = i + 1
        pos[i + 1] = p + direction
        radius[i + 1] = r0
        parent[i + 1] = i
        i += 2
    return _forest_from_host(pos, radius, parent, first_child, n_children,
                             is_root, i, kap, device)


class Greenhouse:
    """Config-driven growth, batched: ``develop_forest(batch)`` grows
    ``batch`` independent samples together on ``device`` (the card unless
    the caller asks for ``"cpu"``). ``banded`` selects the banded
    configuration (K5 scans, y-sorted staging); the default is off."""

    #: iterations per capacity-staging segment
    SEG_LEN = 50

    def __init__(self, config: dict, node_capacity: int = 16384,
                 sink_capacity: int = 32768, seed: int = 0,
                 device="cuda", banded: bool = False):
        self.device = resolve_device(device)
        self.banded = banded
        self.config = config
        self.param_scale = config["param_scale"]
        self.d = config["d"] / self.param_scale
        self.r = config["r"] / self.param_scale
        self.faz_bound = (config["FAZ_radius_bound"][0] / self.param_scale,
                          config["FAZ_radius_bound"][1] / self.param_scale)
        self.rotation_radius = config["rotation_radius"] / self.param_scale
        self.faz_center = np.asarray(config["FAZ_center"], np.float32)
        self._faz_center = torch.from_numpy(self.faz_center).to(self.device)
        ss = config["SimulationSpace"]
        self.geometry = None
        self.nerve_center = None
        self.nerve_radius = 0.0
        if ss.get("oxygen_sample_geometry_path"):
            geo = np.load(ss["oxygen_sample_geometry_path"])
            gs = max(geo.shape)
            self.sizes = tuple(np.array(geo.shape) / gs)
            self.geometry = torch.from_numpy(
                np.squeeze(np.asarray(geo, bool), axis=-1)
                if geo.ndim == 3 else np.asarray(geo, bool)).to(self.device)
        else:
            self.sizes = (ss["no_voxel_x"], ss["no_voxel_y"], ss["no_voxel_z"])
            # optic-nerve disc carving from the sampling geometry: active
            # when the disc intersects the unit simulation space
            if "nerve_center" in config and "nerve_radius" in config:
                nc = np.asarray(config["nerve_center"],
                                np.float32) / self.param_scale
                nr = float(config["nerve_radius"]) / self.param_scale
                if np.all(nc - nr <= 1.0):
                    self.nerve_center = torch.from_numpy(nc).to(self.device)
                    self.nerve_radius = nr
        self.node_capacity = node_capacity
        self.sink_capacity = sink_capacity
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        #: one entry per segment run (redone ones included) of the last
        #: ``develop_forest``: mode, i0, seg_len, cap, scap, ecap, accepted
        self.stage_log: list[dict] = []
        #: device -> host reads made by the last ``develop_forest``
        self.host_syncs = 0
        self.modes = [
            ModeParams(
                I=m["I"], N=m["N"],
                eps_n=m["eps_n"], eps_s=m["eps_s"], eps_k=m["eps_k"],
                delta_art=m["delta_art"], delta_ven=m["delta_ven"],
                gamma_art=m["gamma_art"], gamma_ven=m["gamma_ven"],
                phi=m["phi"], omega=m["omega"], kappa=m["kappa"],
                delta_sigma=m["delta_sigma"], first_mode=(i == 0))
            for i, m in enumerate(config["modes"])
        ]

    def init_state(self, forest_config: dict, rng_seed: int,
                   node_capacity: int | None = None,
                   sink_capacity: int | None = None) -> GrowthState:
        """One sample's initial state (no batch axis), equal to the JAX
        package's for the same ``rng_seed``."""
        rng = np.random.default_rng(rng_seed)
        dev = self.device
        ftype = forest_config.get("type", "stumps")
        cap = node_capacity or self.node_capacity
        if ftype == "stumps":
            walls = [k for k, v in forest_config["source_walls"].items() if v]
            art = init_forest_stumps(rng, forest_config["N_trees"], walls,
                                     self.d, self.r, self.sizes, cap, dev)
            ven = init_forest_stumps(rng, forest_config["N_trees"], walls,
                                     self.d, self.r, self.sizes, cap, dev)
        elif ftype == "nerve":
            # the raw config values / param_scale, independent of the
            # geometry carve gate
            if ("nerve_center" not in self.config
                    or "nerve_radius" not in self.config):
                raise ValueError(
                    "forest type 'nerve' needs Greenhouse.nerve_center and "
                    "Greenhouse.nerve_radius in the config")
            nc = (np.asarray(self.config["nerve_center"], np.float32)
                  / self.param_scale)
            nr = float(self.config["nerve_radius"]) / self.param_scale
            art = init_forest_nerve(rng, forest_config["N_trees"], self.d,
                                    self.r, nc, nr, self.sizes[2], cap, dev)
            ven = init_forest_nerve(rng, forest_config["N_trees"], self.d,
                                    self.r, nc, nr, self.sizes[2], cap, dev)
        else:
            raise NotImplementedError(
                f"forest initialization type {ftype!r} is not implemented; "
                "use 'stumps' or 'nerve'")
        sc = sink_capacity or self.sink_capacity

        def empty():
            return SinkState(torch.zeros(sc, 3, device=dev),
                             torch.zeros(sc, dtype=torch.bool, device=dev))

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        faz_r = rng.normal(self.faz_bound[0], self.faz_bound[1])
        return GrowthState(
            art, ven, empty(), empty(), f32(1.0), f32(self.d), f32(self.d),
            f32(max(faz_r, 0.0)),
            torch.tensor(0, dtype=torch.int32, device=dev))

    def _read(self, *scalars) -> list[float]:
        """One device -> host read of a few scalar tensors."""
        self.host_syncs += 1
        return torch.stack([s.float() for s in scalars]).cpu().tolist()

    def develop_forest(self, forest_config: dict, batch: int = 1,
                       murray_sweeps: int = 4, collect_stats: bool = False,
                       final_murray_sweeps: int = 256, mesh=None):
        """Grow ``batch`` samples with **capacity staging**: the growth
        loop's dominant cost is distance computation against the node array,
        which scales with the capacity, not the live node count. The run is
        split into SEG_LEN-iteration segments; before each segment the node
        arrays are padded to a capacity forecast from the observed growth
        rate (one small host read per segment), and a saturated segment is
        transparently re-run at doubled capacity from its entry state and
        the generator state saved there, so no result comes from a
        truncated segment.

        ``murray_sweeps`` Murray radius sweeps run per growth iteration;
        ``final_murray_sweeps`` deep sweeps run ONCE at the end, converging
        the radii to their exact fixed point for the final tree.

        The generator is seeded with ``self.seed`` here, so two calls from
        the same seed grow from the same random numbers.

        ``mesh`` (the JAX package's sharding of the batch over several
        devices) is not ported: anything but None raises."""
        if mesh is not None:
            raise NotImplementedError(
                "develop_forest(mesh=...) is not ported: the batch grows on "
                "one device")
        self.generator.manual_seed(self.seed)
        self.stage_log = []
        self.host_syncs = 0
        cap0 = _pow2ceil(max(
            1024, 4 * forest_config.get("N_trees", 8) + 64 * self.SEG_LEN))
        states = [self.init_state(forest_config, self.seed + i,
                                  node_capacity=min(cap0, self.node_capacity),
                                  sink_capacity=min(2048, self.sink_capacity))
                  for i in range(batch)]
        state = _tree_map(lambda *xs: torch.stack(xs), *states)

        segments = []
        t0 = 0
        for mi, mp in enumerate(self.modes):
            for i0 in range(0, mp.I, self.SEG_LEN):
                segments.append((mi, t0, i0, min(self.SEG_LEN, mp.I - i0)))
            t0 += mp.I
        all_stats = []
        slope = 64.0    # nodes/iteration forecast, refined per segment
        s_slope = 48.0  # alive-sinks/iteration forecast, refined per segment
        ecap = 1024     # per-iteration emission-window cap (staged like NC)

        def counters(s: GrowthState):
            return (torch.maximum(s.art.n_nodes, s.ven.n_nodes).max(),
                    (s.oxy.alive.sum(-1) + s.co2.alive.sum(-1)).max())

        n_now, s_now = self._read(*counters(state))
        for mi, t0, i0, seg_len in segments:
            redos = 0
            gen_state = self.generator.get_state()
            while True:
                # 2048-granular capacities (not pow2: the distance scans,
                # Murray sweeps and segment sums all scale with capacity)
                cap = int(n_now + slope * seg_len * 1.8) + 64
                cap = _pow2ceil(cap) if cap <= 2048 else -(-cap // 2048) * 2048
                cap = min(max(cap, 1024), self.node_capacity)
                # sink capacity staged the same way: the nearest scans,
                # segment sums and gathers all scale with sc + n_cand
                scap = int(s_now + s_slope * seg_len * 1.8) + 256
                scap = (_pow2ceil(scap) if scap <= 2048
                        else -(-scap // 2048) * 2048)
                scap = min(max(scap, 1024), self.sink_capacity)
                seg_state = _resize_sinks(_resize_forests(state, cap), scap)
                if self.banded:
                    # y-sort node slots, compact and y-sort sink slots, so
                    # that the chunks' y-ranges are narrow for the whole
                    # segment (in-segment appends land at the tail and
                    # degrade only their own chunks to full scans)
                    seg_state = _restage_spatial(seg_state)
                # clear saturation bits at segment entry: ``sat`` is OR-
                # accumulated, and a sticky bit from an earlier segment
                # would trigger spurious redos in every later one
                seg_state = seg_state._replace(
                    sat=torch.zeros_like(seg_state.sat))
                # a redo starts from the segment's generator state
                self.generator.set_state(gen_state)
                out = self._run_segment(seg_state, mi, t0, i0, seg_len,
                                        murray_sweeps, collect_stats, ecap)
                new_state, stats = out if collect_stats else (out, None)
                sat1, sat2, n_after, s_after = self._read(
                    (new_state.sat & 1).max(), (new_state.sat & 2).max(),
                    *counters(new_state))
                sat = int(sat1) | int(sat2)
                entry = {"mode": mi, "i0": i0, "seg_len": seg_len,
                         "cap": cap, "scap": scap, "ecap": ecap,
                         "nodes": n_after, "alive": s_after,
                         "accepted": False}
                self.stage_log.append(entry)
                redos += 1
                if redos > 16:
                    raise RuntimeError(
                        "develop_forest: capacity-staging redo did not "
                        f"converge (sat={sat}, ecap={ecap}, scap={scap}, "
                        f"cap={cap}) — raise node_capacity/sink_capacity")
                if (sat & 1) and ecap < self.node_capacity:
                    # emission/append window overflowed: redo, bigger
                    ecap = min(ecap * 2, self.node_capacity)
                    continue
                if (sat & 2) and scap < self.sink_capacity:
                    # sink array saturated: redo with a larger forecast
                    s_slope = max(s_slope * 2.0, 2.0 * (scap - s_now)
                                  / max(seg_len, 1))
                    continue
                if n_after >= cap - 2 and cap < self.node_capacity:
                    slope *= 2.0  # saturated: redo the segment, bigger
                    continue
                # accepting with saturation bits set means ecap/scap are
                # already AT their ceilings: the segment truncated work an
                # unbounded run would have kept. Never silent — warn.
                node_full = n_after >= cap - 2 and cap >= self.node_capacity
                if sat or node_full:
                    trunc = []
                    if sat & 1:
                        trunc.append(f"emission window (ecap={ecap})")
                    if sat & 2:
                        trunc.append(f"sink array (scap={scap})")
                    if node_full:
                        trunc.append(f"node array (n={n_after:.0f})")
                    _warnings.warn(
                        "develop_forest: capacity ceiling reached — "
                        f"{', '.join(trunc)} truncated at node_capacity="
                        f"{self.node_capacity}, sink_capacity="
                        f"{self.sink_capacity}; results now diverge from an"
                        " unbounded run. Raise Greenhouse(node_capacity=..."
                        ", sink_capacity=...).",
                        RuntimeWarning, stacklevel=2)
                break
            entry["accepted"] = True
            slope = max(24.0, (n_after - n_now) / seg_len)
            n_now = n_after
            s_slope = max(16.0, (s_after - s_now) / seg_len)
            s_now = s_after
            state = new_state
            if collect_stats:
                all_stats.append(stats)
        if final_murray_sweeps:
            state = self._final_murray(state, final_murray_sweeps)
        if collect_stats:
            return state, torch.cat(all_stats, dim=1)
        return state

    def save_stats(self, *args, **kwargs):
        """The JAX package's per-iteration plots; not ported (they need
        matplotlib)."""
        raise NotImplementedError(
            "Greenhouse.save_stats is not ported (it plots with matplotlib); "
            "develop_forest(collect_stats=True) returns the counters")

    def _final_murray(self, state: GrowthState, sweeps: int) -> GrowthState:
        """Converge both forests' radii to the exact Murray fixed point of
        the final trees, with the exact scatter-add on either device."""
        return state._replace(art=murray_sweep(state.art, sweeps, exact=True),
                              ven=murray_sweep(state.ven, sweeps, exact=True))

    def _run_segment(self, state: GrowthState, mode_idx: int, t0: int,
                     i0: int, seg_len: int, murray_sweeps: int,
                     collect_stats: bool, new_cap: int = 1024):
        return run_mode(
            state, self.modes[mode_idx], t0, param_scale=self.param_scale,
            r0=self.r, rotation_radius=self.rotation_radius,
            faz_center=self._faz_center, size_z=self.sizes[2],
            murray_sweeps=murray_sweeps,
            collect_stats=collect_stats, i0=i0, seg_len=seg_len,
            nerve_center=self.nerve_center, nerve_radius=self.nerve_radius,
            geometry=self.geometry, new_cap=new_cap,
            generator=self.generator, banded=self.banded)


def _tree_map(fn, *states: GrowthState) -> GrowthState:
    """``fn`` over the corresponding leaves of growth states."""
    def sub(cls, parts):
        return cls(*(fn(*xs) for xs in zip(*parts)))

    return GrowthState(
        sub(ForestState, [s.art for s in states]),
        sub(ForestState, [s.ven for s in states]),
        sub(SinkState, [s.oxy for s in states]),
        sub(SinkState, [s.co2 for s in states]),
        *(fn(*xs) for xs in zip(*(s[4:] for s in states))))


def _pow2ceil(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def _ysort_forest(f: ForestState) -> ForestState:
    """Permute a forest's node slots into y order (existing nodes ascending
    by pos.y, empty slots at the tail; any leading axes), remapping the
    ``parent`` and ``first_child`` pointers through the inverse permutation
    (-1 stays -1). The tree is pointer-addressed, so this is a pure
    relabelling: distances, Murray sweeps, edge extraction and growth are
    unchanged; only argmin ties between exactly equidistant nodes can fall
    otherwise. The sort is stable, so the permutation equals the JAX
    package's."""
    nc = f.pos.shape[-2]
    dev = f.pos.device
    slots = torch.arange(nc, device=dev)
    exists = slots < f.n_nodes[..., None]
    key = torch.where(exists, f.pos[..., 1], float("inf"))
    perm = torch.argsort(key, dim=-1, stable=True)
    inv = torch.empty_like(perm).scatter_(-1, perm, slots.expand_as(perm))

    def remap(p):
        return torch.where(p >= 0, _take(inv, p.clamp(0, nc - 1)),
                           -1).to(torch.int32)

    return ForestState(
        pos=_take(f.pos, perm), radius=_take(f.radius, perm),
        parent=remap(_take(f.parent, perm)),
        first_child=remap(_take(f.first_child, perm)),
        n_children=_take(f.n_children, perm), is_root=_take(f.is_root, perm),
        n_nodes=f.n_nodes, kappa=_take(f.kappa, perm),
        pkappa=_take(f.pkappa, perm))


def _ysort_sinks(s: SinkState) -> SinkState:
    """Compact a sink array (any leading axes): alive sinks ascending by
    pos.y, dead (= free) slots at the tail. With the tail-first fill of
    :func:`_append_sinks` the alive prefix stays y-coherent for the whole
    next segment."""
    key = torch.where(s.alive, s.pos[..., 1], float("inf"))
    perm = torch.argsort(key, dim=-1, stable=True)
    return SinkState(pos=_take(s.pos, perm), alive=_take(s.alive, perm))


def _restage_spatial(state: GrowthState) -> GrowthState:
    """Spatial restage at segment boundaries, for the banded scans: y-sort
    node slots and compact and y-sort sink slots."""
    return state._replace(
        art=_ysort_forest(state.art), ven=_ysort_forest(state.ven),
        oxy=_ysort_sinks(state.oxy), co2=_ysort_sinks(state.co2))


def _resize_forests(state: GrowthState, cap: int) -> GrowthState:
    """Pad both (batched) forests' node arrays up to capacity ``cap``
    (never shrinks — shrinking could drop live nodes)."""
    extra = cap - state.art.pos.shape[-2]
    if extra <= 0:
        return state
    pad = torch.nn.functional.pad

    def grow(f: ForestState) -> ForestState:
        return ForestState(
            pos=pad(f.pos, (0, 0, 0, extra)),
            radius=pad(f.radius, (0, extra)),
            parent=pad(f.parent, (0, extra), value=-1),
            first_child=pad(f.first_child, (0, extra), value=-1),
            n_children=pad(f.n_children, (0, extra)),
            is_root=pad(f.is_root, (0, extra)),
            n_nodes=f.n_nodes,
            kappa=pad(f.kappa, (0, extra), value=4.0),
            pkappa=pad(f.pkappa, (0, extra), value=4.0))

    return state._replace(art=grow(state.art), ven=grow(state.ven))


def _resize_sinks(state: GrowthState, cap: int) -> GrowthState:
    """Pad both (batched) sink arrays up to capacity ``cap`` (never shrinks
    — shrinking could drop alive sinks; padded slots are dead = free)."""
    extra = cap - state.oxy.pos.shape[-2]
    if extra <= 0:
        return state
    pad = torch.nn.functional.pad

    def grow(s: SinkState) -> SinkState:
        return SinkState(pos=pad(s.pos, (0, 0, 0, extra)),
                         alive=pad(s.alive, (0, extra)))

    return state._replace(oxy=grow(state.oxy), co2=grow(state.co2))


def forest_edges_device(f: ForestState):
    """Device-side edge arrays from a (possibly batched) ForestState:
    ``(node_xy, parent_xy, radius, valid)``, one edge slot per node (roots
    and padding invalid). Feeds the splat directly — the generate→rasterize
    pipeline never round-trips edge lists through the host."""
    nc = f.pos.shape[-2]
    exists = torch.arange(nc, device=f.pos.device) < f.n_nodes[..., None]
    ppos = _take(f.pos, f.parent.clamp(0, nc - 1))
    valid = exists & (f.parent >= 0)
    return f.pos[..., :2], ppos[..., :2], f.radius, valid


def forest_to_edges(forest_state: ForestState,
                    sim_index: int | None = None) -> dict:
    """Extract the edge list {'node1','node2','radius'} arrays from a
    (possibly batched) ForestState — parents-first order, roots excluded
    (the reference CSV writer's order)."""
    f = forest_state
    if sim_index is not None:
        f = ForestState(*(x[sim_index] for x in f))
    n = int(f.n_nodes)
    pos = f.pos.cpu().numpy()[:n]
    parent = f.parent.cpu().numpy()[:n]
    radius = f.radius.cpu().numpy()[:n]
    mask = parent >= 0
    return {
        "node1": pos[mask],
        "node2": pos[np.clip(parent[mask], 0, n - 1)],
        "radius": radius[mask],
    }


def save_edges_csv(edges_list: list[dict], path: str):
    """Write merged forests to the reference CSV format."""
    import csv as _csv
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w+", newline="") as f:
        w = _csv.writer(f)
        w.writerow(["node1", "node2", "radius"])
        for edges in edges_list:
            for i in range(len(edges["radius"])):
                n1 = " ".join(f"{v:.8f}" for v in edges["node1"][i])
                n2 = " ".join(f"{v:.8f}" for v in edges["node2"][i])
                w.writerow([f"[{n1}]", f"[{n2}]", edges["radius"][i]])
