"""Batched space-colonization vessel growth in PyTorch.

Counterpart of ``octa_tpu/sim/greenhouse.py``, function for function and
under the same names. The forest is a fixed-capacity structure of arrays and
every step is a masked, vectorized computation:

- oxygen-sink sampling with the Schneider-2012 oxygen heuristic and mutual
  ``eps_s`` spacing by a blocked greedy accept (K6,
  :func:`octa_tpu_torch.ops.spacing.blocked_greedy_spacing`),
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

Tapes. On a card an iteration is some 840 small torch operations around ten
calls of the hand-written kernels, and Python launching them one by one
sets its pace. Within a capacity-staging segment every shape is fixed, so
the :class:`Greenhouse` replays a segment's iterations from a recorded
:class:`Tape`: an ordered list of pieces, each a CUDA graph of the torch
operations between two kernel calls, followed by that call, made eagerly.
Every kernel call of an iteration goes through :func:`_kernel`, which looks
the dispatcher up in this module's globals at call time, so that a function
put in its place sees every call, in the eager order and with the
iteration's real tensors, replayed or not; the dispatchers' counters and
scratch stay theirs. A tape is keyed by what the iteration's Python bakes
in (:func:`tape_key`); the first iteration of a mode stays eager, and so
does a segment's first iteration where no tape of its key exists yet (it
warms the shapes up before the next one records). Off CUDA, every
iteration is eager.

All of a Greenhouse's tapes capture into one memory pool. That is safe
because a segment runs at most two tapes, one after the other, never
interleaved, and every pool buffer a tape reads is written earlier in the
same iteration: what lasts from one iteration to the next (the state, the
draws and the kernels' outputs) lives in buffers of the tape's own, outside
the pool, which the state is copied into at a segment's entry and cloned
out of at its exit.
"""
from __future__ import annotations

import threading
import warnings as _warnings
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.ops._cuda import on_device
# the kernels' dispatchers are called by their names here (_kernel)
from octa_tpu_torch.ops.nearest import (  # noqa: F401
    masked_nearest, masked_nearest_banded)
from octa_tpu_torch.ops.segsum import segment_sum, segment_sum_plain  # noqa: F401
from octa_tpu_torch.ops.spacing import (  # noqa: F401
    SPACING, blocked_greedy_spacing as _blocked_greedy_spacing)
from octa_tpu_torch.parallel import mesh as mesh_lib
from octa_tpu_torch.utils import trace

GEOMETRY_SIZE = 76

#: the hand-written kernels' dispatchers an iteration calls, by their names
#: in this module, and the span around each call replayed from a tape
KERNEL_SPANS = {"masked_nearest": "octa.grow.nearest",
                "masked_nearest_banded": "octa.grow.nearest",
                "_blocked_greedy_spacing": "octa.grow.spacing",
                "segment_sum": None}

_recording = threading.local()  # .tape: the Tape this thread records


def _kernel(name: str, *args, **kw):
    """The call ``name(*args, **kw)`` of a kernel dispatcher, looked up in
    this module's globals now; while a tape records, the call also ends the
    piece being captured (:meth:`Tape.call`)."""
    fn = globals()[name]
    tape = getattr(_recording, "tape", None)
    if tape is None:
        return fn(*args, **kw)
    return tape.call(name, fn, args, kw)


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
    sums = _kernel("segment_sum", seg.reshape(-1, sq),
                   feats.reshape(-1, sq, 18), nc).reshape(*lead, nc, 18)
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
    with trace.span("octa.grow.murray"):
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

    def summer(*args):
        return segment_sum_plain(*args) if exact else _kernel("segment_sum",
                                                              *args)

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

def _draw(generator, state: StackedState, n_cand: int, geometry,
          draw_rows) -> IterationDraws:
    """An iteration's numbers from ``generator``, drawn for a global batch
    of ``n`` of which ``state`` holds rows ``lo:hi`` (``draw_rows``; by
    default the batch itself)."""
    bsz, _, nc = state.forests.radius.shape
    gsize = GEOMETRY_SIZE if geometry is None else max(geometry.shape)
    n, lo, hi = draw_rows or (bsz, 0, bsz)
    with trace.span("octa.grow.draws"):
        return IterationDraws(*(t[lo:hi] for t in draw_iteration(
            generator, n, n_cand, nc, gsize, state.forests.pos.device)))


def _iteration(state: StackedState, mp: ModeParams, i: int, t: int, *,
               param_scale, r0, rotation_radius, faz_center, size_z,
               n_cand, murray_sweeps=8, nerve_center=None,
               nerve_radius=0.0, geometry=None, new_cap=1024,
               draws: IterationDraws | None = None,
               generator: torch.Generator | None = None,
               banded: bool = False, draw_rows=None) -> StackedState:
    """One greenhouse iteration for a batch ``[B]`` of samples, with both
    forests grown in one stacked pass.

    ``i`` is the within-mode index: at i == 0 the raw mode parameters apply;
    afterwards params = raw/(param_scale*sigma). ``draws`` are the
    iteration's random numbers; when absent they come from ``generator``,
    drawn for a global batch of ``n`` of which this batch is rows
    ``lo:hi`` (``draw_rows``; a rank of a sharded growth), by default the
    batch itself. ``banded`` takes three of the four nearest scans
    through K5.

    Scheduling vs the reference: candidates accepted at step 1 participate
    in arterial growth and the satisfied-sink check of the same iteration,
    but venous growth sees the CO2 set from *before* this iteration's
    conversions."""
    F, S = state.forests, state.sinks
    bsz, _, nc = F.radius.shape
    sc = S.pos.shape[2]
    dev = F.pos.device
    if draws is None:
        draws = _draw(generator, state, n_cand, geometry, draw_rows)

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
    with trace.span("octa.grow.candidates"):
        cand, valid = _sample_candidates(
            draws.vox, draws.jitter, faz_center, state.faz_radius, size_z,
            nerve_center=nerve_center, nerve_radius=nerve_radius,
            geometry=geometry)
        if banded:
            # y-sort the candidates so that their query tiles are spatially
            # coherent in every banded scan below. The blocked greedy
            # spacing is order-sensitive, so it runs in the ORIGINAL sample
            # order through `order` and its inverse; only the distance scans
            # see the sorted layout.
            order = torch.argsort(cand[..., 1], dim=-1, stable=True)  # [B,N]
            inv_order = torch.empty_like(order).scatter_(
                -1, order,
                torch.arange(cand.shape[1], device=dev).expand_as(order))
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
        with trace.span("octa.grow.nearest"):
            dd, ii = _kernel(
                "masked_nearest_banded",
                q.reshape(3 * bsz, sq, 3), pts.reshape(3 * bsz, nc, 3),
                mask1.reshape(3 * bsz, 1, nc), alive_q.reshape(3 * bsz, sq),
                band.reshape(3 * bsz))
        # candidate rejection is gated on d <= max(eps_n, eps_k) (and on the
        # nearest trunk's oxygen radius, which only matters when that
        # already holds), so it bands exactly too
        with trace.span("octa.grow.nearest"):
            d_cand_art, i_cand_art = _kernel(
                "masked_nearest_banded", cand, F.pos[:, 0],
                exists[:, 0, None], ones_c, torch.maximum(eps_n, eps_k))
    else:
        with trace.span("octa.grow.nearest"):
            dd, ii = _kernel("masked_nearest", q.reshape(3 * bsz, sq, 3),
                             pts.reshape(3 * bsz, nc, 3),
                             mask1.reshape(3 * bsz, 1, nc))
        with trace.span("octa.grow.nearest"):
            d_cand_art, i_cand_art = _kernel("masked_nearest", cand,
                                             F.pos[:, 0], exists[:, 0, None])
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
    with trace.span("octa.grow.nearest"):
        if banded:
            # consumed only through `d_oxy > eps_s`, so an eps_s band is
            # exact; the sink array's alive prefix is y-sorted between
            # restages
            d_oxy = _kernel(
                "masked_nearest_banded", cand, S.pos[:, 0],
                S.alive[:, 0, None], ones_c, eps_s, want_idx=False)[:, 0]
        else:
            d_oxy = _kernel("masked_nearest", cand, S.pos[:, 0],
                            S.alive[:, 0, None], want_idx=False)[:, 0]
    valid = valid & (d_oxy > eps_s[:, None])
    # mutual spacing (blocked greedy), in the original sample order
    with trace.span("octa.grow.spacing"):
        if banded:
            accept = _take(_kernel(
                "_blocked_greedy_spacing", _take(cand, inv_order),
                _take(valid, inv_order), eps_s), order)
        else:
            accept = _kernel("_blocked_greedy_spacing", cand, valid, eps_s)

    # --- 2+4. stacked growth: arterial on [oxy; accepted cand], venous on
    # [co2; -] ---
    view_alive = torch.stack([
        torch.cat([S.alive[:, 0], accept], 1),
        torch.cat([S.alive[:, 1], torch.zeros_like(accept)], 1)], 1)
    view_pos = torch.stack([q01, q2], 1)                          # [B,2,Sq,3]
    gamma = torch.where(torch.arange(2, device=dev) == 0,
                        float(mp.gamma_art), float(mp.gamma_ven))
    with trace.span("octa.grow.core"):
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
    with trace.span("octa.grow.sinks"):
        k_new = min(new_cap, nc)
        jw = torch.arange(k_new, device=dev)
        win_pos = _take(torch.nn.functional.pad(newF.pos, (0, 0, 0, k_new)),
                        F.n_nodes.long()[..., None] + jw)         # [B,2,K,3]
        win_valid = jw < (newF.n_nodes - F.n_nodes)[..., None]
        with trace.span("octa.grow.nearest"):
            d_new = _kernel(
                "masked_nearest", view_pos.reshape(2 * bsz, sq, 3),
                win_pos.reshape(2 * bsz, k_new, 3),
                win_valid.reshape(2 * bsz, 1, k_new),
                want_idx=False).reshape(bsz, 2, sq)
        satisfied = view_alive & (d_new <= eps_k[:, None, None])
        # oxygen sinks satisfied by new arterial nodes convert to CO2 when
        # no venous node (pre-growth, as in the reference) is within eps_k
        to_co2 = satisfied[:, 0] & (dd[:, 1] > eps_k[:, None])

        base = SinkState(S.pos, S.alive & ~satisfied[:, :, :sc])
        # one stacked append: row 0 stores surviving new candidates as
        # oxygen sinks, row 1 stores converted CO2 sources (from oxy slots
        # or new cands)
        acc0 = torch.cat([torch.zeros(bsz, sc, dtype=torch.bool, device=dev),
                          accept & ~satisfied[:, 0, sc:]], 1)
        props = torch.stack([q01, q01], 1)
        # append window doubles with the emission cap from 2048 so the
        # first ecap doubling already enlarges it
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
             banded: bool = False, draw_rows=None,
             tapes: Tapes | None = None):
    """Run iterations ``i0 .. i0+seg_len`` of one mode on a batch ``[B]``.
    Sigma resets to 1 at mode entry (i0 == 0) and ``d`` continues
    (compounds) from the previous mode. Segmenting (i0 > 0) lets
    ``develop_forest`` grow the node capacity between segments.

    Random numbers come from ``generator``, or from ``draws``, a sequence
    of one :class:`IterationDraws` per iteration. With ``collect_stats``
    also returns per-iteration counters [B, seg_len, 5] (node counts, alive
    sink counts, sigma).

    With ``tapes`` (a :class:`Greenhouse`'s), on a card and with the
    numbers drawn from ``generator``, the iterations after a mode's first
    replay tapes (:class:`Tape`): the same kernels on the same inputs, so
    the same bits as the eager iterations."""
    seg_len = mp.I if seg_len is None else seg_len
    if i0 == 0:
        state = state._replace(sigma_t=torch.ones_like(state.sigma_t),
                               d_start=state.d_cur)
    st = _stack_state(state)
    taped = tapes is not None and draws is None and st.sigma_t.is_cuda
    on_tape = False  # whether ``st`` is a tape's buffers
    stats = []
    for k in range(seg_len):
        i, t = i0 + k, t0 + i0 + k

        def iterate(s, d, i=i, t=t):
            return _iteration(
                s, mp, i, t, param_scale=param_scale, r0=r0,
                rotation_radius=rotation_radius, faz_center=faz_center,
                size_z=size_z, n_cand=int(mp.N), murray_sweeps=murray_sweeps,
                nerve_center=nerve_center, nerve_radius=nerve_radius,
                geometry=geometry, new_cap=new_cap, draws=d,
                generator=generator, banded=banded, draw_rows=draw_rows)

        with trace.span("octa.grow.iteration"):
            if taped and i > 0:
                key = tape_key(mp, i, t, st, new_cap, murray_sweeps, banded,
                               draw_rows)
                d = _draw(generator, st, int(mp.N), geometry, draw_rows)
                st, on_tape = tapes.step(key, st, d, iterate, warm=k > 0)
            else:
                st, on_tape = iterate(
                    st, None if draws is None else draws[k]), False
        if collect_stats:
            n_alive = st.sinks.alive.sum(-1)
            stats.append(torch.stack([
                st.forests.n_nodes[:, 0].float(),
                st.forests.n_nodes[:, 1].float(),
                n_alive[:, 0].float(), n_alive[:, 1].float(),
                st.sigma_t], -1))
    if on_tape:  # the tape's next replay overwrites its buffers
        st = _map_state(torch.clone, st)
    state = _unstack_state(st)
    return (state, torch.stack(stats, 1)) if collect_stats else state


# ---------------------------------------------------------------------------
# Tapes: a segment's iterations replayed from CUDA graphs
# ---------------------------------------------------------------------------

def tape_key(mp: ModeParams, i: int, t: int, state: StackedState,
             new_cap: int, murray_sweeps: int, banded: bool,
             draw_rows) -> tuple:
    """What the Python of iteration ``i`` (global iteration ``t``) of mode
    ``mp`` bakes into its operations: the mode's parameters, ``i > 0``
    (the raw parameters at a mode's entry), ``t > 15`` (the FAZ rotation
    field), the batch, node and sink capacities, the emission window
    ``new_cap``, the Murray sweeps, the banded configuration and the rows
    drawn."""
    bsz, _, cap = state.forests.radius.shape
    return (mp, i > 0, t > 15, bsz, cap, state.sinks.pos.shape[2], new_cap,
            murray_sweeps, banded, draw_rows)


def _map_state(fn, st: StackedState) -> StackedState:
    return StackedState(ForestState(*map(fn, st.forests)),
                        SinkState(*map(fn, st.sinks)), *map(fn, st[2:]))


def _leaves(st: StackedState) -> list:
    return [*st.forests, *st.sinks, *st[2:]]


def _tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class Tape:
    """One iteration of a segment as pieces: each a CUDA graph of the torch
    operations up to a kernel call, then that call (its dispatcher's name,
    its arguments, the buffers its outputs are copied into; the last piece
    calls nothing and copies the new state into the input buffers).
    ``state`` and ``draws`` are the input buffers."""

    def __init__(self, pool, side: torch.cuda.Stream):
        self.pool, self.side = pool, side
        self.pieces: list[tuple] = []
        self.state: StackedState | None = None
        self.draws: IterationDraws | None = None
        self._graph = None

    def record(self, st: StackedState, draws: IterationDraws, iterate):
        """Record the tape during a real iteration ``iterate(st, draws)``
        from ``st``; returns its new state (the input buffers)."""
        dev = st.sigma_t.device
        self.state = _map_state(torch.clone, st)
        self.draws = IterationDraws(*map(torch.clone, draws))
        with on_device(dev):
            self._main = torch.cuda.current_stream(dev)
            self._begin()
            _recording.tape = self
            try:
                new = iterate(self.state, self.draws)
                for buf, x in zip(_leaves(self.state), _leaves(new)):
                    if x is not buf:  # a leaf the iteration passes through
                        buf.copy_(x)
                self.pieces.append((self._finish(), None, (), {}, ()))
            except BaseException:
                if self._graph is not None:  # close the capture, then raise
                    try:
                        self._graph.capture_end()
                    except RuntimeError:
                        pass
                    self._graph = None
                raise
            finally:
                _recording.tape = None
                torch.cuda.set_stream(self._main)
        return self.state

    def _begin(self):
        self.side.wait_stream(self._main)
        torch.cuda.set_stream(self.side)
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def _finish(self) -> torch.cuda.CUDAGraph:
        """End the piece being captured and run it once on the caller's
        stream, so that its outputs are real."""
        g, self._graph = self._graph, None
        g.capture_end()
        torch.cuda.set_stream(self._main)
        g.replay()
        return g

    def call(self, name: str, fn, args: tuple, kw: dict):
        """A kernel call while recording: ends the piece (its arguments made
        contiguous inside it, which the dispatchers would otherwise do
        eagerly), makes the call eagerly and opens the next piece."""
        args = tuple(a.contiguous() if torch.is_tensor(a) else a
                     for a in args)
        g = self._finish()
        out = fn(*args, **kw)
        self.pieces.append((g, name, args, kw, _tuple(out)))
        self._begin()
        return out

    def replay(self, st: StackedState, draws: IterationDraws) -> StackedState:
        """One iteration from ``st`` with ``draws``: the pieces replayed on
        the current stream, each kernel call made eagerly through this
        module's globals and its outputs copied into the recorded buffers.
        Returns the new state (the input buffers)."""
        with on_device(self.state.sigma_t.device):
            if st is not self.state:
                for buf, x in zip(_leaves(self.state), _leaves(st)):
                    buf.copy_(x)
            for buf, x in zip(self.draws, draws):
                buf.copy_(x)
            for g, name, args, kw, outs in self.pieces:
                g.replay()
                if name is None:
                    break
                span = KERNEL_SPANS[name]
                with trace.span(span) if span else trace.OFF:
                    res = globals()[name](*args, **kw)
                for o, r in zip(outs, _tuple(res)):
                    o.copy_(r)
        return self.state


class Tapes:
    """A :class:`Greenhouse`'s tapes by :func:`tape_key`, at most ``MAX``,
    the least recently used dropped first, all capturing into one memory
    pool on one side stream. ``graphed`` counts the iterations replayed,
    ``recorded`` the tapes recorded."""

    #: tapes kept: a batch of the full schedule records about seven (mode
    #: entries, the FAZ rotation's start, segments redone), and the first
    #: segments' capacities recur from batch to batch
    MAX = 16

    def __init__(self):
        self.tapes: OrderedDict = OrderedDict()
        self.graphed = 0
        self.recorded = 0
        self._pool = self._side = None

    def __len__(self):
        return len(self.tapes)

    def step(self, key, st: StackedState, draws: IterationDraws, iterate,
             warm: bool) -> tuple[StackedState, bool]:
        """One iteration, ``iterate(st, draws)``'s: replayed from the tape of
        ``key``; else recorded into it where ``warm`` (an iteration of these
        shapes ran before in the segment), else run eagerly. Returns the new
        state and whether it is a tape's buffers."""
        tape = self.tapes.get(key)
        if tape is not None:
            self.tapes.move_to_end(key)
            self.graphed += 1
            return tape.replay(st, draws), True
        if not warm:
            return iterate(st, draws), False
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(st.sigma_t.device)
        tape = Tape(self._pool, self._side)
        new = tape.record(st, draws, iterate)
        self.tapes[key] = tape
        self.recorded += 1
        while len(self.tapes) > self.MAX:
            self.tapes.popitem(last=False)
        return new, True


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
        #: K6 launches of the last ``develop_forest`` (one an iteration on
        #: the card, none on the CPU)
        self.spacing_launches = 0
        #: the growth's tapes, kept across segments and batches (used on a
        #: card only), and of the last ``develop_forest`` the iterations
        #: replayed from them and the tapes recorded
        self.tapes = Tapes()
        self.graphed = self.recorded = 0
        #: the samples of the last ``develop_forest`` this process grew
        #: (all of them, or its rank's rows of a sharded growth)
        self.rows = range(0)
        self._mesh = None
        self._draw_rows = None
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
        """One device -> host read of a few scalar tensors; in a sharded
        growth, their maxima over the mesh (every value read is a maximum
        over the batch), so that every rank stages the capacities of the
        unsharded run."""
        self.host_syncs += 1
        with trace.span("octa.grow.read"):
            vals = torch.stack([s.float() for s in scalars])
            if self._mesh is not None:
                mesh_lib.all_reduce_([vals], self._mesh, dist.ReduceOp.MAX,
                                     "growth counters")
            return vals.cpu().tolist()

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

        While a profiler session records, the batch is the span
        ``octa.grow.batch``, noted with its ``iterations`` (run, redone ones
        included), ``redone`` (those of segments that capacity staging
        threw away and ran again), ``host_syncs``, ``spacing_launches``
        (K6's launches, one an iteration on the card), ``graphed`` (the
        iterations replayed from a tape) and ``recorded`` (the tapes
        recorded); inside it
        ``octa.grow.restage``, ``octa.grow.iteration`` (and its stages),
        ``octa.grow.read`` and ``octa.grow.final_murray``
        (:mod:`octa_tpu_torch.utils.trace`).

        The generator is seeded with ``self.seed`` here, so two calls from
        the same seed grow from the same random numbers.

        ``mesh`` (a :class:`octa_tpu_torch.parallel.mesh.Mesh`, the JAX
        package's ``data`` mesh, :1179-1268) shards the batch over its
        ranks, one card each. The batch is padded to a multiple of the mesh
        with extra seeds; each rank grows its rows (``self.rows``) and
        returns their state. The simulations are independent; what the
        ranks share is what makes their rows equal to the unsharded run's:
        every per-segment read is a maximum over the mesh (the same
        capacities, which the draws' shapes depend on), and every rank
        draws each iteration's numbers for the whole padded batch from the
        generator seeded alike and keeps its rows."""
        if mesh is not None and not mesh.member:
            raise ValueError("develop_forest: this rank is outside the mesh")
        with trace.span("octa.grow.batch") as span:
            first = SPACING.launches
            graphed, recorded = self.tapes.graphed, self.tapes.recorded
            out = self._develop_forest(forest_config, batch, murray_sweeps,
                                       collect_stats, final_murray_sweeps,
                                       mesh)
            self.spacing_launches = SPACING.launches - first
            self.graphed = self.tapes.graphed - graphed
            self.recorded = self.tapes.recorded - recorded
            span.note(**self.stage_counts())
        return out

    def stage_counts(self) -> dict[str, int]:
        """The last batch's iterations run (redone ones included), those
        redone (of segments run again at a larger capacity), its host reads,
        its K6 launches, its iterations replayed from a tape and the tapes
        it recorded, from ``stage_log``, ``host_syncs``,
        ``spacing_launches``, ``graphed`` and ``recorded``."""
        return {"iterations": sum(e["seg_len"] for e in self.stage_log),
                "redone": sum(e["seg_len"] for e in self.stage_log
                              if not e["accepted"]),
                "host_syncs": self.host_syncs,
                "spacing_launches": self.spacing_launches,
                "graphed": self.graphed, "recorded": self.recorded}

    def _develop_forest(self, forest_config, batch, murray_sweeps,
                        collect_stats, final_murray_sweeps, mesh):
        n_shard = mesh.size if mesh is not None else 1
        grown = -(-batch // n_shard) * n_shard  # pad to a mesh multiple
        lo = (mesh.rank if mesh is not None else 0) * (grown // n_shard)
        self.rows = range(lo, lo + grown // n_shard)
        self._mesh = mesh
        self._draw_rows = (grown, self.rows.start, self.rows.stop)
        self.generator.manual_seed(self.seed)
        self.stage_log = []
        self.host_syncs = 0
        cap0 = _pow2ceil(max(
            1024, 4 * forest_config.get("N_trees", 8) + 64 * self.SEG_LEN))
        states = [self.init_state(forest_config, self.seed + i,
                                  node_capacity=min(cap0, self.node_capacity),
                                  sink_capacity=min(2048, self.sink_capacity))
                  for i in self.rows]
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
                with trace.span("octa.grow.restage"):
                    seg_state = _resize_sinks(_resize_forests(state, cap),
                                              scap)
                    if self.banded:
                        # y-sort node slots, compact and y-sort sink slots,
                        # so that the chunks' y-ranges are narrow for the
                        # whole segment (in-segment appends land at the tail
                        # and degrade only their own chunks to full scans)
                        seg_state = _restage_spatial(seg_state)
                    # clear saturation bits at segment entry: ``sat`` is
                    # OR-accumulated, and a sticky bit from an earlier
                    # segment would trigger spurious redos in every later one
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
                        RuntimeWarning, stacklevel=3)
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

    def save_stats(self, state: GrowthState, stats, out_dir: str,
                   sim_index: int = 0):
        """Growth statistics of sample ``sim_index`` (the JAX package's
        ``save_stats``, ``greenhouse.py:1396-1441``; reference
        ``greenhouse.py:401-441``): ``stats.yml`` with the iterations, the
        final node counts and sigma and the radii's mean and maximum, written
        without PyYAML as ``yaml.safe_dump`` writes it; and, where
        matplotlib imports, ``stats.png`` with the per-iteration node, sink
        and sigma curves and the final radii's histogram. ``stats`` is
        ``develop_forest(..., collect_stats=True)``'s second result."""
        import importlib
        import os

        from octa_tpu_torch.utils.config import dump_flat_yaml

        s = stats[sim_index]
        s = s.detach().cpu().numpy() if torch.is_tensor(s) else np.asarray(s)
        radii = np.concatenate([
            forest_to_edges(state.art, sim_index)["radius"],
            forest_to_edges(state.ven, sim_index)["radius"]])
        os.makedirs(out_dir, exist_ok=True)
        dump_flat_yaml({
            "iterations": int(s.shape[0]),
            "final_art_nodes": int(s[-1, 0]),
            "final_ven_nodes": int(s[-1, 1]),
            "final_sigma": float(s[-1, 4]),
            "radius_mean": float(radii.mean()) if radii.size else 0.0,
            "radius_max": float(radii.max()) if radii.size else 0.0,
        }, os.path.join(out_dir, "stats.yml"))
        try:
            matplotlib = importlib.import_module("matplotlib")
            matplotlib.use("Agg")
            plt = importlib.import_module("matplotlib.pyplot")
        except ImportError:
            return
        fig, axes = plt.subplots(1, 3, figsize=(13, 3.5))
        axes[0].plot(s[:, 0], label="arterial nodes")
        axes[0].plot(s[:, 1], label="venous nodes")
        axes[0].set_xlabel("iteration")
        axes[0].legend()
        axes[1].plot(s[:, 2], label="O2 sinks")
        axes[1].plot(s[:, 3], label="CO2 sources")
        axes[1].plot(s[:, 4], label="sigma")
        axes[1].set_xlabel("iteration")
        axes[1].legend()
        axes[2].hist(radii * self.param_scale, bins=50)
        axes[2].set_xlabel("vessel radius")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "stats.png"))
        plt.close(fig)

    def _final_murray(self, state: GrowthState, sweeps: int) -> GrowthState:
        """Converge both forests' radii to the exact Murray fixed point of
        the final trees, with the exact scatter-add on either device."""
        with trace.span("octa.grow.final_murray"):
            return state._replace(
                art=murray_sweep(state.art, sweeps, exact=True),
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
            generator=self.generator, banded=self.banded,
            draw_rows=self._draw_rows, tapes=self.tapes)


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
