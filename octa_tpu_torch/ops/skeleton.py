"""Skeletonization and clDice.

Counterpart of ``octa_tpu/ops/skeleton.py``: the Zhang-Suen
:func:`skeletonize` (:27-108), bit-exact; the differentiable
``soft_erode`` / ``soft_dilate`` / ``soft_open`` / :func:`soft_skeletonize`
(:270-312); :func:`cl_score` and :func:`cl_dice` (:315-332), whose
volumes go through :func:`skeletonize_3d` (:111-267), bit-exact; and
:func:`soft_cl_dice_loss` (:335).

Images are [..., H, W] tensors, volumes [D, H, W]. :func:`skeletonize`
reads one flag a Zhang-Suen iteration back to the host,
:func:`skeletonize_3d` two values a sweep.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from octa_tpu_torch.parallel.mesh import global_sums


def _neighbors(img: torch.Tensor):
    """The 8 neighbours P2..P9 (N, NE, E, SE, S, SW, W, NW) through zero
    padding."""
    h, w = img.shape[-2:]
    z = F.pad(img, (1, 1, 1, 1))

    def sh(dr, dc):
        return z[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    return (sh(-1, 0), sh(-1, 1), sh(0, 1), sh(1, 1), sh(1, 0), sh(1, -1),
            sh(0, -1), sh(-1, -1))


def _zhang_subiter(img: torch.Tensor, first: bool) -> torch.Tensor:
    p2, p3, p4, p5, p6, p7, p8, p9 = _neighbors(img)
    b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9
    seq = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
    a = torch.zeros_like(b)
    for i in range(8):
        a = a + ((seq[i] == 0) & (seq[i + 1] == 1)).int()
    cond = (img == 1) & (b >= 2) & (b <= 6) & (a == 1)
    if first:
        cond = cond & (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
    else:
        cond = cond & (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
    return torch.where(cond, 0, img)


def skeletonize(img: torch.Tensor) -> torch.Tensor:
    """Zhang-Suen thinning of a binary image [..., H, W]; uint8 skeleton
    (``skimage.morphology.skeletonize``'s 2D method)."""
    x = (img > 0).int()
    while True:
        x2 = _zhang_subiter(_zhang_subiter(x, True), False)
        if torch.equal(x2, x):
            return x2.to(torch.uint8)
        x = x2


# ---------------------------------------------------------------------------
# 3D curve thinning (volumetric clDice)
# ---------------------------------------------------------------------------
#
# The JAX package tests every voxel of the volume in every pass with a
# [26, D, H, W] label state and min-label propagation (``_count_components``,
# :120). Only object voxels of the pass's parity class can be deleted, and a
# generated label is a few per cent object, so here each pass gathers the
# 3x3x3 neighbourhoods of those voxels alone as 26-bit codes and decides on
# the codes: the simple-point test (Malandain & Bertrand) is a function of
# the code. It floods bit masks within the 3x3x3 cube instead of propagating
# labels, with JAX's hop bounds (25 and 17, exact) and no early exit. On a
# card the test is read from a table of all 2^26 codes, made once a process
# by the same flood; on the CPU it runs on the gathered codes.

# Bit 9 (dz + 1) + 3 (dy + 1) + (dx + 1) of a 27-bit cube code holds the
# voxel at offset (dz, dy, dx); bit 13 is the centre. A gathered code packs
# the 26 neighbours in ``_OFF26``'s order (the JAX package's, :94), which is
# the cube's order with the centre left out.
_OFF26 = [(dz, dy, dx)
          for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
          if (dz, dy, dx) != (0, 0, 0)]
_CENTRE = 13


def _cube_mask(keep) -> int:
    return sum(1 << (9 * z + 3 * y + x) for z in range(3) for y in range(3)
               for x in range(3) if keep(z - 1, y - 1, x - 1))


_ALL27 = (1 << 27) - 1
_NOT_X0 = _ALL27 & ~_cube_mask(lambda z, y, x: x == -1)
_NOT_X2 = _ALL27 & ~_cube_mask(lambda z, y, x: x == 1)
_NOT_Y0 = _ALL27 & ~_cube_mask(lambda z, y, x: y == -1)
_NOT_Y2 = _ALL27 & ~_cube_mask(lambda z, y, x: y == 1)
# the 18-neighbourhood (faces and edges) and its 6 faces (:97-99)
_N18 = _cube_mask(lambda z, y, x: 1 <= abs(z) + abs(y) + abs(x) <= 2)
_FACE6 = _cube_mask(lambda z, y, x: abs(z) + abs(y) + abs(x) == 1)
# the JAX package's hop bounds: the sizes of the two graphs less one
_HOPS_OBJ, _HOPS_BG = len(_OFF26) - 1, 17
# bytes of work memory a candidate voxel takes in a pass (its [26] int64
# gather indices, the uint8 neighbours and their int64 bits, the code)
_BYTES_PER_CANDIDATE = 704
# the work memory a pass may take: a share of the card's free memory, a
# fixed size on the CPU
_FREE_SHARE, _CPU_BUDGET = 0.25, 1 << 29


def _to_cube(code: torch.Tensor) -> torch.Tensor:
    """26-bit gathered codes -> 27-bit cube codes (the centre bit 0)."""
    return (code & ((1 << _CENTRE) - 1)) | ((code >> _CENTRE) << (_CENTRE + 1))


def _shift(m: torch.Tensor, axis: int) -> torch.Tensor:
    """``m`` and its neighbours one step along one axis of the cube."""
    step, lo, hi = ((1, _NOT_X0, _NOT_X2), (3, _NOT_Y0, _NOT_Y2),
                    (9, _ALL27, _ALL27))[axis]
    return ((m << step) & lo) | ((m >> step) & hi)


def _dilate26(m: torch.Tensor) -> torch.Tensor:
    for axis in range(3):  # the 3x3x3 box is the product of three steps
        m = m | _shift(m, axis)
    return m


def _dilate6(m: torch.Tensor) -> torch.Tensor:
    return m | _shift(m, 0) | _shift(m, 1) | _shift(m, 2)


def _lowest_bit(m: torch.Tensor) -> torch.Tensor:
    return m & -m


def deletable_codes(code: torch.Tensor) -> torch.Tensor:
    """Whether an object voxel with the 26-bit neighbourhood ``code`` (int64)
    is simple and not an endpoint (``_deletable``, :196): exactly one
    26-component of object in its 26-neighbourhood, exactly one 6-component
    of background in its 18-neighbourhood that holds a face neighbour, and
    more than one object neighbour."""
    occ = _to_cube(code)
    reach = _lowest_bit(occ)
    for _ in range(_HOPS_OBJ):
        reach = _dilate26(reach) & occ
    one_object = (occ != 0) & (reach == occ)
    bg = _N18 & ~occ
    faces = bg & _FACE6
    reach = _lowest_bit(faces)
    for _ in range(_HOPS_BG):
        reach = _dilate6(reach) & bg
    one_background = (faces != 0) & ((faces & ~reach) == 0)
    endpoint = (occ & (occ - 1)) == 0  # one object neighbour (or none)
    return one_object & one_background & ~endpoint


@functools.lru_cache(maxsize=None)
def deletable_table(device: torch.device) -> torch.Tensor:
    """:func:`deletable_codes` of every 26-bit code, a [2^26] bool tensor on
    ``device`` (64 MiB), made once a process and device."""
    chunk = 1 << 24
    return torch.cat([
        deletable_codes(torch.arange(i, i + chunk, device=device))
        for i in range(0, 1 << 26, chunk)])


def _default_slab(dev: torch.device, h: int, w: int) -> int:
    """z-planes a pass may test at once: the work memory over the largest
    candidate count of a plane of one parity class."""
    budget = (torch.cuda.mem_get_info(dev)[0] * _FREE_SHARE
              if dev.type == "cuda" else _CPU_BUDGET)
    per_plane = _BYTES_PER_CANDIDATE * -(-h // 2) * -(-w // 2)
    return max(1, int(budget // per_plane))


def skeletonize_3d(vol: torch.Tensor, slab: int | None = None) -> torch.Tensor:
    """Curve thinning of a binary volume [D, H, W] to its medial lines
    (``octa_tpu/ops/skeleton.py:203``, the role of skimage's
    ``skeletonize(method='lee')`` in the reference's 3D clDice); uint8, the
    JAX function's output bit for bit.

    Subfield-parallel deletion: each pass deletes every simple, non-endpoint
    object voxel of one parity class (z%2, y%2, x%2), in JAX's order of the
    eight classes; voxels of one class are never 26-adjacent, so deleting
    them together equals deleting them one by one. Sweeps of eight passes
    run to a fixed point.

    A pass tests only the object voxels of its class, in runs of ``slab``
    z-planes, applying each run's deletions before the next run (same-class
    voxels do not see each other, so the result does not depend on
    ``slab``). By default ``slab`` is as many planes as a quarter of the
    card's free memory holds (512 MiB on the CPU). A sweep reads two values
    back to the host: the object voxels left (the fixed point is a sweep
    that deleted none) and the runs' sizes."""
    x = vol > 0
    d, h, w = x.shape
    dev = x.device
    slab = max(1, min(d, slab or _default_slab(dev, h, w)))
    n_slabs = -(-d // slab)
    padded = F.pad(x.to(torch.uint8), (1, 1, 1, 1, 1, 1))
    flat = padded.view(-1)
    s1, s0 = w + 2, (h + 2) * (w + 2)
    offsets = torch.tensor([dz * s0 + dy * s1 + dx for dz, dy, dx in _OFF26],
                           device=dev)
    bits = torch.ones(26, dtype=torch.int64, device=dev) << torch.arange(
        26, device=dev)
    table = deletable_table(dev) if dev.type == "cuda" else None
    n_prev = -1
    while True:
        cand = torch.nonzero(flat).squeeze(1)
        if cand.numel() == n_prev:  # the last sweep deleted nothing
            break
        n_prev = cand.numel()
        z = cand // s0
        parity = ((((z - 1) & 1) << 2) | ((((cand // s1) % (h + 2) - 1) & 1) << 1)
                  | ((cand % s1 - 1) & 1))
        run = parity * n_slabs + (z - 1) // slab
        order = torch.argsort(run * flat.numel() + cand)
        cand = cand[order]
        sizes = torch.bincount(run, minlength=8 * n_slabs).tolist()
        start = 0
        for size in sizes:  # class by class in JAX's order, slab by slab
            if size:
                c = cand[start:start + size]
                nb = flat[c[:, None] + offsets].to(torch.int64)
                code = (nb * bits).sum(1)
                kill = table[code] if table is not None else deletable_codes(code)
                flat[c] = (~kill).to(torch.uint8)
            start += size
    return padded[1:-1, 1:-1, 1:-1].clone()

def _max_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max at stride 1 over the last two axes, -inf outside."""
    return F.max_pool2d(x.reshape(-1, 1, *x.shape[-2:]), 3, stride=1,
                        padding=1).reshape(x.shape)


def soft_erode(x):
    return -_max_pool3(-x)


def soft_dilate(x):
    return _max_pool3(x)


def soft_open(x):
    return soft_dilate(soft_erode(x))


def soft_skeletonize(x: torch.Tensor, iters: int = 25) -> torch.Tensor:
    """Differentiable soft skeleton (clDice loss; Shit et al. CVPR'21) of a
    soft segmentation [..., H, W] in [0, 1]."""
    skel = F.relu(x - soft_open(x))
    img = soft_erode(x)
    for _ in range(iters):
        img = soft_erode(img)
        delta = F.relu(img - soft_open(img))
        skel = skel + F.relu(delta - skel * delta)
    return skel


def cl_score(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Skeleton volume overlap (reference ``cldice.py:6-16``)."""
    return torch.sum(v * s) / torch.clamp(torch.sum(s), min=1e-8)


def cl_dice(v_p: torch.Tensor, v_l: torch.Tensor) -> torch.Tensor:
    """clDice between a binary prediction and label: Zhang-Suen thinning of
    images [H, W], :func:`skeletonize_3d` of volumes [D, H, W] (the
    reference's ``method='lee'`` branch for 3D-reconstruction volumes)."""
    skel = skeletonize_3d if v_p.dim() == 3 else skeletonize
    v_p = (v_p > 0).float()
    v_l = (v_l > 0).float()
    s_l = skel(v_l).float()
    s_p = skel(v_p).float()
    tprec = cl_score(v_p, s_l)
    tsens = cl_score(v_l, s_p)
    return 2 * tprec * tsens / torch.clamp(tprec + tsens, min=1e-8)


def soft_cl_dice_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
                      iters: int = 25, smooth: float = 1.0,
                      shard=None) -> torch.Tensor:
    """Differentiable clDice loss term (1 - soft clDice). Its four sums run
    over the whole batch; with ``shard`` (a
    :class:`octa_tpu_torch.parallel.mesh.Shard`) the inputs are this rank's
    rows, and the sums are taken over the global batch in one all-reduce
    (:func:`~octa_tpu_torch.parallel.mesh.global_sums`)."""
    skel_pred = soft_skeletonize(y_pred, iters)
    skel_true = soft_skeletonize(y_true, iters)
    sums = global_sums(torch.stack([
        torch.sum(skel_pred * y_true), torch.sum(skel_pred),
        torch.sum(skel_true * y_pred), torch.sum(skel_true)]), shard)
    tprec = (sums[0] + smooth) / (sums[1] + smooth)
    tsens = (sums[2] + smooth) / (sums[3] + smooth)
    return 1.0 - 2.0 * tprec * tsens / (tprec + tsens)
