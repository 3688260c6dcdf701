"""Height-sharded DynUNet inference over several cards.

Counterpart of ``octa_tpu/parallel/spatial.py`` (and of the ``axis_name``
paths of ``octa_tpu/models/layers.py:39-54`` and
``octa_tpu/models/dynunet.py:148-153, 226-229``). The height axis of the
NCHW activations is split over a ``space`` group of ranks, one block of
rows each:

- a k x k convolution (k > 1) takes ``k // 2`` halo rows from each
  neighbour (:func:`halo_exchange`, ``dist.batch_isend_irecv``) and pads
  the width only; a missing neighbour gives zeros, which is the zero
  padding at the global edge, so a convolution's output is the unsharded
  one's rows;
- a stride-2 convolution stays aligned because every shard keeps an even
  row count (H divisible by ``n_space * 2^n_down``);
- a transposed convolution with kernel = stride tiles without overlap and
  stays local;
- instance norm sums its moments over the group, in two passes in float32
  (the mean, then the centred squares: the one-pass ``E[x²] - mean²``
  cancels in float32 where ``|mean| >> std``).

This path is inference only: the halo exchange has no backward pass.
:func:`spatial_mesh` makes the (data, space) grid of ranks and
:func:`dynunet_spatial_infer` runs a ``DynUNet`` on it.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from octa_tpu_torch.parallel import mesh as mesh_lib


@dataclass
class SpatialMesh:
    """A (data, space) grid of ranks: ``data`` is this rank's column (the
    ranks that hold the same rows of other samples), ``space`` its row
    (the ranks that hold the other rows of the same samples)."""

    data: mesh_lib.Mesh
    space: mesh_lib.Mesh
    device: torch.device


def spatial_mesh(n_data: int = 1, n_space: int | None = None,
                 device="cuda") -> SpatialMesh:
    """The (data, space) grid over the first ``n_data * n_space`` ranks of
    the process group (rank ``d * n_space + s`` at data index ``d``, space
    index ``s``). Needs a process group: a world of one is a grid of one."""
    base = mesh_lib.get_mesh(device=device)
    if base is None:
        raise RuntimeError("spatial_mesh: no process group; run under "
                           "torch.distributed.run or parallel.mesh.launch")
    world = dist.get_world_size()
    n_space = n_space or world // n_data
    if n_data * n_space > world:
        raise ValueError(f"spatial_mesh: {n_data} x {n_space} ranks asked, "
                         f"the group has {world}")
    key = ("grid", n_data, n_space)
    if key not in mesh_lib._GROUPS:
        # every rank makes every group, in the same order
        rows = [list(range(d * n_space, (d + 1) * n_space))
                for d in range(n_data)]
        cols = [list(range(s, n_data * n_space, n_space))
                for s in range(n_space)]
        mesh_lib._GROUPS[key] = ([(r, dist.new_group(r)) for r in rows],
                                 [(c, dist.new_group(c)) for c in cols])
    rows, cols = mesh_lib._GROUPS[key]
    rank = dist.get_rank()

    def member(groups):
        for ranks, group in groups:
            if rank in ranks:
                return mesh_lib.Mesh(group, ranks.index(rank), len(ranks),
                                     base.device, tuple(ranks))
        return mesh_lib.Mesh(None, -1, len(groups[0][0]), base.device, ())

    return SpatialMesh(member(cols), member(rows), base.device)


def halo_exchange(x: torch.Tensor, up: int, down: int,
                  space: mesh_lib.Mesh) -> torch.Tensor:
    """``x`` [B, C, H, W] padded along H with ``up`` rows of the previous
    shard and ``down`` rows of the next one (zeros at the global edges)."""
    n, r = space.size, space.rank
    h = x.shape[2]

    def edge(rows):
        return x.new_zeros((x.shape[0], x.shape[1], rows, x.shape[3]))

    top, bottom = edge(up), edge(down)
    ops = []
    if r > 0:
        prev = space.ranks[r - 1]
        if up:
            ops.append(dist.P2POp(dist.irecv, top, prev, space.group))
        if down:
            ops.append(dist.P2POp(dist.isend, x[:, :, :down].contiguous(),
                                  prev, space.group))
    if r < n - 1:
        nxt = space.ranks[r + 1]
        if up:
            ops.append(dist.P2POp(dist.isend, x[:, :, h - up:].contiguous(),
                                  nxt, space.group))
        if down:
            ops.append(dist.P2POp(dist.irecv, bottom, nxt, space.group))
    if ops:
        nbytes = (up + down) * x[..., :1, :].numel() * x.element_size()
        with mesh_lib.timed(space, "halo", nbytes):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return torch.cat([top, x, bottom], 2)


def conv2d(conv, x: torch.Tensor, space: mesh_lib.Mesh) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d`` with torch padding ``k // 2``) on a block
    of rows: halo rows from the neighbours, zero padding of the width."""
    k = conv.kernel_size[0]
    if k > 1:
        x = halo_exchange(x, k // 2, k // 2, space)
    return F.conv2d(x, conv.weight, conv.bias, conv.stride,
                    (0, conv.padding[1]), conv.dilation, conv.groups)


def instance_norm(norm, x: torch.Tensor, space: mesh_lib.Mesh):
    """Instance norm over H, W of the whole image from a block of its rows:
    float32 moments summed over the group in two passes."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    n = x.shape[2] * x.shape[3] * space.size
    total = x32.sum((2, 3), keepdim=True)
    mesh_lib.all_reduce_([total], space, what="norm")
    mean = total / n
    sq = ((x32 - mean) ** 2).sum((2, 3), keepdim=True)
    mesh_lib.all_reduce_([sq], space, what="norm")
    y = (x32 - mean) * torch.rsqrt(sq / n + norm.eps)
    if norm.affine:
        w = norm.weight.to(x32.dtype)[:, None, None]
        y = y * w + norm.bias.to(x32.dtype)[:, None, None]
    return y.to(x.dtype)


@contextlib.contextmanager
def sharded(model: torch.nn.Module, space: mesh_lib.Mesh):
    """Inside the block, ``model``'s convolutions and instance norms work
    on blocks of rows over ``space``."""
    from octa_tpu_torch.models.layers import set_space

    set_space(model, space)
    try:
        yield model
    finally:
        set_space(model, None)


def check_shardable(model, height: int, n_space: int) -> None:
    """JAX's preconditions (``octa_tpu/parallel/spatial.py:72-86``): H
    divides over the shards, and every stride-2 stage sees an even
    per-shard height."""
    if height % n_space:
        raise ValueError(
            f"spatial sharding: H={height} not divisible by n_space={n_space}")
    h = height // n_space
    for si, stride in enumerate(getattr(model, "strides", [])):
        if stride == 2:
            if h % 2:
                raise ValueError(
                    f"spatial sharding: per-shard height {h} is odd at "
                    f"stride-2 stage {si} (H={height}, n_space={n_space}); H "
                    f"must be divisible by n_space * 2^n_downsamples")
            h //= 2


def dynunet_spatial_infer(model, x: torch.Tensor, mesh: SpatialMesh,
                          gather: bool = True) -> torch.Tensor:
    """``model`` (a DynUNet) on the global batch ``x`` [B, C, H, W], which
    every rank holds, with the batch split over ``mesh.data`` and H over
    ``mesh.space``. H must be divisible by ``n_space * 2^n_down`` (1216
    over 4 ranks: 304 -> 152 -> 76 -> 38 rows a shard). Returns the global
    output (``gather``) or this rank's block of it."""
    check_shardable(model, x.shape[2], mesh.space.size)
    if x.shape[0] % mesh.data.size:
        raise ValueError(f"spatial sharding: batch {x.shape[0]} does not "
                         f"divide n_data={mesh.data.size}")
    rows = mesh_lib.Shard(mesh.space, x.shape[2])
    block = mesh_lib.Shard(mesh.data, x.shape[0]).take(x)
    block = block[:, :, rows.lo:rows.hi].contiguous()
    with torch.no_grad(), sharded(model, mesh.space):
        y = model(block)
    if not gather:
        return y
    with torch.no_grad():
        y = mesh_lib.all_gather_rows(y.transpose(0, 2), mesh.space)
        return mesh_lib.all_gather_rows(y.transpose(0, 2).contiguous(),
                                        mesh.data)
