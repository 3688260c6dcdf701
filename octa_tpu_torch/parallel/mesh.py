"""Process groups for data parallelism over several cards.

Counterpart of ``octa_tpu/parallel/mesh.py``. The JAX package runs one
program over a ``data`` mesh of devices and lets XLA insert the collectives;
here every card has a process of its own (``python -m
torch.distributed.run --nproc_per_node N``), and the collectives are
explicit ``torch.distributed`` calls: NCCL for CUDA tensors, gloo for CPU
tensors (the tests). A CUDA run never falls back to gloo.

- :func:`get_mesh` — the group of ranks that work on a batch, with JAX's
  divisor rule (batch 6 on 4 ranks uses the first 3); ``None`` when the
  process runs alone;
- :func:`shard_of` / :class:`Shard` — a rank's rows of dim 0 (JAX's
  ``P("data")``), and the global batch gathered back;
- :func:`replicated` — parameters, buffers and optimizer state broadcast
  from the group's first rank (JAX's ``P()``);
- :func:`mean_gradients` — every optimizer step takes the mean of its
  gradients over the group first, one flat buffer per dtype (XLA's psum);
- :func:`global_sums` — a batch-wide loss's sums over the global batch,
  one all-reduce a call;
- :func:`launch` — run a function in N processes on one host (the tests,
  ``chip_smoke.py``), with a ``file://`` rendezvous and a timeout on every
  collective and on the join.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

#: seconds a collective may wait before it fails the run
TIMEOUT_S = 1800.0

#: the process groups made in this process (every rank makes them alike),
#: by member count or spatial grid
_GROUPS: dict = {}
_OWNED = False  # the process group was made by get_mesh (shutdown ends it)


@dataclass
class Mesh:
    """The ranks that share a batch: ``group`` (``None`` for the default
    group), this process's ``rank`` in it (-1 outside it), its ``size``, the
    global ranks of its members and the device its tensors live on.
    ``timings``, where a list, receives ``(what, bytes, seconds)`` of every
    collective the trainers and the spatial layers run (each timed between
    two device synchronizations: only for measuring)."""

    group: object
    rank: int
    size: int
    device: torch.device
    ranks: tuple = ()
    timings: list | None = field(default=None, repr=False)

    @property
    def member(self) -> bool:
        return self.rank >= 0

    def src(self) -> int:
        """The global rank of the group's first member."""
        return self.ranks[0]

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def _mesh_device(device) -> torch.device:
    """The device of this rank's tensors for the running backend; a CUDA
    device with gloo (or the CPU with NCCL) raises."""
    device = torch.device(device)
    backend = dist.get_backend()
    if device.type == "cuda":
        if backend != "nccl":
            raise RuntimeError(
                f"octa_tpu_torch.parallel: CUDA tensors need the NCCL backend, "
                f"the process group runs {backend!r}")
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl":
        raise RuntimeError("octa_tpu_torch.parallel: the process group runs "
                           "NCCL, which takes CUDA tensors only; pass "
                           "device='cuda'")
    return torch.device("cpu")


def init_from_env(device="cuda") -> None:
    """Join the process group that ``torch.distributed.run`` describes in
    the environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``): NCCL on ``cuda:LOCAL_RANK`` for the
    card, gloo for the CPU."""
    global _OWNED
    device = torch.device(device)
    if device.type == "cuda":
        from octa_tpu_torch.device import resolve_device

        resolve_device(device)
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"octa_tpu_torch.parallel: LOCAL_RANK {local} but only "
                f"{torch.cuda.device_count()} cards are visible")
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _OWNED = True


def get_mesh(batch_size: int | None = None, device="cuda") -> Mesh | None:
    """The data-parallel mesh over every rank, or with ``batch_size`` over
    the first ranks, as many as the largest count that divides it (JAX's
    rule, ``octa_tpu/parallel/mesh.py:17-25``); the ranks beyond it are
    outside the mesh and take no steps. ``None`` when the process
    runs alone (no process group, and ``WORLD_SIZE`` unset or 1). A process
    group made elsewhere (:func:`launch`, a world of one) is used as it is.
    """
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        init_from_env(device)
    dev = _mesh_device(device)
    world = dist.get_world_size()
    n = world
    if batch_size:
        while n > 1 and batch_size % n != 0:
            n -= 1
    if n not in _GROUPS:
        # every rank makes every group, in the same order
        _GROUPS[n] = None if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return Mesh(_GROUPS[n], rank if rank < n else -1, n, dev,
                tuple(range(n)))


def shutdown() -> None:
    """End the process group if :func:`get_mesh` started it."""
    global _OWNED
    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED = False
    _GROUPS.clear()


def broadcast_object(obj):
    """``obj`` of global rank 0 on every rank of the default group (itself
    where there is no process group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else None)
    dist.broadcast_object_list(box, src=0, device=dev)
    return box[0]


def read_on_first(mesh: Mesh | None, read):
    """``read()`` run by the mesh's first rank and its result handed to
    every member (a checkpoint read once on a shared file system)."""
    if mesh is None or not mesh.member or mesh.size == 1:
        return read()
    box = [read() if mesh.rank == 0 else None]
    dist.broadcast_object_list(
        box, src=mesh.src(), group=mesh.group,
        device=mesh.device if mesh.device.type == "cuda" else None)
    return box[0]


# ---------------------------------------------------------------------------
# rows of a batch
# ---------------------------------------------------------------------------

@dataclass
class Shard:
    """Rank ``mesh.rank``'s rows ``lo:hi`` of a global batch of ``n``."""

    mesh: Mesh
    n: int

    @property
    def lo(self) -> int:
        return self.mesh.rank * (self.n // self.mesh.size)

    @property
    def hi(self) -> int:
        return self.lo + self.n // self.mesh.size

    def take(self, x):
        """This rank's rows of a global tensor ``x``."""
        return x[self.lo:self.hi]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's rows ``x`` (no gradient)."""
        return all_gather_rows(x, self.mesh)


def shard_of(mesh: Mesh | None, n: int) -> Shard | None:
    """The rows of a global batch of ``n`` this rank keeps, or ``None``
    where it keeps them all: no mesh, a mesh of one, or ``n`` that does not
    divide it (the batch then runs whole on every rank, as ``shard_array``
    replicates it, ``octa_tpu/train/algorithms.py:102-109``)."""
    if mesh is None or not mesh.member or mesh.size == 1 or n % mesh.size:
        return None
    return Shard(mesh, n)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def timed(mesh: Mesh, what: str, nbytes: int):
    """A context that appends ``(what, nbytes, seconds)`` to
    ``mesh.timings`` when it is a list: the collective alone, between a
    barrier of the mesh (the ranks' skew stays out) and a synchronization
    of the device."""
    import contextlib

    if mesh.timings is None:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def clock():
        sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
                else (lambda: None))
        sync()
        if mesh.size > 1:
            mesh.barrier()
            sync()
        t0 = time.perf_counter()
        yield
        sync()
        mesh.timings.append((what, nbytes, time.perf_counter() - t0))

    return clock()


def _coalesced(tensors, mesh: Mesh, op, what: str) -> None:
    """Run ``op(flat)`` on one flat buffer per dtype on the mesh's device
    and write the result back into ``tensors``."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device)
                          for t in ts])
        with timed(mesh, what, flat.numel() * flat.element_size()):
            op(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.detach().copy_(part.view_as(t))


def all_reduce_(tensors, mesh: Mesh, op=dist.ReduceOp.SUM,
                what: str = "all_reduce") -> None:
    """Reduce ``tensors`` over the mesh in place."""
    _coalesced(tensors, mesh,
               lambda flat: dist.all_reduce(flat, op=op, group=mesh.group),
               what)


def mean_(tensors, mesh: Mesh, what: str = "mean") -> None:
    """The mean of ``tensors`` over the mesh, in place."""
    def op(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)

    _coalesced(tensors, mesh, op, what)


class _GlobalSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, parts, mesh):
        ctx.size = mesh.size
        out = parts.detach().clone()
        all_reduce_([out], mesh, what="loss_sums")
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.size, None


def global_sums(parts: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """``parts``, sums over this rank's rows of a batch, summed over the
    global batch: one all-reduce over the shard's mesh (``parts`` itself
    without a shard). A loss that is a ratio of sums over the batch (soft
    clDice, the weighted losses, QWK) stacks the sums it divides and calls
    this once, so every rank computes the global batch's loss, as XLA's
    SPMD step does (``octa_tpu/train/algorithms.py:87-109``).

    The gradient rule: :func:`mean_gradients` averages the ranks'
    gradients, so a rank's loss must have N (the mesh's size) times its
    share of the global loss's gradient, as the mean over its rows of a
    per-sample loss already has. The backward pass therefore multiplies by
    N and runs no collective (an all-reduce of the gradient, as
    ``torch.distributed.nn.functional.all_reduce`` runs, would give the
    same factor with a second collective). ``ANTLoss``'s ascent scale
    B_local / B_global assumes the same rule and needs nothing else."""
    if shard is None:
        return parts
    return _GlobalSums.apply(parts, shard.mesh)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    with timed(mesh, "all_gather", x.numel() * x.element_size()):
        dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, 0)


def replicated(mesh: Mesh, modules=(), optimizers=()) -> None:
    """Broadcast the parameters and buffers of ``modules`` and the state of
    ``optimizers`` from the mesh's first rank to every member."""
    tensors = [t for m in modules
               for t in list(m.parameters()) + list(m.buffers())]
    for opt in optimizers:
        for state in opt.state.values():
            tensors += [v for v in state.values() if torch.is_tensor(v)]
    _coalesced(tensors, mesh,
               lambda flat: dist.broadcast(flat, src=mesh.src(),
                                           group=mesh.group), "broadcast")


def mean_gradients(optimizer: torch.optim.Optimizer, mesh: Mesh):
    """Before every ``optimizer.step()``, replace the gradients of its
    parameters with their mean over the mesh (one flat buffer per dtype).
    A step's loss is the mean over the rank's rows, so the mean of the
    ranks' gradients is the gradient of the global batch's loss. Returns
    the hook's handle."""
    def hook(opt, args, kwargs):
        grads = [p.grad for group in opt.param_groups for p in group["params"]
                 if p.grad is not None]
        mean_(grads, mesh, "gradients")

    return optimizer.register_step_pre_hook(hook)


# ---------------------------------------------------------------------------
# processes on one host
# ---------------------------------------------------------------------------

def _worker(rank, fn, args, world, backend, rdv, timeout, threads):
    global _OWNED
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(rdv, 'rendezvous')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    _OWNED = False
    try:
        out = fn(*args)
        torch.save(out, os.path.join(rdv, f"result_{rank}.pt"))
        # no rank leaves while another still connects to it (a group made
        # last is set up pairwise, and a peer that exits closes its pairs)
        dist.barrier(device_ids=[rank] if backend == "nccl" else None)
    finally:
        _GROUPS.clear()
        dist.destroy_process_group()


def launch(fn, nprocs: int, *args, backend: str = "gloo",
           timeout: float = 60.0, join_timeout: float = 120.0,
           threads: int = 1, tmp_dir: str | None = None) -> list:
    """Run ``fn(*args)`` in ``nprocs`` new processes (spawned), rank ``r``
    on ``cuda:r`` for NCCL, and return their results in rank order.

    The processes meet through a file under ``tmp_dir`` (no port to race
    for), every collective fails after ``timeout`` seconds, and the whole
    run after ``join_timeout``: a rank that fails or hangs ends every rank
    and raises here. ``fn`` must be importable by name (a module's
    function); its result must pickle."""
    import torch.multiprocessing as mp

    if backend == "nccl" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"launch: {nprocs} NCCL ranks need {nprocs} "
                           f"cards, {torch.cuda.device_count()} are visible")
    rdv = tempfile.mkdtemp(prefix="mesh_", dir=tmp_dir)
    try:
        ctx = mp.start_processes(
            _worker, args=(fn, args, nprocs, backend, rdv, timeout, threads),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + join_timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"launch: {nprocs} ranks of {fn.__name__} did not "
                        f"finish in {join_timeout:.0f} s")
        except BaseException:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            raise
        return [torch.load(os.path.join(rdv, f"result_{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
