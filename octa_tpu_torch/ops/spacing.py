"""K6: blocked greedy spacing of growth's candidate sinks — plain PyTorch
version, CUDA kernel.

Counterpart of ``octa_tpu/sim/greenhouse.py::_blocked_greedy_spacing``
(:313), a ``lax.scan`` over 64 blocks; no TPU kernel computes it. For each
row of candidates ``pos [..., n, 3]`` with ``valid [..., n]`` and a distance
``eps`` (a scalar or one a row), in ``n_blocks`` blocks of ``bs = ceil(n /
n_blocks)`` candidates:

- a candidate is *ok* when it is valid and no earlier valid candidate of its
  own block lies within ``eps`` (the conservative rule inside a block);
- the blocks are then taken in order, and an ok candidate is accepted when
  no candidate accepted in an earlier block lies within ``eps``;

where two candidates are within ``eps`` when the norm of their difference
``d``, ``sqrt(sum(d * d))``, is at most ``eps``.

:func:`blocked_greedy_spacing` dispatches on the device of its inputs: CPU
tensors go to :func:`spacing_plain`, CUDA tensors to the kernel in
``csrc/spacing.cu``, which is built at first use. There is no fallback from
one to the other. The kernel is one launch a call, one block of threads a
row, and writes no pairwise tensor; its arithmetic is the plain version's
on the card, each operation correctly rounded and none fused, the sum over
the three axes in the order of PyTorch's reduction there (``(x + z) +
y``), so both reach the same decisions bit for bit.
"""
from __future__ import annotations

import ctypes
import math

import torch

from octa_tpu_torch.ops._cuda import CudaKernel, on_device, stream_handle

_VP, _I = ctypes.c_void_p, ctypes.c_int
SPACING = CudaKernel(
    "spacing.cu", "spacing_launch",
    [_VP, _VP, _VP, _I, _VP, _I, _I, _I, _I, _I, _I, _I, _VP])

#: shared memory a block may use on an H100, and threads a block at most
MAX_SHARED, MAX_THREADS = 232448, 1024


def _check(pos, valid):
    if pos.dim() < 2 or pos.shape[-1] != 3 or valid.shape != pos.shape[:-1]:
        raise ValueError(
            "blocked_greedy_spacing: expected pos [..., n, 3] and valid "
            f"[..., n]; got {tuple(pos.shape)}, {tuple(valid.shape)}")
    if pos.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("blocked_greedy_spacing: pos must be float32 and "
                         f"valid bool, got {pos.dtype} and {valid.dtype}")


def _vnorm(v):
    return torch.sqrt((v * v).sum(-1))


def spacing_plain(pos, valid, eps_s, n_blocks=64):
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


def spacing_plan(n: int, n_blocks: int = 64) -> tuple[int, int, bool]:
    """The kernel's launch for rows of ``n`` candidates: threads a block
    (one a candidate up to 1024, in whole warps), shared bytes, and whether
    the row's positions are staged in shared memory (where they fit beside
    the ok bytes and the double-buffered list of a round's acceptances) or
    read through L1 / L2. Depends on ``n`` and ``n_blocks`` only."""
    bs = -(-n // n_blocks)
    bs4 = -(-bs // 4) * 4  # a round's new entries, padded to a multiple of 4
    threads = min(MAX_THREADS, 32 * max(1, -(-n // 32)))
    base = 8 + 24 * bs4 + n  # counts, the round's new entries, ok bytes
    staged = base + 12 * n <= MAX_SHARED
    smem = base + 12 * n if staged else base
    if smem > MAX_SHARED:
        raise ValueError(f"blocked_greedy_spacing: n = {n} candidates a row "
                         f"need {smem} bytes of shared memory, more than "
                         f"{MAX_SHARED}")
    return threads, smem, staged


def _spacing_cuda(pos, valid, eps_s, n_blocks):
    dev = pos.device
    if valid.device != dev:
        raise ValueError("blocked_greedy_spacing: inputs on different devices")
    lead = pos.shape[:-2]
    n = pos.shape[-2]
    r = math.prod(lead)
    out = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    if r == 0 or n == 0:
        return out
    if r > 2 ** 31 - 1:
        raise ValueError(f"blocked_greedy_spacing: {r} rows, at most 2^31 - 1")
    threads, smem, staged = spacing_plan(n, n_blocks)
    pos = pos.contiguous()
    valid = valid.contiguous()
    eps = torch.as_tensor(eps_s, dtype=torch.float32, device=dev)
    stride = int(eps.numel() != 1)  # 0: one eps for every row
    if stride:
        eps = eps.expand(lead).reshape(r).contiguous()
    fn = SPACING.function()
    with on_device(dev):
        err = fn(pos.data_ptr(), valid.data_ptr(), eps.data_ptr(), stride,
                 out.data_ptr(), r, n, -(-n // n_blocks), n_blocks, threads,
                 int(staged), smem, stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"spacing kernel launch failed: cudaError_t {err}")
    SPACING.launches += 1
    return out


def blocked_greedy_spacing(pos, valid, eps_s, n_blocks=64):
    """Blocked greedy spacing (K6). Inputs and output as
    :func:`spacing_plain`: bool ``[..., n]``, the accepted candidates.

    CPU tensors run the plain version; CUDA tensors launch the hand-written
    kernel (built at first use), or raise.
    """
    _check(pos, valid)
    if pos.device.type == "cpu":
        return spacing_plain(pos, valid, eps_s, n_blocks)
    if pos.device.type != "cuda":
        raise ValueError(
            f"blocked_greedy_spacing: unsupported device {pos.device}")
    return _spacing_cuda(pos, valid, eps_s, n_blocks)
