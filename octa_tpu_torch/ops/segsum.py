"""K3: segment sum — plain PyTorch version, CUDA kernel.

Counterpart of the TPU kernel ``octa_tpu/ops/pallas_segsum.py``
``segsum_onehot_pallas`` (:72, body ``_segsum_kernel`` :42) and of the exact
scatter-add the JAX package uses on the CPU
(``octa_tpu/sim/greenhouse.py:507-508,704-705``):

    out[r, n, f] = sum over s with seg[r, s] == n of feats[r, s, f]

with ``seg`` in ``[0, nc]``; rows on the sentinel ``nc`` contribute nowhere.

:func:`segment_sum` dispatches on the device of its inputs: CPU tensors go to
:func:`segment_sum_plain`, CUDA tensors to the kernel in ``csrc/segsum.cu``,
which is built at first use. There is no fallback from one to the other.

The kernel is one launch: each block owns a tile of nodes of one row, scans
the row's ids in order and adds each of its nodes' values in ascending source
order, starting from 0: the order of a sequential scatter-add. It is therefore
the same from run to run, and equal bit for bit to the plain version on the
CPU. The plain version on a CUDA tensor (``index_add_`` with atomics) adds in
an order that varies.
"""
from __future__ import annotations

import ctypes

import torch

from octa_tpu_torch.ops._cuda import CudaKernel, multiprocessors

_VP, _I = ctypes.c_void_p, ctypes.c_int
SEGSUM = CudaKernel(
    "segsum.cu", "segsum_launch",
    [_VP, _I, _VP, _VP, _I, _I, _I, _I, _I, _VP])
# the tiles (nodes, and threads, of a block) the kernel takes: F = 1,
# F = 18, any other F (in blocks of 4 features)
_TILES = {1: (256, 512, 1024), 18: (256, 512)}


def _check(seg, feats, nc):
    if (seg.dim() != 2 or feats.dim() != 3 or feats.shape[:2] != seg.shape
            or nc < 1):
        raise ValueError(
            "segment_sum: expected seg [R,Sq], feats [R,Sq,F], nc >= 1; got "
            f"{tuple(seg.shape)}, {tuple(feats.shape)}, nc={nc}")
    if seg.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"segment_sum: seg must be int32/int64, got {seg.dtype}")


def segment_sum_plain(seg, feats, nc: int):
    """Plain PyTorch K3: exact scatter-add into ``nc + 1`` rows, the last
    (the drop sentinel's) sliced off.

    seg [R,Sq] integer in [0,nc], feats [R,Sq,F] f32. Returns [R,nc,F] f32.
    """
    _check(seg, feats, nc)
    r, sq = seg.shape
    f = feats.shape[-1]
    base = torch.arange(r, device=seg.device)[:, None] * (nc + 1)
    out = torch.zeros(r * (nc + 1), f, dtype=torch.float32, device=feats.device)
    out.index_add_(0, (seg.long() + base).reshape(-1),
                   feats.float().reshape(r * sq, f))
    return out.reshape(r, nc + 1, f)[:, :nc]


def segsum_plan(nc: int, r: int, f: int, sms: int) -> tuple[int, tuple]:
    """The kernel's launch on a card of ``sms`` SMs: nodes per block and the
    grid (node tiles, R, feature blocks). Every block reads its row's ids
    once, so a larger tile reads them fewer times; take the largest tile
    that still gives about two blocks an SM (a sixteenth of the SMs may
    hold one)."""
    tiles = _TILES.get(f, (256,))
    least = 2 * sms - sms // 16
    fits = [t for t in tiles if -(-nc // t) * r >= least]
    tile = max(fits) if fits else tiles[0]
    return tile, (-(-nc // tile), r, 1 if f in _TILES else -(-f // 4))


def _segsum_cuda(seg, feats, nc):
    dev = feats.device
    if seg.device != dev:
        raise ValueError("segment_sum: inputs on different devices")
    r, sq = seg.shape
    f = feats.shape[-1]
    if r > 65535 or sq >= 1 << 21:
        raise ValueError("segment_sum: at most 65535 rows and 2^21 - 1 "
                         f"sources a row, got {r} and {sq}")
    seg = seg.contiguous()
    feats = feats.float().contiguous()
    tile, _ = segsum_plan(nc, r, f, multiprocessors(dev))
    out = torch.empty((r, nc, f), dtype=torch.float32, device=dev)
    fn = SEGSUM.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(seg.data_ptr(), int(seg.dtype == torch.int64),
                 feats.data_ptr(), out.data_ptr(), r, sq, nc, f, tile, stream)
    if err != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError_t {err}")
    SEGSUM.launches += 1
    return out


def segment_sum(seg, feats, nc: int):
    """Segment sum (K3). Inputs and output as :func:`segment_sum_plain`.

    CPU tensors run the plain version; CUDA tensors launch the hand-written
    kernel (built at first use), or raise.
    """
    if feats.device.type == "cpu":
        return segment_sum_plain(seg, feats, nc)
    if feats.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {feats.device}")
    _check(seg, feats, nc)
    return _segsum_cuda(seg, feats, nc)
