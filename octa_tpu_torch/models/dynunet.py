"""DynUNet (nnU-Net style), canonical path, NCHW.

Counterpart of ``octa_tpu/models/dynunet.py``: ``default_filters`` (:43),
``CanonConv`` in direct mode (:122), ``UnetBasicBlock`` (:172),
``UnetUpBlock`` (:202) and ``DynUNet`` (:259). Convolutions pad ``k // 2``
per side as torch does, which is what ``dynunet.py:16-18`` emulates at
stride 2. The space-to-depth path (:20-120) is an exact layout rewrite for
the TPU and is not ported. Submodule names follow the flax module names.

``remat=True`` (the JAX module's ``nn.remat`` of every basic and up block,
:259) recomputes each block's activations in the backward pass through
``torch.utils.checkpoint`` (``use_reentrant=False``), when gradients are
being recorded.

The JAX module's ``axis_name`` (:148-153, 226-229), which makes the network
take a block of image rows on each rank of a group, is set for the length
of an inference by :func:`octa_tpu_torch.parallel.spatial.sharded`
(``models.layers.set_space``): :mod:`octa_tpu_torch.parallel.spatial`
holds the halo-exchanged convolutions and the group-wide instance norms,
and ``dynunet_spatial_infer`` runs a model on a (data, space) grid.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from octa_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    InstanceNorm,
    at_least_float32,
)


def default_filters(n: int) -> list[int]:
    return [min(2 ** (5 + i), 320) for i in range(n)]


def CanonConv(cin: int, cout: int, kernel_size: int, stride: int = 1,
              use_bias: bool = False) -> Conv2d:
    """Direct-mode ``CanonConv``: torch padding ``k // 2`` per side."""
    return Conv2d(cin, cout, kernel_size, stride=stride,
                  padding=kernel_size // 2, bias=use_bias)


class UnetBasicBlock(nn.Module):
    """[conv(k, s) + InstanceNorm(affine) + LeakyReLU(0.01)], then the same
    at stride 1."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope
        self.conv1 = CanonConv(cin, features, kernel_size, stride)
        self.norm1 = InstanceNorm(features, affine=True)
        self.conv2 = CanonConv(features, features, kernel_size, 1)
        self.norm2 = InstanceNorm(features, affine=True)

    def forward(self, x):
        x = F.leaky_relu(self.norm1(self.conv1(x)), self.negative_slope)
        return F.leaky_relu(self.norm2(self.conv2(x)), self.negative_slope)


class UnetUpBlock(nn.Module):
    """Transposed conv (kernel ``up_kernel``, stride ``up_stride``, no bias)
    -> concat skip -> :class:`UnetBasicBlock` at stride 1."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 up_stride: int = 2, up_kernel: int = 2):
        super().__init__()
        if up_kernel != up_stride:
            raise ValueError("only up_kernel == up_stride is ported "
                             f"(got kernel {up_kernel}, stride {up_stride})")
        self.transp_conv = ConvTranspose2d(cin, features, up_kernel,
                                           stride=up_stride, bias=False)
        self.conv_block = UnetBasicBlock(2 * features, features, kernel_size)

    def forward(self, x, skip):
        x = self.transp_conv(x)
        return self.conv_block(torch.cat([x, skip.to(x.dtype)], dim=1))


class DynUNet(nn.Module):
    """2D dynamic U-Net with MONAI's topology as the reference configures it
    (kernel [3]*5, strides [1,2,2,2,1], upsample [1,2,2,2,1]). Returns
    float32 logits [B, out_channels, H, W] (float64 for float64 weights)."""

    def __init__(self, spatial_dims: int = 2, in_channels: int = 1,
                 out_channels: int = 1,
                 kernel_size: Sequence[int] = (3, 3, 3, 3, 3),
                 strides: Sequence[int] = (1, 2, 2, 2, 1),
                 upsample_kernel_size: Sequence[int] = (1, 2, 2, 2, 1),
                 filters: Sequence[int] | None = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        if spatial_dims != 2:
            raise NotImplementedError("only spatial_dims=2 is implemented")
        n = len(strides)
        f = list(filters) if filters else default_filters(n)
        ks, st = list(kernel_size), list(strides)
        self.strides = st
        self.input_block = UnetBasicBlock(in_channels, f[0], ks[0], st[0])
        self.n_down = n - 2
        for i in range(1, n - 1):
            setattr(self, f"downsample_{i - 1}",
                    UnetBasicBlock(f[i - 1], f[i], ks[i], st[i]))
        self.bottleneck = UnetBasicBlock(f[-2], f[-1], ks[-1], st[-1])
        up_strides = st[1:][::-1]
        upk = list(upsample_kernel_size)[::-1]
        self.n_up = n - 1
        for j, i in enumerate(range(n - 1, 0, -1)):
            up_kernel = max(upk[j] if j < len(upk) else up_strides[j],
                            up_strides[j])
            setattr(self, f"upsample_{j}",
                    UnetUpBlock(f[i], f[i - 1], ks[i - 1],
                                up_stride=up_strides[j], up_kernel=up_kernel))
        self.output_block = CanonConv(f[0], out_channels, 1, use_bias=True)

    def _block(self, block: nn.Module, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, x):
        h = self._block(self.input_block, x)
        skips = [h]
        for i in range(self.n_down):
            h = self._block(getattr(self, f"downsample_{i}"), h)
            skips.append(h)
        h = self._block(self.bottleneck, h)
        for j in range(self.n_up):
            h = self._block(getattr(self, f"upsample_{j}"), h, skips[-1 - j])
        return at_least_float32(self.output_block(h))
