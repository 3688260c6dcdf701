"""Antialiased ResNet generator and 70x70 PatchGAN (CycleGAN/CUT family), NCHW.

Counterpart of ``octa_tpu/models/resnet_gan.py``: ``ResnetBlock`` (:26-43),
``ResnetGenerator`` (:46-149), ``NLayerDiscriminator`` (:152-183),
``resnetGenerator9`` (:186) and ``patchGAN70x70`` (:190). Submodules carry
the flax module names (``conv_in``, ``down_conv_0``, ``resblock_3``,
``conv0`` ...) so that :func:`octa_tpu_torch.io.checkpoints.flax_to_state_dict`
maps the JAX checkpoints directly. Both networks return float32 (float64
when their weights are float64). The CUT feature taps (``layers=``) are not
ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from octa_tpu_torch.models.layers import (
    BlurDownsample,
    BlurUpsample,
    Conv2d,
    InstanceNorm,
    at_least_float32,
    reflect_pad,
)


class ResnetBlock(nn.Module):
    """Reflect-padded residual block (reference ``networks.py:291-348``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, 3)
        self.norm1 = InstanceNorm(dim)
        self.conv2 = Conv2d(dim, dim, 3)
        self.norm2 = InstanceNorm(dim)

    def forward(self, x):
        h = torch.relu(self.norm1(self.conv1(reflect_pad(x, 1))))
        h = self.norm2(self.conv2(reflect_pad(h, 1)))
        return x + h


class ResnetGenerator(nn.Module):
    """pad-conv7-norm-relu, 2x (conv3-norm-relu-blurdown), ``n_blocks``
    residual blocks, 2x (blurup-conv3-norm-relu), pad-conv7, sigmoid in
    float32 (reference ``networks.py:350-443``)."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 64,
                 n_blocks: int = 9):
        super().__init__()
        self.conv_in = Conv2d(input_nc, ngf, 7)
        self.norm_in = InstanceNorm(ngf)
        for i in range(2):
            mult = 2 ** i
            setattr(self, f"down_conv_{i}",
                    Conv2d(ngf * mult, ngf * mult * 2, 3, padding=1))
            setattr(self, f"down_norm_{i}", InstanceNorm(ngf * mult * 2))
            setattr(self, f"down_blur_{i}", BlurDownsample())
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            setattr(self, f"resblock_{i}", ResnetBlock(ngf * 4))
        for i in range(2):
            mult = 2 ** (2 - i)
            setattr(self, f"up_blur_{i}", BlurUpsample())
            setattr(self, f"up_conv_{i}",
                    Conv2d(ngf * mult, ngf * mult // 2, 3, padding=1))
            setattr(self, f"up_norm_{i}", InstanceNorm(ngf * mult // 2))
        self.conv_out = Conv2d(ngf, output_nc, 7)

    def forward(self, x):
        """x: [B, input_nc, H, W] -> [B, output_nc, H, W] in (0, 1)."""
        h = torch.relu(self.norm_in(self.conv_in(reflect_pad(x, 3))))
        for i in range(2):
            h = getattr(self, f"down_conv_{i}")(h)
            h = torch.relu(getattr(self, f"down_norm_{i}")(h))
            h = getattr(self, f"down_blur_{i}")(h)
        for i in range(self.n_blocks):
            h = getattr(self, f"resblock_{i}")(h)
        for i in range(2):
            h = getattr(self, f"up_blur_{i}")(h)
            h = getattr(self, f"up_conv_{i}")(h)
            h = torch.relu(getattr(self, f"up_norm_{i}")(h))
        h = self.conv_out(reflect_pad(h, 3))
        return torch.sigmoid(at_least_float32(h))


class NLayerDiscriminator(nn.Module):
    """Antialiased PatchGAN (reference ``networks.py:445-500``): each 4x4
    convolution is a zero pad of 1 on each side and a VALID conv, so it
    shrinks the map by one pixel; leaky ReLU 0.2; a blur-downsampling after
    ``conv0`` and after each inner layer, none after ``conv{n_layers}``."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = Conv2d(input_nc, ndf, 4)
        self.blur0 = BlurDownsample()
        nf = ndf
        for n in range(1, n_layers + 1):
            nf_next = ndf * min(2 ** n, 8)
            setattr(self, f"conv{n}", Conv2d(nf, nf_next, 4))
            setattr(self, f"norm{n}", InstanceNorm(nf_next))
            if n < n_layers:
                setattr(self, f"blur{n}", BlurDownsample())
            nf = nf_next
        self.conv_out = Conv2d(nf, 1, 4)

    def forward(self, x):
        """x: [B, input_nc, H, W] -> [B, 1, H', W'] patch scores."""
        h = F.leaky_relu(self.conv0(F.pad(x, (1, 1, 1, 1))), 0.2)
        h = self.blur0(h)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(F.pad(h, (1, 1, 1, 1)))
            h = F.leaky_relu(getattr(self, f"norm{n}")(h), 0.2)
            if n < self.n_layers:
                h = getattr(self, f"blur{n}")(h)
        return at_least_float32(self.conv_out(F.pad(h, (1, 1, 1, 1))))


def resnetGenerator9(**kw):
    return ResnetGenerator(input_nc=1, output_nc=1, ngf=64, n_blocks=9, **kw)


def patchGAN70x70(**kw):
    return NLayerDiscriminator(input_nc=1, ndf=64, n_layers=3, **kw)
