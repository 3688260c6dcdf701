"""The CycleGAN/CUT family's networks, NCHW: the antialiased ResNet
generator with its feature taps, the 70x70 PatchGAN, and the contrastive
heads ``PatchSampleF`` and ``NegativeGenerator``.

Counterpart of ``octa_tpu/models/resnet_gan.py``: ``ResnetBlock`` (:26-43),
``ResnetGenerator`` (:46-149) with ``layers=`` and ``encode_only=``,
``NLayerDiscriminator`` (:152-183), ``resnetGenerator9`` (:186),
``patchGAN70x70`` (:190), ``PatchSampleF`` (:192-235) and
``NegativeGenerator`` (:238-260). Submodules carry the flax module names
(``conv_in``, ``down_conv_0``, ``resblock_3``, ``conv0``, ``mlp_2_1`` ...)
so that :func:`octa_tpu_torch.io.checkpoints.flax_to_state_dict` maps the
JAX checkpoints directly. The generator and the discriminator return
float32 (float64 when their weights are float64). The two heads are flax
``Dense`` layers built without a ``dtype`` in the JAX package, which
compute in float32 whatever the taps' dtype: here they run outside
autocast, in their weights' dtype. JAX builds them lazily from a dry
encode; here their constructors take the channel count of each level
(``in_channels``), which the trainers read from a dry encode.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from octa_tpu_torch.models.layers import (
    BlurDownsample,
    BlurUpsample,
    Conv2d,
    InstanceNorm,
    at_least_float32,
    l2_normalize,
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
    float32 (reference ``networks.py:350-443``).

    The stages are numbered as the reference's ``nn.Sequential``, so that
    the CUT configs' ``nce_layers`` tap the same outputs: 0 the padded
    input, 1 conv7, 2 norm, 3 relu; 4 / 8 the down-convolutions before
    their norm, 5 / 9 norm, 6 / 10 relu, 7 / 11 blur-down; ``12 ..
    11 + n_blocks`` the residual blocks; then per upsampling blur-up, conv3,
    norm, relu; pad, conv7 and the sigmoid last (21-31 with nine blocks).
    """

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

    def _stages(self):
        """The stages in the reference's order, one a layer id."""
        yield lambda h: reflect_pad(h, 3)
        yield from (self.conv_in, self.norm_in, torch.relu)
        for i in range(2):
            yield from (getattr(self, f"down_conv_{i}"),
                        getattr(self, f"down_norm_{i}"), torch.relu,
                        getattr(self, f"down_blur_{i}"))
        for i in range(self.n_blocks):
            yield getattr(self, f"resblock_{i}")
        for i in range(2):
            yield from (getattr(self, f"up_blur_{i}"),
                        getattr(self, f"up_conv_{i}"),
                        getattr(self, f"up_norm_{i}"), torch.relu)
        yield lambda h: reflect_pad(h, 3)
        yield self.conv_out
        yield lambda h: torch.sigmoid(at_least_float32(h))

    def forward(self, x, layers: Sequence[int] | None = None,
                encode_only: bool = False):
        """x: [B, input_nc, H, W] -> [B, output_nc, H, W] in (0, 1). With
        ``layers``, also the outputs of those stages in the order they come:
        ``(image, feats)``; with ``encode_only`` as well, the pass stops
        after the stage ``layers[-1]`` and returns ``feats`` alone."""
        taps = list(layers) if layers else []
        feats = []
        h = x
        for layer_id, stage in enumerate(self._stages()):
            h = stage(h)
            if layer_id in taps:
                feats.append(h)
            if encode_only and taps and layer_id == taps[-1]:
                return feats
        return (h, feats) if taps else h


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


def _mlp(module: nn.Module, level: int, x: torch.Tensor) -> torch.Tensor:
    """The two ``Dense`` layers of ``level`` with a ReLU between them, in
    their weights' dtype and outside autocast (flax ``Dense`` with no
    ``dtype``)."""
    fc0 = getattr(module, f"mlp_{level}_0")
    fc1 = getattr(module, f"mlp_{level}_1")
    with torch.autocast(x.device.type, enabled=False):
        return fc1(torch.relu(fc0(x.to(fc0.weight.dtype))))


class PatchSampleF(nn.Module):
    """The MLP patch projector of PatchNCE (reference ``networks.py:
    905-955``): for each level's tap [B, C, H, W], the positions
    ``patch_ids[level]`` (indices into the row-major H x W grid, the same
    for every sample), through the level's two-layer MLP ``mlp_{level}_0``
    / ``mlp_{level}_1`` of width ``nc``, L2-normalised: [B * P, nc], sample
    after sample. With ``num_patches == 0`` every position, returned as
    [B, H, W, nc] (channels last, as the JAX package returns it)."""

    def __init__(self, in_channels: Sequence[int], nc: int = 256,
                 use_mlp: bool = True):
        super().__init__()
        self.use_mlp = use_mlp
        self.out_channels = [nc if use_mlp else c for c in in_channels]
        if use_mlp:
            for level, c in enumerate(in_channels):
                setattr(self, f"mlp_{level}_0", nn.Linear(c, nc))
                setattr(self, f"mlp_{level}_1", nn.Linear(nc, nc))

    def forward(self, feats: Sequence[torch.Tensor],
                patch_ids: Sequence[torch.Tensor] | None,
                num_patches: int = 256):
        """``(samples, ids)``: a list of projections and the ids used (None
        a level with ``num_patches == 0``)."""
        out_feats, out_ids = [], []
        for level, feat in enumerate(feats):
            b, c, h, w = feat.shape
            flat = at_least_float32(feat).flatten(2).transpose(1, 2)
            if num_patches > 0:
                ids = patch_ids[level]
                sample = flat[:, ids].reshape(-1, c)
            else:
                ids = None
                sample = flat.reshape(-1, c)
            if self.use_mlp:
                sample = _mlp(self, level, sample)
            sample = l2_normalize(sample)
            if num_patches == 0:
                sample = sample.reshape(b, h, w, -1)
            out_feats.append(sample)
            out_ids.append(ids)
        return out_feats, out_ids


class NegativeGenerator(nn.Module):
    """NEGCUT's adversarial negatives (reference ``networks.py:960-1006``):
    for each level, the spatial mean of its pool [B, ..., C] (a
    ``PatchSampleF`` output over every position), beside standard normal
    noise [B, num_patches, z_dim], through the level's two-layer MLP
    ``mlp_{level}_0`` / ``mlp_{level}_1`` of width ``nc``, L2-normalised:
    [B * num_patches, nc]. The noise of level ``l`` is ``noise[l]`` where
    given (the tests fill it with the JAX package's draws), else drawn from
    ``generator`` level after level."""

    def __init__(self, in_channels: Sequence[int], nc: int = 256,
                 z_dim: int = 64):
        super().__init__()
        self.z_dim = z_dim
        for level, c in enumerate(in_channels):
            setattr(self, f"mlp_{level}_0", nn.Linear(c + z_dim, nc))
            setattr(self, f"mlp_{level}_1", nn.Linear(nc, nc))

    def forward(self, pools: Sequence[torch.Tensor], num_patches: int,
                generator: torch.Generator | None = None,
                noise: Sequence[torch.Tensor] | None = None):
        out = []
        for level, pool in enumerate(pools):
            b, c = pool.shape[0], pool.shape[-1]
            dtype = getattr(self, f"mlp_{level}_0").weight.dtype
            if noise is not None:
                z = noise[level].to(pool.device, dtype)
            else:
                z = torch.randn((b, num_patches, self.z_dim),
                                generator=generator, device=pool.device,
                                dtype=dtype)
            pooled = pool.reshape(b, -1, c).to(dtype).mean(1)
            inp = torch.cat([pooled[:, None].expand(b, num_patches, c), z],
                            -1).reshape(b * num_patches, -1)
            out.append(l2_normalize(_mlp(self, level, inp)))
        return out
