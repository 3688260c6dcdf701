"""Shared layers: instance norm, padding, antialiased blur down/upsampling.

Counterpart of ``octa_tpu/models/layers.py``: ``InstanceNorm`` (:22),
``reflect_pad`` (:122), ``replicate_pad`` (:127), ``BlurDownsample`` (:147),
``BlurUpsample`` (:174-204), in NCHW, and ``l2_normalize`` (:284-287).

Mixed precision follows the JAX package: convolutions run in the dtype of
their weights (:func:`set_conv_dtype` casts only conv weights), and instance
norm computes its statistics and affine in float32 and returns the input's
dtype.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 if it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _conv_input(x, weight):
    """The input cast to the weight's dtype, as flax ``nn.Conv(dtype=...)``
    does; under autocast the cast is autocast's."""
    if torch.is_autocast_enabled(x.device.type):
        return x
    return x.to(weight.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that casts its input to its weight's dtype."""

    def forward(self, x):
        return super().forward(_conv_input(x, self.weight))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that casts its input to its weight's dtype."""

    def forward(self, x):
        return super().forward(_conv_input(x, self.weight))


def kaiming_normal_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisation (``layers.py:18``, variance scaling
    2.0, fan-in, normal; zero biases), drawn from ``generator`` in module
    order: a conv kernel [kh, kw, in, out] has fan-in ``kh*kw*in``, for a
    transposed conv too; a ``Dense`` kernel (``nn.Linear``) has fan-in
    ``in_features``. Instance-norm scales stay 1 and shifts 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
                fan_in = cin * w.shape[2] * w.shape[3]
            elif isinstance(m, nn.Linear):
                w, fan_in = m.weight, m.in_features
            else:
                continue
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=generator.device) * (2.0 / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
    return module


def set_conv_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the weights of every conv in ``module`` to ``dtype`` (in place);
    norm parameters stay float32."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype)
    return module


class InstanceNorm(nn.Module):
    """Instance norm over H, W: eps 1e-5, biased variance, statistics (and
    affine) in float32, output in the input's dtype. ``affine=False`` is the
    GAN networks' norm, ``affine=True`` DynUNet's; ``weight`` is flax's
    ``scale``."""

    def __init__(self, num_features: int, affine: bool = False,
                 eps: float = 1e-5):
        super().__init__()
        self.affine = affine
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        x32 = at_least_float32(x)
        var, mean = torch.var_mean(x32, dim=(2, 3), keepdim=True,
                                   correction=0)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * at_least_float32(self.weight)[:, None, None] \
                + at_least_float32(self.bias)[:, None, None]
        return y.to(x.dtype)


def reflect_pad(x, pad: int):
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def replicate_pad(x, pad: int):
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")


def _binomial_filter(size: int) -> np.ndarray:
    row = np.asarray({3: [1.0, 2.0, 1.0], 4: [1.0, 3.0, 3.0, 1.0]}[size])
    f = row[:, None] * row[None, :]
    return (f / f.sum()).astype(np.float32)


class BlurDownsample(nn.Module):
    """Antialiased stride-2 downsampling (reference ``Downsample``,
    ``networks.py:266-289``): reflect pad (1, 1), depthwise
    [1,2,1]x[1,2,1]/16 conv at stride 2."""

    def __init__(self):
        super().__init__()
        self.register_buffer(
            "filt", torch.from_numpy(_binomial_filter(3))[None, None],
            persistent=False)

    def forward(self, x):
        c = x.shape[1]
        w = self.filt.to(x.dtype).expand(c, 1, 3, 3)
        return F.conv2d(reflect_pad(x, 1), w, stride=2, groups=c)


class BlurUpsample(nn.Module):
    """Antialiased 2x upsampling (reference ``Upsample``,
    ``networks.py:244-264``): replicate pad 1, depthwise transposed conv with
    the binomial-4 filter times 4 (stride 2, padding 2), crop [1:-1, 1:-1]."""

    def __init__(self):
        super().__init__()
        self.register_buffer(
            "filt", torch.from_numpy(_binomial_filter(4) * 4.0)[None, None],
            persistent=False)

    def forward(self, x):
        c = x.shape[1]
        w = self.filt.to(x.dtype).expand(c, 1, 4, 4)
        y = F.conv_transpose2d(replicate_pad(x, 1), w, stride=2, padding=2,
                               groups=c)
        return y[:, :, 1:-1, 1:-1]


def l2_normalize(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """``x / (sum(|x|^2)^(1/2) + eps)`` over the last axis (the JAX
    package's ``l2_normalize``, ``layers.py:284-287``; reference
    ``Normalize``)."""
    return x / (x.abs().pow(2).sum(-1, keepdim=True).pow(0.5) + eps)
