"""NICE-GAN's networks, NCHW: the decoder generator with adaILN and the
discriminator whose trunk is the translation encoder.

Counterpart of ``octa_tpu/models/nice_gan_nets.py``: ``ResnetAdaILNBlock``
(:19-38), ``pixel_shuffle`` (:41-47), ``NiceResnetGenerator`` (:50-109) and
``NiceDiscriminator`` (:112-175). Submodules carry the flax module names
(``up0_conv``, ``upblock1_3``, ``up2_iln_0a``, ``enc1``, ``dis1_0b``,
``conv1x1`` ...) so that :func:`octa_tpu_torch.io.checkpoints.
flax_to_state_dict` maps the JAX checkpoints directly.

Mixed precision follows the JAX package under ``General.amp``: the
generator's convolutions and the discriminator's ``conv1x1`` run in the
caller's autocast (bf16); the spectral-norm convolutions in their input's
dtype (float32) outside it; the generator's ``Dense`` layers, which carry no
``dtype`` in flax, in their weights' dtype outside it; the norms in float32,
returned in their input's dtype; the last sigmoid in float32.

JAX sizes the generator's first conv and, without ``light``, its first
``Dense`` lazily from the encoding ``z``; here the constructor takes ``z``'s
channel count (``in_channels``, which the trainer reads from a dry pass of
the discriminator) and ``img_size`` sizes the ``Dense`` input, ``z`` being
``img_size // 4`` on a side.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from octa_tpu_torch.models.layers import (
    Conv2d,
    LayerInstanceNorm,
    SpectralNormConv,
    at_least_float32,
    reflect_pad,
)


class ResnetAdaILNBlock(nn.Module):
    """Residual block whose two layer-instance norms take the per-sample
    ``gamma`` and ``beta`` [B, C] of the generator's dense head (reference
    ``networks.py:595-616``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, 3, bias=False)
        self.norm1 = LayerInstanceNorm(dim, rho_init=(3.2, 1.0), affine=False)
        self.conv2 = Conv2d(dim, dim, 3, bias=False)
        self.norm2 = LayerInstanceNorm(dim, rho_init=(3.2, 1.0), affine=False)

    def forward(self, x, gamma, beta):
        h = torch.relu(self.norm1(self.conv1(reflect_pad(x, 1)), gamma, beta))
        h = self.norm2(self.conv2(reflect_pad(h, 1)), gamma, beta)
        return x + h


def pixel_shuffle(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """[B, C f², H, W] -> [B, C, H f, W f] in the JAX package's channel
    order: input channel ``(i f + j) C + c`` goes to output channel ``c`` at
    row phase ``i`` and column phase ``j`` (the output channel is the minor
    index, where ``torch.nn.functional.pixel_shuffle`` makes it the major
    one)."""
    b, c, h, w = x.shape
    co = c // (factor * factor)
    x = x.reshape(b, factor, factor, co, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, co, h * factor, w * factor)


class NiceResnetGenerator(nn.Module):
    """The decoder generator (reference ``networks.py:693-778``): from the
    discriminator's encoding ``z`` [B, in_channels, S, S], a conv and ILN at
    ``4 ngf``, a dense head (global average pool with ``light``, else the
    whole map flattened channels-last) giving adaILN's ``gamma`` and
    ``beta``, ``n_blocks`` adaILN residual blocks, two pixel-shuffle
    upsamplings, a 7x7 conv and a sigmoid."""

    def __init__(self, in_channels: int, input_nc: int = 1,
                 output_nc: int = 1, ngf: int = 64, n_blocks: int = 6,
                 img_size: int = 304, light: bool = True):
        super().__init__()
        self.light = light
        self.n_blocks = n_blocks
        width = ngf * 4
        self.up0_conv = Conv2d(in_channels, width, 3)
        self.up0_iln = LayerInstanceNorm(width, rho_init=(1.0, 3.2))
        fc_in = width if light else (img_size // 4) ** 2 * width
        self.fc0 = nn.Linear(fc_in, width, bias=False)
        self.fc1 = nn.Linear(width, width, bias=False)
        self.gamma = nn.Linear(width, width, bias=False)
        self.beta = nn.Linear(width, width, bias=False)
        for i in range(n_blocks):
            setattr(self, f"upblock1_{i}", ResnetAdaILNBlock(width))
        for i in range(2):
            m = 2 ** (2 - i)
            cin, cout = ngf * m, ngf * m // 2
            setattr(self, f"up2_conv_{i}", Conv2d(cin, cout, 3, bias=False))
            setattr(self, f"up2_iln_{i}a",
                    LayerInstanceNorm(cout, rho_init=(1.0, 3.2)))
            setattr(self, f"up2_sub_{i}", Conv2d(cout, cout * 4, 1))
            setattr(self, f"up2_iln_{i}b",
                    LayerInstanceNorm(cout, rho_init=(1.0, 3.2)))
        self.conv_out = Conv2d(ngf, output_nc, 7, bias=False)

    def _head(self, pooled: torch.Tensor):
        """adaILN's ``gamma`` and ``beta`` from the pooled features, in the
        dense weights' dtype."""
        with torch.autocast(pooled.device.type, enabled=False):
            fc = torch.relu(self.fc0(pooled.to(self.fc0.weight.dtype)))
            fc = torch.relu(self.fc1(fc))
            return self.gamma(fc), self.beta(fc)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.up0_iln(self.up0_conv(reflect_pad(z, 1))))
        if self.light:
            pooled = h.mean(dim=(2, 3))
        else:  # flax flattens NHWC
            pooled = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        gamma, beta = self._head(pooled)
        for i in range(self.n_blocks):
            h = getattr(self, f"upblock1_{i}")(h, gamma, beta)
        for i in range(2):
            h = getattr(self, f"up2_conv_{i}")(reflect_pad(h, 1))
            h = torch.relu(getattr(self, f"up2_iln_{i}a")(h))
            h = pixel_shuffle(getattr(self, f"up2_sub_{i}")(h), 2)
            h = torch.relu(getattr(self, f"up2_iln_{i}b")(h))
        h = self.conv_out(reflect_pad(h, 3))
        return torch.sigmoid(at_least_float32(h))


class NiceDiscriminator(nn.Module):
    """The discriminator whose trunk doubles as the translation encoder
    (reference ``networks.py:780-880``): two spectral-norm stride-2 convs,
    the CAM attention (a spectral-normalised rank-1 logit, ``cam_fc_kernel``
    divided by its norm with a gradient, and the raw kernel reweighting the
    doubled feature map into ``conv1x1``, blended back by ``lamda``), then a
    local head (``out0``) and a global one (``out1``). Returns ``(out0,
    out1, cam_logit, heatmap, z)``. ``n_layers`` is accepted and unused, as
    in the JAX package. ``update_stats`` says whether the spectral norms
    keep the ``u`` of this call's power iteration. A call is
    :meth:`iterate`, the power iterations of the spectral norms in the
    layers' order (which do not read ``x``), then :meth:`body` with their
    ``sigma``: a trainer may replay the body from a CUDA graph.

    ``cam_fc_kernel`` [4 ndf, 1] and ``lamda`` [1] are parameters of the
    network itself under their flax names and shapes, which the checkpoints
    copy as they are (``raw_leaves``)."""

    raw_leaves = ("cam_fc_kernel", "lamda")
    #: the spectral-norm convs in the order a call reaches them
    spectral = ("enc0", "enc1", "dis0_0", "dis0_1", "conv0", "dis1_0a",
                "dis1_0b", "dis1_1", "conv1")

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 7):
        super().__init__()
        self.enc0 = SpectralNormConv(input_nc, ndf, 4, 2)
        self.enc1 = SpectralNormConv(ndf, ndf * 2, 4, 2)
        self.cam_fc_kernel = nn.Parameter(
            torch.randn(4 * ndf, 1) * (2.0 / (4 * ndf)) ** 0.5)
        self.conv1x1 = Conv2d(ndf * 4, ndf * 2, 1)
        self.lamda = nn.Parameter(torch.zeros(1))
        self.dis0_0 = SpectralNormConv(ndf * 2, ndf * 4, 4, 2)
        self.dis0_1 = SpectralNormConv(ndf * 4, ndf * 8, 4, 1)
        self.conv0 = SpectralNormConv(ndf * 8, 1, 4, 1, bias=False)
        self.dis1_0a = SpectralNormConv(ndf * 4, ndf * 8, 4, 2)
        self.dis1_0b = SpectralNormConv(ndf * 8, ndf * 16, 4, 2)
        self.dis1_1 = SpectralNormConv(ndf * 16, ndf * 32, 4, 1)
        self.conv1 = SpectralNormConv(ndf * 32, 1, 4, 1, bias=False)

    def forward(self, x: torch.Tensor, update_stats: bool = True):
        return self.body(x, *self.iterate(update_stats))

    def iterate(self, update_stats: bool = True) -> tuple:
        """This call's power iteration of each spectral norm, in
        :attr:`spectral`'s order: their ``sigma``."""
        return tuple(getattr(self, name).iterate(update_stats)
                     for name in self.spectral)

    def body(self, x: torch.Tensor, *sigmas: torch.Tensor):
        """The call with the spectral norms' ``sigmas`` given."""
        sigma_of = dict(zip(self.spectral, sigmas))

        def conv(name, h):
            return getattr(self, name)(reflect_pad(h, 1),
                                       sigma=sigma_of[name])

        def sn(name, h):
            return F.leaky_relu(conv(name, h), 0.2)

        h = sn("enc1", sn("enc0", x))
        x_0 = h
        cam_in = torch.cat([h.mean(dim=(2, 3)), h.amax(dim=(2, 3))], dim=1)
        kernel = self.cam_fc_kernel
        with torch.autocast(x.device.type, enabled=False):
            sigma = torch.linalg.vector_norm(kernel) + 1e-12
            cam_logit = cam_in.to(kernel.dtype) @ (kernel / sigma)
            h2 = torch.cat([h, h], dim=1) * kernel[:, 0][None, :, None, None]
        h = self.lamda * self.conv1x1(h2) + x_0
        h = F.leaky_relu(h, 0.2)
        heatmap = h.sum(dim=1, keepdim=True)
        z = h
        h0 = sn("dis0_0", h)
        h1 = h0
        h0 = sn("dis0_1", h0)
        out0 = conv("conv0", h0)
        for name in ("dis1_0a", "dis1_0b", "dis1_1"):
            h1 = sn(name, h1)
        out1 = conv("conv1", h1)
        return (at_least_float32(out0), at_least_float32(out1),
                at_least_float32(cam_logit), heatmap, z)
