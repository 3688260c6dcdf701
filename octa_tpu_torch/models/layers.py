"""Shared layers: instance and layer-instance norm, padding, antialiased
blur down/upsampling, spectral-norm layers.

Counterpart of ``octa_tpu/models/layers.py``: ``InstanceNorm`` (:22),
``LayerInstanceNorm`` (:86-119), ``reflect_pad`` (:122), ``replicate_pad``
(:127), ``BlurDownsample`` (:147), ``BlurUpsample`` (:174-204),
``SpectralNormConv`` (:208-251) and ``SpectralNormDense`` (:254-281), in
NCHW, and ``l2_normalize`` (:284-287).

Mixed precision follows the JAX package: convolutions run in the dtype of
their weights (:func:`set_conv_dtype` casts only conv weights), and the norms
compute their statistics and affine in float32 and return the input's
dtype. The spectral-norm layers compute in their input's dtype outside
autocast, as their flax counterparts, which carry no ``dtype``.

While a profiler session records, each power iteration of a spectral-norm
layer is the span ``octa.nice.spectral_norm`` (:mod:`octa_tpu_torch.utils.
trace`); ``SpectralNormConv.power_iterations`` counts them all, traced or
not.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from octa_tpu_torch.parallel import spatial
from octa_tpu_torch.utils import trace


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
    """``nn.Conv2d`` that casts its input to its weight's dtype. With
    ``space`` set (:func:`set_space`) its input is a block of rows of the
    image and its neighbours' rows come by halo exchange
    (:func:`octa_tpu_torch.parallel.spatial.conv2d`)."""

    space = None

    def forward(self, x):
        x = _conv_input(x, self.weight)
        if self.space is not None:
            return spatial.conv2d(self, x, self.space)
        return super().forward(x)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that casts its input to its weight's dtype."""

    def forward(self, x):
        return super().forward(_conv_input(x, self.weight))


def _kaiming_draw(shape, fan_in: int, generator: torch.Generator):
    return torch.randn(shape, generator=generator,
                       device=generator.device) * (2.0 / fan_in) ** 0.5


def kaiming_normal_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisation (``layers.py:18``, variance scaling
    2.0, fan-in, normal; zero biases), drawn from ``generator`` in module
    order: a conv kernel [kh, kw, in, out] has fan-in ``kh*kw*in``, for a
    transposed conv too; a ``Dense`` kernel (``nn.Linear``) has fan-in
    ``in_features``. Instance-norm scales stay 1 and shifts 0. NICE-GAN's
    parameters as the JAX package initialises them: a layer-instance norm's
    ``rho`` tiles its ``rho_init``, its ``gamma`` is 1 and its ``beta`` 0; a
    spectral-norm layer's ``u`` is :func:`initial_u`; a module's own
    ``cam_fc_kernel`` [4 ndf, 1] is drawn with fan-in ``4 ndf`` and its
    ``lamda`` is 0 (``nice_gan_nets.py:141-150``)."""
    with torch.no_grad():
        for m in module.modules():
            own = dict(m.named_parameters(recurse=False))
            if "cam_fc_kernel" in own:
                k = own["cam_fc_kernel"]
                k.copy_(_kaiming_draw(k.shape, k.shape[0], generator))
            if "lamda" in own:
                own["lamda"].zero_()
            if isinstance(m, LayerInstanceNorm):
                m.reset_parameters()
                continue
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
                fan_in = cin * w.shape[2] * w.shape[3]
            elif isinstance(m, nn.Linear):
                w, fan_in = m.weight, m.in_features
            else:
                continue
            w.copy_(_kaiming_draw(w.shape, fan_in, generator))
            if m.bias is not None:
                m.bias.zero_()
            if isinstance(m, (SpectralNormConv, SpectralNormDense)):
                m.reset_u()
    return module


def set_conv_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the weights of every conv in ``module`` to ``dtype`` (in place);
    norm parameters stay float32."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype)
    return module


def set_space(module: nn.Module, space) -> nn.Module:
    """Make the convolutions and instance norms of ``module`` work on blocks
    of image rows over the ``space`` group of ranks (a
    :class:`octa_tpu_torch.parallel.mesh.Mesh`), or on whole images again
    with ``None``."""
    for m in module.modules():
        if isinstance(m, (Conv2d, InstanceNorm)):
            m.space = space
    return module


class InstanceNorm(nn.Module):
    """Instance norm over H, W: eps 1e-5, biased variance, statistics (and
    affine) in float32, output in the input's dtype. ``affine=False`` is the
    GAN networks' norm, ``affine=True`` DynUNet's; ``weight`` is flax's
    ``scale``. With ``space`` set (:func:`set_space`) its input is a block
    of rows of the image and the moments are summed over the blocks
    (:func:`octa_tpu_torch.parallel.spatial.instance_norm`)."""

    space = None

    def __init__(self, num_features: int, affine: bool = False,
                 eps: float = 1e-5):
        super().__init__()
        self.affine = affine
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        if self.space is not None:
            return spatial.instance_norm(self, x, self.space)
        x32 = at_least_float32(x)
        var, mean = torch.var_mean(x32, dim=(2, 3), keepdim=True,
                                   correction=0)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * at_least_float32(self.weight)[:, None, None] \
                + at_least_float32(self.bias)[:, None, None]
        return y.to(x.dtype)


class LayerInstanceNorm(nn.Module):
    """NICE-GAN's ILN (reference ``networks.py:618-691``): a per-channel
    soft choice, ``softmax(rho)``, between the instance-normalised input
    (over H, W) and the layer-normalised one (over C, H, W), eps 1e-5,
    biased variances, in float32, returned in the input's dtype. With
    ``gamma`` and ``beta`` [B, C] given (adaILN) they scale and shift it per
    sample; else, with ``affine``, the norm's own ``gamma`` and ``beta``.
    ``rho``, ``gamma`` and ``beta`` carry the flax names and shapes, which
    the checkpoints copy as they are (``raw_leaves``)."""

    raw_leaves = ("rho", "gamma", "beta")

    def __init__(self, num_features: int, rho_init=(1.0, 3.2),
                 affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.rho_init = tuple(float(r) for r in rho_init)
        self.affine = affine
        self.eps = eps
        self.rho = nn.Parameter(torch.empty(num_features, 2))
        if affine:
            self.gamma = nn.Parameter(torch.empty(num_features))
            self.beta = nn.Parameter(torch.empty(num_features))
        self.reset_parameters()

    def reset_parameters(self):
        """The JAX package's initial values: ``rho`` tiles ``rho_init``,
        ``gamma`` 1, ``beta`` 0."""
        with torch.no_grad():
            self.rho.copy_(torch.tensor(self.rho_init).expand_as(self.rho))
            if self.affine:
                self.gamma.fill_(1.0)
                self.beta.zero_()

    def forward(self, x, gamma=None, beta=None):
        x32 = at_least_float32(x)
        in_var, in_mean = torch.var_mean(x32, dim=(2, 3), keepdim=True,
                                         correction=0)
        out_in = (x32 - in_mean) * torch.rsqrt(in_var + self.eps)
        ln_var, ln_mean = torch.var_mean(x32, dim=(1, 2, 3), keepdim=True,
                                         correction=0)
        out_ln = (x32 - ln_mean) * torch.rsqrt(ln_var + self.eps)
        w = torch.softmax(at_least_float32(self.rho), dim=-1)[:, :, None, None]
        out = w[:, 0] * out_in + w[:, 1] * out_ln
        if gamma is not None:
            out = out * gamma[:, :, None, None] + beta[:, :, None, None]
        elif self.affine:
            out = out * at_least_float32(self.gamma)[:, None, None] \
                + at_least_float32(self.beta)[:, None, None]
        return out.to(x.dtype)


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


# ---------------------------------------------------------------------------
# spectral normalisation
# ---------------------------------------------------------------------------

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# M. Giles' single-precision erfinv polynomial (w < 5, w >= 5), as XLA
# evaluates ``erf_inv`` in float32
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)`` under
    ``key``, in uint32 arithmetic."""
    ks = [np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0] ^ key[1] ^ 0x1BD11BDA)]
    x0, x1 = x0.astype(np.uint32), x1.astype(np.uint32)
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _THREEFRY_ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x1 ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _erfinv_float32(x: np.ndarray) -> np.ndarray:
    """Giles' polynomial in float32, each Horner step fused (its product
    exact in float64, one rounding to float32)."""
    w = -np.log1p(-x * x)
    small = w < np.float32(5)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3)).astype(np.float32)
    coef = [np.where(small, np.float32(a), np.float32(b)).astype(np.float32)
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0]
    for c in coef[1:]:
        p = (c.astype(np.float64) + p.astype(np.float64)
             * w.astype(np.float64)).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max,
                    p * x).astype(np.float32)


def initial_u(features: int) -> np.ndarray:
    """The spectral norm's initial ``u`` in the JAX package,
    ``jax.random.normal(PRNGKey(0), (features,), float32)`` (the same key
    for every layer, ``layers.py:225-230``), computed without JAX:
    threefry-2x32 on the key (0, 0) over the counters (high, low word) of
    each flat index, as JAX's partitionable threefry draws 32-bit words
    (``bits = y0 ^ y1``); the mantissa trick onto [1, 2), minus 1, scaled
    onto ``[nextafter(-1, 0), 1)``; ``sqrt(2) erfinv``. The bits and the
    uniforms are JAX's exactly; the normals come within 3 float32 ulps of
    JAX's CPU values (XLA's ``log1p`` rounds otherwise)."""
    idx = np.arange(features, dtype=np.uint64)
    y0, y1 = _threefry2x32((0, 0), (idx >> np.uint64(32)).astype(np.uint32),
                           (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = y0 ^ y1
    unit = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    uniform = np.maximum(lo, unit * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2.0)) * _erfinv_float32(uniform)).astype(
        np.float32)


def _power_iteration(w2d: torch.Tensor, u: torch.Tensor):
    """One power iteration of the JAX package's spectral norm on a weight
    [out, fan-in] (its kernel [fan-in, out] transposed; the fan-in's order
    permutes ``v`` but not ``sigma`` or ``u``): ``sigma`` and the new
    ``u``, both without a gradient, normalised by ``norm + 1e-12``."""
    with torch.no_grad():
        v = w2d.T @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u_new = w2d @ v
        u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
        sigma = v @ (w2d.T @ u_new)
    return sigma, u_new


class _SpectralNorm:
    """What the spectral-norm conv and dense layers share: the ``u`` buffer
    (not persistent: the JAX package writes no ``u`` into its checkpoints)
    and one power iteration (:meth:`iterate`), whose ``sigma`` divides the
    weight. Unlike
    ``torch.nn.utils.spectral_norm``, the weight is divided by ``sigma``
    without a gradient, the norms add 1e-12, and every call takes one
    iteration, training or not; ``update_stats`` says whether the new ``u``
    is kept."""

    #: power iterations taken by the spectral-norm layers of the process
    power_iterations = 0

    def _init_u(self, features: int):
        self.register_buffer("u", torch.from_numpy(initial_u(features)),
                             persistent=False)

    def reset_u(self):
        """``u`` back to :func:`initial_u`."""
        with torch.no_grad():
            self.u.copy_(torch.from_numpy(initial_u(self.u.shape[0])))

    def iterate(self, update_stats: bool = True) -> torch.Tensor:
        """One power iteration, in the weight's dtype outside autocast:
        ``sigma``, without a gradient (the new ``u`` kept with
        ``update_stats``)."""
        w = self.weight
        with torch.autocast(w.device.type, enabled=False), \
                trace.span("octa.nice.spectral_norm"):
            sigma, u_new = _power_iteration(w.reshape(w.shape[0], -1), self.u)
        _SpectralNorm.power_iterations += 1
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u_new)
        return sigma


class SpectralNormConv(_SpectralNorm, nn.Conv2d):
    """A VALID conv whose weight is divided by its spectral norm (one power
    iteration from ``u``), computed in its input's dtype, outside
    autocast."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, bias: bool = True):
        nn.Conv2d.__init__(self, in_channels, out_channels, kernel_size,
                           stride=stride, bias=bias)
        self._init_u(out_channels)

    def forward(self, x, update_stats: bool = True,
                sigma: torch.Tensor | None = None):
        """The conv, its weight divided by ``sigma``: this call's power
        iteration's, or the one given (of :meth:`iterate`)."""
        if sigma is None:
            sigma = self.iterate(update_stats)
        with torch.autocast(x.device.type, enabled=False):
            w = (self.weight / sigma).to(x.dtype)
            b = None if self.bias is None else self.bias.to(x.dtype)
            return F.conv2d(x, w, b, self.stride)


class SpectralNormDense(_SpectralNorm, nn.Linear):
    """A ``Dense`` layer whose kernel is divided by its spectral norm, as
    :class:`SpectralNormConv`."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        nn.Linear.__init__(self, in_features, out_features, bias=bias)
        self._init_u(out_features)

    def forward(self, x, update_stats: bool = True):
        sigma = self.iterate(update_stats)
        with torch.autocast(x.device.type, enabled=False):
            w = (self.weight / sigma).to(x.dtype)
            b = None if self.bias is None else self.bias.to(x.dtype)
            return F.linear(x, w, b)
