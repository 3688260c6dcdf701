"""Handcrafted OCTA contrast-adaptation noise model, as tensor functions.

Counterpart of ``octa_tpu/models/noise_model.py``: ``NoiseParams`` and
``sample_noise_params`` (:26-50), ``_bicubic_up`` (:53), ``_beta_field``
(:59), ``apply_noise_model`` (:70) and ``pga_update`` (:110).

Control-point (9x9) Beta-distributed fields, upsampled bicubically, applied
as (1) vessel floor ``max(I, lambda_delta * bg * Delta)``, (2) speckle
``I * (lambda_s * S + 1 - lambda_s)``, (3) local gamma ``I ** Gamma``.

The random draws are split from the composition: :func:`draw_gammas` makes
the four Gamma fields from a ``torch.Generator``, and
:func:`apply_noise_model` takes them ready-made when a caller (a test) needs
to inject its own. For adversarial noise training, which differentiates the
model with respect to its control points several times over the same noise
(JAX's ANT loop keeps one key), :func:`fixed_state_draw` restores one saved
generator state before every draw, so that the draws are a function of the
concentrations alone; their gradient is ``torch._standard_gamma``'s
reparameterised derivative. :func:`injected_draw` attaches a derivative that
a caller supplies (a test: the JAX package's draws and derivative) to draws
it supplies. Where the JAX function differentiates a clip, :func:`clip`
takes JAX's gradient at a tie (half of it at a bound; ``torch.clamp`` gives
all of it).

``jax.image.resize(..., "cubic")`` is not torch's bicubic: it uses the Keys
kernel with a = -0.5 and renormalises the weights at the borders, where
torch uses a = -0.75 and clamps. :func:`resize` therefore builds JAX's
weight matrices by hand (``compute_weight_mat`` of ``jax._src.image.scale``)
and applies them as two small matrix products. It takes every method of
``jax.image.resize`` (:func:`resize_method`): the linear, cubic and
Lanczos kernels as weights, and ``nearest`` as JAX's index gather.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from octa_tpu_torch.device import resolve_device


class NoiseParams(NamedTuple):
    alpha_vessel: torch.Tensor  # [B, gh, gw] Beta-dist alpha control points
    beta_vessel: torch.Tensor
    alpha_speckle: torch.Tensor
    beta_speckle: torch.Tensor
    gamma_cp: torch.Tensor      # [B, gh, gw] in [0, 1]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _lanczos(radius: float):
    """JAX's ``_fill_lanczos_kernel`` (``jax/_src/image/scale.py:33-37``),
    with its ``x > 1e-3`` guard."""
    def kernel(x: np.ndarray) -> np.ndarray:
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1), 1)
        return np.where(x > radius, 0.0, out)
    return kernel


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}

#: ``jax.image.ResizeMethod.from_string``'s names (``scale.py:150-162``)
_METHODS = {"nearest": "nearest", "lanczos3": "lanczos3",
            "lanczos5": "lanczos5",
            **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"),
                            "linear"),
            **dict.fromkeys(("cubic", "bicubic", "tricubic"), "cubic")}


def resize_method(name: str) -> str:
    """The method of ``jax.image.resize`` that ``name`` stands for: one of
    ``nearest``, ``linear``, ``cubic``, ``lanczos3``, ``lanczos5``. Any
    other name raises ``ValueError``, as JAX's ``from_string`` does
    (MONAI's ``area`` and ``nearest-exact``, for example)."""
    try:
        return _METHODS[name]
    except KeyError:
        raise ValueError(f'Unknown resize method "{name}"') from None


def resize_weights(in_size: int, out_size: int, method: str,
                   dtype=np.float32) -> np.ndarray:
    """[out, in] weights of ``jax.image.resize(..., method)`` along one axis
    (antialiased as JAX's default: the kernel widens when downsampling),
    computed in ``dtype``: float32, or float64 as JAX computes them with
    64-bit types enabled. Rows are renormalised to sum to one, and a row
    whose sample falls outside the input is zero."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(out_size, dtype=dtype) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=dtype)[:, None])
    w = _KERNELS[method](x / kernel_scale)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, 0)
    return w.T.astype(dtype)


@functools.lru_cache(maxsize=64)
def _device_weights(in_size: int, out_size: int, method: str,
                    device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`resize_weights` on ``device``, made once per shape: a copy
    from the host each call would wait for the card. float64 tensors get
    weights computed in float64, every other type float32's. Made outside
    inference mode even when the first call is inside it (the pipeline's),
    so that a later call under autograd (``ANTLoss``) can use them."""
    host = np.float64 if dtype == torch.float64 else np.float32
    with torch.inference_mode(False):
        return torch.from_numpy(resize_weights(in_size, out_size, method,
                                               host)).to(device, dtype)


@functools.lru_cache(maxsize=64)
def _nearest_indices(in_size: int, out_size: int,
                     device: torch.device) -> torch.Tensor:
    """The input rows of ``jax.image.resize(..., "nearest")`` along one
    axis (``_resize_nearest``, ``scale.py:256-271``): ``floor((arange(n) +
    0.5) * m / n)``, computed in float32 as JAX computes it (with 64-bit
    types too), on ``device`` once per shape."""
    at = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
          * np.float32(in_size) / np.float32(out_size))
    with torch.inference_mode(False):
        return torch.from_numpy(np.floor(at).astype(np.int64)).to(device)


def resize(x: torch.Tensor, hw: tuple[int, int], method: str) -> torch.Tensor:
    """[..., h, w] -> [..., *hw] as ``jax.image.resize(x, ..., method)``
    (any name of :func:`resize_method`): an axis of equal size is left as
    it is, as JAX leaves it; the others take JAX's weights, or its nearest
    rows."""
    method = resize_method(method)
    h, w = x.shape[-2:]
    if (h, w) == tuple(hw):
        return x
    if method == "nearest":
        if h != hw[0]:
            x = x.index_select(-2, _nearest_indices(h, hw[0], x.device))
        if w != hw[1]:
            x = x.index_select(-1, _nearest_indices(w, hw[1], x.device))
        return x
    lead = x.shape[:-2]
    out = x.reshape(-1, h, w)
    if h == hw[0]:
        out = torch.matmul(
            out, _device_weights(w, hw[1], method, x.device, x.dtype).T)
    elif w == hw[1]:
        out = torch.matmul(
            _device_weights(h, hw[0], method, x.device, x.dtype), out)
    else:
        wh = _device_weights(h, hw[0], method, x.device, x.dtype)
        ww = _device_weights(w, hw[1], method, x.device, x.dtype)
        out = torch.einsum("hi,bij,wj->bhw", wh, out, ww)
    return out.reshape(*lead, *hw)


def _bicubic_up(cp: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """[B, gh, gw] -> [B, h, w] cubic upsampling (JAX's weights)."""
    return resize(cp, hw, "cubic")


def sample_noise_params(n_batch: int, generator: torch.Generator,
                        grid_size=(9, 9), device="cuda") -> NoiseParams:
    """Re-randomised control points (reference ``reset_params``):
    alpha/beta = 10**(Beta(2,2)*2-1), gamma ~ U(0,1). Draws come from
    ``generator``, which must live on ``device``."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"sample_noise_params: generator on "
                         f"{generator.device}, draws asked on {device}")
    shape = (n_batch, *grid_size)
    two = torch.full(shape, 2.0, device=device)

    def beta22():
        x = torch._standard_gamma(two, generator=generator)
        y = torch._standard_gamma(two, generator=generator)
        return 10.0 ** (x / (x + y) * 2.0 - 1.0)

    return NoiseParams(
        alpha_vessel=beta22(),
        beta_vessel=beta22(),
        alpha_speckle=beta22(),
        beta_speckle=beta22(),
        gamma_cp=torch.rand(shape, generator=generator, device=device),
    )


def clip(x: torch.Tensor, lo: float | None = None,
         hi: float | None = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, gradient included: ``maximum`` then
    ``minimum`` with bounds held in tensors, which give half the gradient to
    ``x`` where it equals a bound, as JAX does (``torch.clamp`` gives all of
    it). The bounds are device-side fills, not copies from the host."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def beta_concentrations(params: NoiseParams, hw: tuple[int, int]):
    """The four Gamma concentration fields at ``hw``, in draw order: vessel
    alpha, vessel beta, speckle alpha, speckle beta (clipped at 1e-3)."""
    return tuple(clip(_bicubic_up(cp, hw), 1e-3) for cp in (
        params.alpha_vessel, params.beta_vessel,
        params.alpha_speckle, params.beta_speckle))


def draw_gammas(concentrations, generator: torch.Generator):
    """One standard-Gamma field per concentration (reparameterised)."""
    return tuple(torch._standard_gamma(c, generator=generator)
                 for c in concentrations)


def fixed_state_draw(generator: torch.Generator):
    """A draw (concentrations -> four Gamma fields) that restores
    ``generator``'s state as it is now before each call: every call draws
    from the same state, so the fields are a function of the concentrations
    alone, as JAX's ``jax.random.gamma(key, a)`` with one key is. The
    gradient reaches the concentrations through ``torch._standard_gamma``'s
    reparameterised backward (the implicit derivative dx/da)."""
    state = generator.get_state()

    def draw(concentrations):
        generator.set_state(state)
        return draw_gammas(concentrations, generator)

    return draw


class _InjectedGamma(torch.autograd.Function):
    """Draws ``x`` given from outside, attached to their concentration ``a``
    with the derivative ``dxda`` given beside them: the backward pass
    returns ``grad * dxda`` to ``a``."""

    @staticmethod
    def forward(ctx, a, x, dxda):
        ctx.save_for_backward(dxda)
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        (dxda,) = ctx.saved_tensors
        return grad * dxda, None, None


def injected_draw(hook):
    """A draw whose fields and derivatives come from ``hook``: called with
    the four concentration fields (detached), it returns four ``(x, dx/da)``
    pairs of the same shapes. A test hands in the JAX package's draws and
    their derivative this way."""
    def draw(concentrations):
        pairs = hook(tuple(c.detach() for c in concentrations))
        return tuple(
            _InjectedGamma.apply(c, x.to(c.device, c.dtype),
                                 d.to(c.device, c.dtype))
            for c, (x, d) in zip(concentrations, pairs))

    return draw


def sharded_draw(draw, shard):
    """``draw`` over a global batch of which the concentrations given are
    this rank's rows (``shard``, a
    :class:`octa_tpu_torch.parallel.mesh.Shard`): every rank gathers the
    global concentrations, draws the global fields as ``draw`` does, keeps
    its rows and attaches them to its concentrations with ``draw``'s own
    derivative dx/da (the fields are elementwise in the concentrations)."""
    def local(concentrations):
        glob = tuple(shard.gather(c).requires_grad_(True)
                     for c in concentrations)
        with torch.enable_grad():
            xs = draw(glob)
            dxda = torch.autograd.grad([x.sum() for x in xs], glob)
        return tuple(
            _InjectedGamma.apply(c, shard.take(x.detach()), shard.take(d))
            for c, x, d in zip(concentrations, xs, dxda))

    return local


def _beta_field(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Beta(a, b) from Gamma(a) and Gamma(b) draws."""
    return x / (x + y + 1e-12)


def apply_noise_model(
    params: NoiseParams,
    image: torch.Tensor,        # [B, H, W] synthetic vessel map in [0,1]
    background: torch.Tensor,   # [B, H, W] real background-noise crop
    generator: torch.Generator | None = None,
    *,
    gammas=None,
    draw=None,
    lambda_delta: float = 1.0,
    lambda_speckle: float = 0.7,
    lambda_gamma: float = 0.3,
    downsample_factor: float = 1.0,
) -> torch.Tensor:
    """Apply the 3-stage noise model. ``gammas`` supplies the Gamma fields
    (four [B, h, w] tensors in the order of :func:`beta_concentrations`),
    or ``draw`` makes them from the concentrations (:func:`fixed_state_draw`,
    :func:`injected_draw`), or ``generator`` draws them."""
    b, h, w = image.shape
    size = (h, w)
    if downsample_factor != 1.0:
        hw = (int(h / downsample_factor), int(w / downsample_factor))
        img = resize(image, hw, "linear")
        bg = resize(background, hw, "linear")
    else:
        hw = size
        img, bg = image, background

    if gammas is None:
        if draw is None and generator is None:
            raise ValueError(
                "apply_noise_model: pass a generator, a draw or gammas")
        concentrations = beta_concentrations(params, hw)
        gammas = (draw(concentrations) if draw is not None
                  else draw_gammas(concentrations, generator))
    gx_d, gy_d, gx_s, gy_s = gammas
    delta = _beta_field(gx_d, gy_d)
    speckle = _beta_field(gx_s, gy_s)
    gamma = _bicubic_up(
        clip(params.gamma_cp, 0.0, 1.0) * (2 * lambda_gamma)
        + (1 - lambda_gamma), hw)

    d = bg * lambda_delta * delta
    out = torch.maximum(img, d)
    out = out * (lambda_speckle * speckle + (1 - lambda_speckle))
    out = torch.pow(out + 1e-6, gamma)

    if hw != size:
        out = resize(out, size, "linear")
    return out


def pga_update(params: NoiseParams, grads: NoiseParams, alpha: float,
               mode: str = "PGA") -> NoiseParams:
    """Projected-gradient-ascent step on the noise parameters (reference
    ``projected_gradient_ascent_step``, ``noise_model.py:3-11``)."""
    def upd(p, g):
        if mode == "GS":
            return torch.sign(g).clamp(0.0, 1.0)
        if mode == "PGA":
            return (p + alpha * g).clamp(0.0, 1.0)
        if mode == "FGSM":
            return (p + alpha * torch.sign(g)).clamp(0.0, 1.0)
        raise NotImplementedError(mode)

    return NoiseParams(*(upd(p, g) for p, g in zip(params, grads)))
