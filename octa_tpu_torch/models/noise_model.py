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
to inject its own.

``jax.image.resize(..., "cubic")`` is not torch's bicubic: it uses the Keys
kernel with a = -0.5 and renormalises the weights at the borders, where
torch uses a = -0.75 and clamps. :func:`resize` therefore builds JAX's
weight matrices by hand (``compute_weight_mat`` of ``jax._src.image.scale``)
and applies them as two small matrix products.
"""
from __future__ import annotations

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


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """[out, in] float32 weights of ``jax.image.resize(..., method)`` along
    one axis (antialiased as JAX's default: the kernel widens when
    downsampling). Rows are renormalised to sum to one, and a row whose
    sample falls outside the input is zero."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = _KERNELS[method](x / kernel_scale)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, 0)
    return w.T.astype(np.float32)


def resize(x: torch.Tensor, hw: tuple[int, int], method: str) -> torch.Tensor:
    """[B, h, w] -> [B, *hw] with ``jax.image.resize``'s weights."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(hw):
        return x
    wh = torch.from_numpy(resize_weights(h, hw[0], method)).to(x.device, x.dtype)
    ww = torch.from_numpy(resize_weights(w, hw[1], method)).to(x.device, x.dtype)
    return torch.einsum("hi,bij,wj->bhw", wh, x, ww)


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


def beta_concentrations(params: NoiseParams, hw: tuple[int, int]):
    """The four Gamma concentration fields at ``hw``, in draw order: vessel
    alpha, vessel beta, speckle alpha, speckle beta (clipped at 1e-3)."""
    return tuple(_bicubic_up(cp, hw).clamp(min=1e-3) for cp in (
        params.alpha_vessel, params.beta_vessel,
        params.alpha_speckle, params.beta_speckle))


def draw_gammas(concentrations, generator: torch.Generator):
    """One standard-Gamma field per concentration (reparameterised)."""
    return tuple(torch._standard_gamma(c, generator=generator)
                 for c in concentrations)


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
    lambda_delta: float = 1.0,
    lambda_speckle: float = 0.7,
    lambda_gamma: float = 0.3,
    downsample_factor: float = 1.0,
) -> torch.Tensor:
    """Apply the 3-stage noise model. Either ``generator`` draws the Gamma
    fields, or ``gammas`` supplies them (four [B, h, w] tensors in the order
    of :func:`beta_concentrations`)."""
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
        if generator is None:
            raise ValueError("apply_noise_model: pass a generator or gammas")
        gammas = draw_gammas(beta_concentrations(params, hw), generator)
    gx_d, gy_d, gx_s, gy_s = gammas
    delta = _beta_field(gx_d, gy_d)
    speckle = _beta_field(gx_s, gy_s)
    gamma = _bicubic_up(
        params.gamma_cp.clamp(0.0, 1.0) * (2 * lambda_gamma)
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
