"""The handcrafted OCTA noise model (vessel floor, speckle, local gamma)
over 9x9 Beta-distributed control points, and its random draws.

Control points go up to the image by the cubic kernel of
``jax.image.resize`` (Keys, a = -0.5, rows of weights renormalised at the
borders); the Gamma fields are drawn with ``torch._standard_gamma`` from a
generator, in the order vessel alpha, vessel beta, speckle alpha, speckle
beta, so that a generator in the same state gives the same fields.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Params(NamedTuple):
    alpha_vessel: torch.Tensor
    beta_vessel: torch.Tensor
    alpha_speckle: torch.Tensor
    beta_speckle: torch.Tensor
    gamma_cp: torch.Tensor


def draw_params(n: int, generator: torch.Generator, grid=(9, 9)) -> Params:
    """alpha, beta = 10 ** (2 Beta(2, 2) - 1); gamma control points U(0, 1)."""
    dev = generator.device
    two = torch.full((n, *grid), 2.0, device=dev)

    def beta22():
        x = torch._standard_gamma(two, generator=generator)
        y = torch._standard_gamma(two, generator=generator)
        return 10.0 ** (x / (x + y) * 2.0 - 1.0)

    return Params(beta22(), beta22(), beta22(), beta22(),
                  torch.rand((n, *grid), generator=generator, device=dev))


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of ``jax.image.resize(..., "cubic")``."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    centre = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(centre[:, None] - np.arange(n_in)[None, :]) / ks
    w = np.where(x < 1, ((1.5 * x - 2.5) * x) * x + 1,
                 np.where(x < 2, ((-0.5 * x + 2.5) * x - 4) * x + 2, 0.0))
    w = w / w.sum(1, keepdims=True)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return (w * inside[:, None]).astype(np.float32)


def cubic_up(cp: torch.Tensor, hw) -> torch.Tensor:
    """[B, gh, gw] -> [B, *hw]."""
    wh = torch.from_numpy(cubic_weights(cp.shape[-2], hw[0])).to(cp)
    ww = torch.from_numpy(cubic_weights(cp.shape[-1], hw[1])).to(cp)
    return wh @ cp @ ww.T


def concentrations(p: Params, hw):
    return tuple(cubic_up(c, hw).clamp(min=1e-3) for c in (
        p.alpha_vessel, p.beta_vessel, p.alpha_speckle, p.beta_speckle))


def apply(p: Params, image, background, generator: torch.Generator,
          lambda_delta=1.0, lambda_speckle=0.7, lambda_gamma=0.3,
          dtype=torch.float32):
    """[B, H, W] image and background in [0, 1] -> noised image (float32),
    the draws taken from ``generator``, the arithmetic done in ``dtype``."""
    hw = tuple(image.shape[-2:])
    gx_d, gy_d, gx_s, gy_s = (
        torch._standard_gamma(c, generator=generator).to(dtype)
        for c in concentrations(p, hw))
    delta = gx_d / (gx_d + gy_d + 1e-12)
    speckle = gx_s / (gx_s + gy_s + 1e-12)
    gamma = cubic_up(p.gamma_cp.clamp(0, 1) * (2 * lambda_gamma)
                     + (1 - lambda_gamma), hw).to(dtype)
    out = torch.maximum(image.to(dtype), background.to(dtype) * lambda_delta
                        * delta)
    out = out * (lambda_speckle * speckle + (1 - lambda_speckle))
    return torch.pow(out + 1e-6, gamma).float()


def background(batch: int, res: int) -> np.ndarray:
    """The adapt-and-segment path's fixed background crops: uniform noise
    from ``numpy.random.default_rng(0)``."""
    return np.random.default_rng(0).random((batch, res, res), np.float32)
