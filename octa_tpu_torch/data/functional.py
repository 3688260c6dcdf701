"""Image augmentation primitives on tensors.

Counterpart of ``octa_tpu/data/functional.py:19-193``, every function, on
[..., H, W] tensors (a channel-first image [C, H, W], or one [H, W]).

Where the JAX function takes a PRNG key, its counterpart takes the draws
themselves (``draws``, ``offsets``, ``speckle``, ``start``, ...): the
transforms of :mod:`octa_tpu_torch.data.transforms` draw them from their
pool, and a test can hand in the JAX package's draws.

Resizing uses ``jax.image.resize``'s own weights
(:func:`octa_tpu_torch.models.noise_model.resize`): ``"linear"``
antialiases when it shrinks, which ``F.interpolate`` does not. Rotation is
the JAX package's own bilinear sampler with zero padding, not
``grid_sample``, whose centre and padding conventions differ.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from octa_tpu_torch.models.noise_model import resize


def resize_bilinear(img: torch.Tensor, size) -> torch.Tensor:
    """Linear resize with half-pixel centres, antialiased when shrinking."""
    return resize(img, tuple(size), "linear")


def scale_intensity(img: torch.Tensor, minv=0.0, maxv=1.0) -> torch.Tensor:
    """MONAI ScaleIntensityd: min-max rescale to [minv, maxv]."""
    lo, hi = torch.aminmax(img)
    return (img - lo) / torch.clamp(hi - lo, min=1e-12) * (maxv - minv) + minv


def as_discrete(img: torch.Tensor, threshold: float) -> torch.Tensor:
    return (img >= threshold).to(img.dtype)


def rot90_traceable(img: torch.Tensor, k) -> torch.Tensor:
    """rot90 by ``k`` in {0, 1, 2, 3} (square images); ``k`` may be a tensor
    on the device, which selects among the four rotations without a host
    read."""
    if not torch.is_tensor(k):
        return torch.rot90(img, int(k) % 4, dims=(-2, -1))
    rots = torch.stack([torch.rot90(img, i, dims=(-2, -1)) for i in range(4)])
    return rots[k % 4]


def flip(img: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.flip(img, dims=(axis,))


def rand_flip(img: torch.Tensor, draws, axes=(0, 1), prob=0.5) -> torch.Tensor:
    """RandFlipd over the listed spatial axes of an [H, W] image, an
    independent coin each: axis ``axes[i]`` flips where ``draws[i]`` (U(0, 1),
    a float or a tensor on the device) is below ``prob``."""
    for ax, u in zip(axes, draws):
        img = torch.where(torch.as_tensor(u, device=img.device) < prob,
                          torch.flip(img, dims=(ax,)), img)
    return img


def rotate_bilinear(img: torch.Tensor, angle_deg,
                    pad_zeros: bool = True) -> torch.Tensor:
    """Rotate [..., H, W] around the image centre by ``angle_deg`` (bilinear,
    zero fill)."""
    h, w = img.shape[-2:]
    theta = torch.deg2rad(torch.as_tensor(angle_deg, dtype=torch.float32,
                                          device=img.device))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device), indexing="ij")
    yc, xc = yy - cy, xx - cx
    cos, sin = torch.cos(theta), torch.sin(theta)
    src_y = cos * yc - sin * xc + cy
    src_x = sin * yc + cos * xc + cx
    return _bilinear_sample(img, src_y, src_x, pad_zeros)


def _bilinear_sample(img, src_y, src_x, pad_zeros=True):
    h, w = img.shape[-2:]
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    wy = src_y - y0
    wx = src_x - x0
    y0i = y0.long()
    x0i = x0.long()

    def at(yi, xi):
        v = img[..., yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        if pad_zeros:
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = torch.where(inside, v, 0.0)
        return v

    v00 = at(y0i, x0i)
    v01 = at(y0i, x0i + 1)
    v10 = at(y0i + 1, x0i)
    v11 = at(y0i + 1, x0i + 1)
    return ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
            + wy * (1 - wx) * v10 + wy * wx * v11)


def decrease_resolution(img: torch.Tensor, factor,
                        min_factor: float = 0.25) -> torch.Tensor:
    """Nearest down-then-up resampling by a factor in (0, 1] (torch
    ``interpolate(scale_factor=f)`` then back to the size, nearest):
    ``out[i, j] = img[floor(floor(i*m/H)*H/m), ...]`` with ``m =
    floor(H*f)``."""
    h, w = img.shape[-2:]
    f = torch.as_tensor(factor, dtype=torch.float32, device=img.device)
    mh = torch.floor(h * f)
    mw = torch.floor(w * f)
    ar_h = torch.arange(h, dtype=torch.float32, device=img.device)
    ar_w = torch.arange(w, dtype=torch.float32, device=img.device)
    iy = torch.floor(torch.floor(ar_h * mh / h) * h / mh).long().clamp(0, h - 1)
    ix = torch.floor(torch.floor(ar_w * mw / w) * w / mw).long().clamp(0, w - 1)
    return img[..., iy, :][..., ix]


def gaussian_blur(img: torch.Tensor, sigma: float,
                  truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W] (scipy ``gaussian_filter``
    semantics, reflect padding)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = torch.as_tensor(k / k.sum(), dtype=img.dtype, device=img.device)
    shape = img.shape
    out = img.reshape(-1, 1, *shape[-2:])
    out = F.pad(out, (0, 0, radius, radius), mode="reflect")
    out = F.conv2d(out, k.view(1, 1, -1, 1))
    out = F.pad(out, (radius, radius, 0, 0), mode="reflect")
    out = F.conv2d(out, k.view(1, 1, 1, -1))
    return out.reshape(shape)


def rand_crop_or_pad(img: torch.Tensor, factor: float, offsets) -> torch.Tensor:
    """Zoom crop (``factor`` < 1) of [..., H, W] at ``offsets = (oy, ox)``
    (ints, or tensors on the device, drawn in [0, H - int(H*factor)] and
    [0, W - int(W*factor)]), resized back to the input's shape by nearest
    indexing."""
    h, w = img.shape[-2:]
    sh = max(int(h * factor), 1)
    sw = max(int(w * factor), 1)
    dev = img.device
    oy, ox = (torch.as_tensor(o, device=dev) for o in offsets)
    yy = oy + (torch.arange(h, device=dev) * sh / h).long()
    xx = ox + (torch.arange(w, device=dev) * sw / w).long()
    return img[..., yy.clamp(0, h - 1), :][..., xx.clamp(0, w - 1)]


_LINE_WEIGHTS = (0.025, 0.075, 0.375, 0.875, 1.0, 0.875, 0.375, 0.075, 0.025)


def add_line_artifact(img: torch.Tensor, start) -> torch.Tensor:
    """Blurred 9-row band from row ``start`` (an int, or a tensor on the
    device) blended with its 7x7 box blur (``AddLineArtifact``)."""
    h, w = img.shape[-2:]
    dev = img.device
    rows = torch.as_tensor(start, device=dev) + torch.arange(9, device=dev)
    c = torch.tensor(_LINE_WEIGHTS, dtype=img.dtype, device=dev)[:, None]
    band = img[..., rows, :]
    lead = band.shape[:-2]
    bandp = F.pad(band.reshape(-1, 1, 9, w), (3, 3, 3, 3))
    box = torch.full((1, 1, 7, 7), 1.0 / 50.0, dtype=img.dtype, device=dev)
    blurred = F.conv2d(bandp, box).reshape(*lead, 9, w)
    mixed = band * (1 - c) + c * blurred
    out = img.clone()
    out[..., rows, :] = mixed
    return out


def add_random_background_noise(img: torch.Tensor, background: torch.Tensor,
                                speckle: torch.Tensor) -> torch.Tensor:
    """``max(img, background * speckle)`` per pixel, ``speckle`` ~ U(0, 1)
    of the image's shape (``AddRandomBackgroundNoised``)."""
    return torch.maximum(img, background * speckle)


def speckle_brightness(img: torch.Tensor, grid_draws: torch.Tensor,
                       pixel_draws: torch.Tensor) -> torch.Tensor:
    """``SpeckleBrightnesd`` of [..., H, W], each [H, W] image on its own:
    control-grid field C = U*0.5+0.5 (``grid_draws`` ~ U(0, 1) of the grid's
    shape), R = C - U*(1-C) (``pixel_draws`` ~ U(0, 1) of [H, W]), img *= R,
    then /max and -min as the reference orders them."""
    C = resize(grid_draws * 0.5 + 0.5, tuple(img.shape[-2:]), "linear")
    R = C - pixel_draws * (1 - C)
    out = img * R
    out = out / torch.clamp(torch.amax(out, dim=(-2, -1), keepdim=True),
                            min=1e-12)
    return out - torch.amin(out, dim=(-2, -1), keepdim=True)
