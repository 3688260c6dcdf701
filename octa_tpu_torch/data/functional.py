"""Image augmentation primitives on tensors.

Counterpart of ``octa_tpu/data/functional.py:19-193``, every function, on
[..., H, W] tensors (a channel-first image [C, H, W], or one [H, W]).

Where the JAX function takes a PRNG key, its counterpart takes the draws
themselves (``draws``, ``offsets``, ``speckle``, ``start``, ...): the
transforms of :mod:`octa_tpu_torch.data.transforms` draw them from their
pool, and a test can hand in the JAX package's draws.

The geometric primitives also take one decision per sample (``rot90``
counts, angles, factors as 1-D tensors of length B, with [B, H, W] images),
as the JAX package's ``jax.vmap`` of them in ``ANTLoss`` does; gradients
flow through the image. With one decision for the whole tensor they compute
what they computed before, bit for bit (the loader's calls). Coordinates are
computed in float32, or in float64 for float64 images (as the JAX functions
do with 64-bit types enabled).

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


def _coord_dtype(img: torch.Tensor) -> torch.dtype:
    return torch.float64 if img.dtype == torch.float64 else torch.float32


def _per_sample(x) -> bool:
    """Whether decision ``x`` is one value per sample (a [B] tensor)."""
    return torch.is_tensor(x) and x.dim() == 1


def rot90_traceable(img: torch.Tensor, k) -> torch.Tensor:
    """rot90 by ``k`` in {0, 1, 2, 3} (square images); ``k`` may be a tensor
    on the device, which selects among the four rotations without a host
    read: a 0-d count for the whole of ``img``, or a [B] tensor, one count
    per sample of [B, H, W] ``img``."""
    if not torch.is_tensor(k):
        return torch.rot90(img, int(k) % 4, dims=(-2, -1))
    k = (k % 4).reshape(k.shape + (1, 1))
    out = torch.rot90(img, 3, dims=(-2, -1))
    for i in (2, 1, 0):
        out = torch.where(k == i, torch.rot90(img, i, dims=(-2, -1)), out)
    return out


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
    zero fill); a [B] tensor of angles rotates each sample of [B, H, W]
    ``img`` by its own."""
    h, w = img.shape[-2:]
    dt = _coord_dtype(img)
    theta = torch.deg2rad(torch.as_tensor(angle_deg, dtype=dt, device=img.device))
    if _per_sample(theta):
        theta = theta[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=dt, device=img.device),
                            torch.arange(w, dtype=dt, device=img.device),
                            indexing="ij")
    yc, xc = yy - cy, xx - cx
    cos, sin = torch.cos(theta), torch.sin(theta)
    src_y = cos * yc - sin * xc + cy
    src_x = sin * yc + cos * xc + cx
    return _bilinear_sample(img, src_y, src_x, pad_zeros)


def _bilinear_sample(img, src_y, src_x, pad_zeros=True):
    """Bilinear samples of ``img`` at (``src_y``, ``src_x``): [H, W]
    coordinates for every leading index of ``img``, or [B, H, W] coordinates
    for sample b of [B, H, W] ``img`` each (a gather)."""
    h, w = img.shape[-2:]
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    wy = src_y - y0
    wx = src_x - x0
    y0i = y0.long()
    x0i = x0.long()
    per_sample = src_y.dim() == 3

    def at(yi, xi):
        yc, xc = yi.clamp(0, h - 1), xi.clamp(0, w - 1)
        if per_sample:
            flat = (yc * w + xc).reshape(img.shape[0], -1)
            v = img.reshape(img.shape[0], -1).gather(1, flat).reshape(yi.shape)
        else:
            v = img[..., yc, xc]
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
    dt = _coord_dtype(img)
    f = torch.as_tensor(factor, dtype=dt, device=img.device)
    per_sample = _per_sample(f)
    if per_sample:
        f = f[:, None]
    mh = torch.floor(h * f)
    mw = torch.floor(w * f)
    ar_h = torch.arange(h, dtype=dt, device=img.device)
    ar_w = torch.arange(w, dtype=dt, device=img.device)
    iy = torch.floor(torch.floor(ar_h * mh / h) * h / mh).long().clamp(0, h - 1)
    ix = torch.floor(torch.floor(ar_w * mw / w) * w / mw).long().clamp(0, w - 1)
    if per_sample:  # [B, H] and [B, W] indices into sample b
        b = img.shape[0]
        rows = img.gather(1, iy[:, :, None].expand(b, h, w))
        return rows.gather(2, ix[:, None, :].expand(b, h, w))
    return img[..., iy, :][..., ix]


def crop_per_sample(img: torch.Tensor, offsets: torch.Tensor,
                    size) -> torch.Tensor:
    """The ``size`` = (ch, cw) window of each sample of [B, H, W] ``img`` at
    its own ``offsets[b]`` = (row, column) ([B, 2] integers on the device;
    ``jax.lax.dynamic_slice`` of each sample, offsets in range)."""
    b, h, w = img.shape
    ch, cw = size
    dev = img.device
    rows = offsets[:, 0:1] + torch.arange(ch, device=dev)
    cols = offsets[:, 1:2] + torch.arange(cw, device=dev)
    out = img.gather(1, rows[:, :, None].expand(b, ch, w))
    return out.gather(2, cols[:, None, :].expand(b, ch, cw))


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
    out = F.conv2d(_reflect_pad(out, -2, radius), k.view(1, 1, -1, 1))
    out = F.conv2d(_reflect_pad(out, -1, radius), k.view(1, 1, 1, -1))
    return out.reshape(shape)


def _reflect_pad(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    """``x`` reflect-padded by ``pad`` on both sides of ``dim``, as
    ``numpy.pad(..., mode="reflect")`` (and ``jnp.pad``) pads: where
    ``pad`` reaches the side's length, which ``F.pad`` refuses, the
    reflection repeats."""
    n = x.shape[dim]
    if pad < n:
        return F.pad(x, (pad, pad, 0, 0) if dim == -1 else (0, 0, pad, pad),
                     mode="reflect")
    idx = torch.from_numpy(np.pad(np.arange(n), pad, mode="reflect"))
    return x.index_select(dim, idx.to(x.device))


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
