"""Classical vesselness filters on tensors: the paper's baselines.

Counterpart of ``octa_tpu/ops/filters.py``:

- :func:`frangi` (:76-106) — multiscale Hessian vesselness (skimage's
  ``frangi`` with sigmas 0.5, 1, 1.5, alpha 1, beta 15, bright ridges):
  separable Gaussian-derivative convolutions with numpy's ``reflect``
  padding (``F.pad(mode="reflect")``) and closed-form 2x2 eigenvalues;
- :func:`oof` (:121-171) — 2D Optimal Oriented Flux with FFT Bessel
  filters, in complex64 as ``jnp.fft`` runs with 64-bit types off, batched
  over the leading axis; the Bessel normalisation is a host float64
  constant (``scipy.special.jv``);
- :func:`skrgan_sketch` (:198-217) — Sobel magnitude, Gaussian, area
  opening and closing, on the host in numpy and scipy, as in JAX.

No Pallas kernel stands behind them: they are tensor operations, on the
card through cuDNN and cuFFT.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gauss_kernel1d(sigma: float, order: int, radius: int) -> np.ndarray:
    """Gaussian (derivative) kernel of ``scipy.ndimage.gaussian_filter1d``."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x**2)
    phi = phi / phi.sum()
    if order == 0:
        return phi
    exponent_range = np.arange(order + 1)
    q = np.zeros(order + 1)
    q[0] = 1
    D = np.diag(exponent_range[1:], 1)  # D @ q(x) = q'(x)
    P = np.diag(np.ones(order) / -(sigma * sigma), -1)  # P @ q = q(x)*x/sigma^2
    Q_deriv = D + P
    for _ in range(order):
        q = Q_deriv.dot(q)
    q = (x[:, None] ** exponent_range).dot(q)
    return q * phi


def _sep_conv2d(img: torch.Tensor, kr: np.ndarray,
                kc: np.ndarray) -> torch.Tensor:
    """Separable convolution of [B, H, W] with ``kr`` along rows and ``kc``
    along columns, numpy ``reflect`` padding (JAX ``_sep_conv2d``)."""
    pr, pc = len(kr) // 2, len(kc) // 2
    # a true convolution: correlation with the reversed kernel, as JAX's
    # ``conv_general_dilated`` of ``k[::-1]``
    wr = torch.as_tensor(kr[::-1].copy(), dtype=img.dtype, device=img.device)
    wc = torch.as_tensor(kc[::-1].copy(), dtype=img.dtype, device=img.device)
    x = F.pad(img[:, None], (0, 0, pr, pr), mode="reflect")
    x = F.conv2d(x, wr.view(1, 1, -1, 1))
    x = F.pad(x, (pc, pc, 0, 0), mode="reflect")
    return F.conv2d(x, wc.view(1, 1, 1, -1))[:, 0]


def _hessian(img: torch.Tensor, sigma: float):
    """Gaussian-derivative Hessian (scipy orders, truncate 4, times
    sigma²)."""
    radius = int(4 * sigma + 0.5)
    g0 = _gauss_kernel1d(sigma, 0, radius)
    g1 = _gauss_kernel1d(sigma, 1, radius)
    g2 = _gauss_kernel1d(sigma, 2, radius)
    s2 = sigma * sigma
    hrr = _sep_conv2d(img, g2, g0) * s2
    hcc = _sep_conv2d(img, g0, g2) * s2
    hrc = _sep_conv2d(img, g1, g1) * s2
    return hrr, hrc, hcc


def frangi(img: torch.Tensor, sigmas: tuple[float, ...] = (0.5, 1.0, 1.5),
           alpha: float = 1.0, beta: float = 15.0,
           black_ridges: bool = False) -> torch.Tensor:
    """Frangi vesselness of a batch of 2D images [B, H, W], in float32."""
    x = img.float()
    if black_ridges:
        x = -x
    result = torch.zeros_like(x)
    for sigma in sigmas:
        hrr, hrc, hcc = _hessian(x, float(sigma))
        # eigenvalues of [[hrr, hrc], [hrc, hcc]], |l1| <= |l2|
        tr = hrr + hcc
        disc = torch.sqrt(torch.clamp((hrr - hcc) ** 2 + 4 * hrc**2, min=0.0))
        e1 = (tr + disc) / 2
        e2 = (tr - disc) / 2
        swap = torch.abs(e1) > torch.abs(e2)
        l1 = torch.where(swap, e2, e1)
        l2 = torch.where(swap, e1, e2)
        l2m = torch.where(l2 == 0, torch.full_like(l2, 1e-10), l2)
        rb2 = (l1 / l2m) ** 2
        s2_ = l1**2 + l2**2
        gamma = torch.clamp(torch.amax(torch.sqrt(s2_), dim=(1, 2),
                                       keepdim=True) / 2, min=1e-10) ** 2
        v = torch.exp(-rb2 / (2 * alpha**2)) * (1 - torch.exp(-s2_ / (2 * gamma)))
        v = torch.where(l2 > 0, torch.zeros_like(v), v)  # bright ridges
        result = torch.maximum(result, v)
    return result


def _ifft_shifted_coords(shape):
    out = []
    for i, s in enumerate(shape):
        p = s // 2
        a = np.concatenate([np.arange(p, s), np.arange(p)]) - p
        re = [1, 1]
        re[i] = s
        out.append(np.tile(a.reshape(re), [s if j != i else 1
                                           for j in range(2)]).astype(float))
    return out


def oof(img: torch.Tensor, num_radii: int = 5, sigma: float = 1.0,
        response_type: int = 1) -> torch.Tensor:
    """2D Optimal Oriented Flux of images [..., H, W] (each on its own),
    float32 and complex64."""
    from scipy.special import jv as besselj  # a host constant per radius

    EPS = 1e-12
    shape = tuple(img.shape[-2:])
    dev = img.device
    x_np, y_np = _ifft_shifted_coords(shape)
    x = torch.as_tensor(x_np / shape[0], dtype=torch.float32, device=dev)
    y = torch.as_tensor(y_np / shape[1], dtype=torch.float32, device=dev)
    sphere_radius = torch.sqrt(x**2 + y**2) + EPS
    imgfft = torch.fft.fftn(img.float(), dim=(-2, -1))
    output = torch.zeros(img.shape, dtype=torch.float32, device=dev)
    for radius in np.arange(1, num_radii + 1, dtype=float):
        circle = 2 * math.pi * radius
        bessel = besselj(1.5, circle * EPS) / EPS ** (3 / 2)
        base = radius / math.sqrt(2 * radius * sigma - sigma**2)
        volume = math.pi * radius**2
        normalization = float(volume / bessel / radius**2 * base)
        num = normalization * torch.exp(
            (-(sigma**2)) * 2 * math.pi**2 * sphere_radius**2)
        besselj_buffer = num / sphere_radius ** (3 / 2)
        cs = circle * sphere_radius
        a = torch.sin(cs) / cs - torch.cos(cs)
        b = torch.sqrt(1.0 / (math.pi**2 * radius * sphere_radius))
        besselj_buffer = besselj_buffer * a * b * imgfft
        f11 = torch.fft.ifftn(x * x * besselj_buffer, dim=(-2, -1)).real
        f12 = torch.fft.ifftn(x * y * besselj_buffer, dim=(-2, -1)).real
        f22 = torch.fft.ifftn(y * y * besselj_buffer, dim=(-2, -1)).real
        tr = f11 + f22
        disc = torch.sqrt(torch.clamp((f11 - f22) ** 2 + 4 * f12**2, min=0.0))
        l1 = (tr + disc) / 2
        l2 = (tr - disc) / 2
        maxe = torch.where(torch.abs(l2) > torch.abs(l1), l2, l1)
        mine = torch.where(torch.abs(l2) < torch.abs(l1), l2, l1)
        mide = l1 + l2 - maxe - mine
        if response_type == 0:
            feat = maxe
        elif response_type == 1:
            feat = maxe + mide
        elif response_type == 2:
            feat = torch.sqrt(torch.clamp(maxe * mide, min=0))
        elif response_type == 4:
            feat = torch.clamp(maxe, min=0)
        elif response_type == 5:
            feat = torch.clamp(maxe + mide, min=0)
        else:
            raise NotImplementedError(response_type)
        output = torch.where(torch.abs(feat) > torch.abs(output), feat, output)
    return output


def _area_filter_host(img: np.ndarray, area_threshold: int, closing: bool,
                      levels: int = 256) -> np.ndarray:
    """Grayscale area opening or closing by threshold decomposition (a
    quantised form of skimage's max-tree filter), on the host."""
    from scipy import ndimage as ndi

    x = -img if closing else img
    lo, hi = float(x.min()), float(x.max())
    if hi <= lo:
        return img.copy()
    qs = np.linspace(lo, hi, levels + 1)[1:]
    out = np.full(x.shape, lo, dtype=np.float64)
    for q in qs:
        mask = x >= q
        lab, n = ndi.label(mask)
        if n == 0:
            continue
        sizes = np.bincount(lab.ravel())
        keep = sizes >= area_threshold
        keep[0] = False
        out = np.where(keep[lab], q, out)
    return -out if closing else out


def skrgan_sketch(img: np.ndarray, sigma: float = 2.0,
                  area_threshold_open: int = 64,
                  area_threshold_close: int = 64) -> np.ndarray:
    """SkrGAN sketch of one image (reference ``models/skrgan.py:15-34``), on
    the host."""
    from scipy.ndimage import gaussian_filter, sobel

    x = np.asarray(img, np.float32).squeeze()
    sh = sobel(x, 0)
    sv = sobel(x, 1)
    mag = np.sqrt(sh**2 + sv**2)
    mag -= mag.min()
    mag /= max(mag.max(), 1e-12)
    filt = gaussian_filter(mag, sigma=sigma)
    opened = _area_filter_host(filt, area_threshold_open, closing=False)
    opened -= opened.min()
    opened /= max(opened.max(), 1e-12)
    closed = _area_filter_host(opened, area_threshold_close, closing=True)
    closed -= closed.min()
    closed /= max(closed.max(), 1e-12)
    return closed
