"""Binary morphology and connected components.

Counterpart of ``octa_tpu/ops/morphology.py``: ``binary_dilation`` (:23),
``label_host`` (:49), ``remove_small_objects`` (:60),
``keep_largest_connected_component`` (:76), ``connected_components_device``
(:93) and ``remove_small_objects_device`` (:131).

The host functions label with ``scipy.ndimage`` (imported where it is used:
scipy is optional). The device functions run on the tensor's device; the
labelling loop reads one flag a round of eight sweeps back to the host.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _as_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, 1, *x.shape[-2:])


def binary_dilation(x: torch.Tensor, iterations: int = 1,
                    connectivity: int = 1) -> torch.Tensor:
    """Binary dilation of ``x`` [..., H, W] with scipy's cross structuring
    element (``connectivity=1``) or the full 3x3 (``connectivity=2``).
    Returns float32."""
    y = (x > 0).float()
    shape = y.shape
    y = _as_nchw(y)
    for _ in range(iterations):
        if connectivity == 1:
            z = F.pad(y, (1, 1, 1, 1))
            h, w = y.shape[-2:]
            y = torch.maximum(
                y, torch.maximum(
                    torch.maximum(z[..., 0:h, 1:w + 1], z[..., 2:h + 2, 1:w + 1]),
                    torch.maximum(z[..., 1:h + 1, 0:w], z[..., 1:h + 1, 2:w + 2])))
        else:
            y = F.max_pool2d(y, 3, stride=1, padding=1)
    return y.reshape(shape)


def label_host(mask: np.ndarray, connectivity: int = 1):
    """Connected-component labelling on the host (``scipy.ndimage.label``)."""
    from scipy import ndimage as ndi

    structure = ndi.generate_binary_structure(mask.ndim, connectivity)
    return ndi.label(mask, structure=structure)


def remove_small_objects(mask: np.ndarray, min_size: int = 64,
                         connectivity: int = 1) -> np.ndarray:
    """Remove connected components smaller than ``min_size`` (host path;
    MONAI ``RemoveSmallObjects`` semantics)."""
    mask = np.asarray(mask)
    lab, n = label_host(mask > 0, connectivity)
    if n == 0:
        return mask.copy()
    sizes = np.bincount(lab.ravel())
    keep = sizes >= min_size
    keep[0] = False
    return np.where(keep[lab], mask, 0)


def keep_largest_connected_component(mask: np.ndarray,
                                     connectivity: int = 2) -> np.ndarray:
    """Keep only the largest foreground component (host path)."""
    mask = np.asarray(mask)
    lab, n = label_host(mask > 0, connectivity)
    if n == 0:
        return mask.copy()
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    return np.where(lab == sizes.argmax(), mask, 0)


def connected_components_device(mask: torch.Tensor,
                                connectivity: int = 1) -> torch.Tensor:
    """Labels of a binary [H, W] image by iterative min-label propagation on
    its device: int32, 0 for background, each component labelled by one plus
    the smallest row-major index among its pixels (not consecutive)."""
    h, w = mask.shape
    fg = mask > 0
    big = h * w + 2
    idx = torch.arange(1, h * w + 1, dtype=torch.int32,
                       device=mask.device).reshape(h, w)
    lab = torch.where(fg, idx, 0)

    def prop(lab):
        x = torch.where(fg, lab, big)
        z = F.pad(x, (1, 1, 1, 1), value=big)
        m = torch.minimum(x, torch.minimum(
            torch.minimum(z[:-2, 1:-1], z[2:, 1:-1]),
            torch.minimum(z[1:-1, :-2], z[1:-1, 2:])))
        if connectivity == 2:
            m = torch.minimum(m, torch.minimum(
                torch.minimum(z[:-2, :-2], z[:-2, 2:]),
                torch.minimum(z[2:, :-2], z[2:, 2:])))
        return torch.where(fg, m, 0)

    while True:
        new = lab
        for _ in range(8):  # several sweeps a round: one host read a round
            new = prop(new)
        if torch.equal(new, lab):
            return new
        lab = new


def remove_small_objects_device(mask: torch.Tensor, min_size: int = 64,
                                connectivity: int = 1) -> torch.Tensor:
    """Remove-small-objects on the mask's device."""
    lab = connected_components_device(mask, connectivity).long()
    h, w = mask.shape
    sizes = torch.bincount(lab.ravel(), minlength=h * w + 2)
    keep = sizes >= min_size
    keep[0] = False
    return torch.where(keep[lab], mask, torch.zeros_like(mask))
