"""Loss functions, and the loss registry.

Counterpart of ``octa_tpu/utils/losses.py``: ``dice_loss``,
``bce_with_logits``, ``bce`` and ``DiceBCELoss`` (:22-57); ``L1Loss``,
``MSELoss``, ``CrossEntropyLoss``, ``WeightedCosineLoss``,
``WeightedMSELoss`` and ``QWKLoss`` (:72-178); ``_cl_dice_combo_loss``
(:305); and ``get_loss_function_by_name`` (:275) with the same names.

Images are NCHW here where the JAX package has NHWC: the Dice sums run over
the spatial axes (2 and up) and the mean over batch and channel, as there.
Class scores stay on the last axis, as in the JAX package.

Not ported yet, and raising ``NotImplementedError`` by name: the
adversarial noise training loss ``AtLoss`` (``ANTLoss``, :181-272), which
comes with its own slice, and the GAN losses ``LSGANLoss``,
``PatchNCELoss`` and ``LearnedPatchNCELoss``, which come with the GAN
slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from octa_tpu_torch.ops.skeleton import soft_cl_dice_loss

_NOT_PORTED = {
    "AtLoss": "the adversarial noise training (ANTLoss) slice",
    "LSGANLoss": "the GAN slice",
    "PatchNCELoss": "the GAN slice",
    "LearnedPatchNCELoss": "the GAN slice",
}


def dice_loss(y_pred, y, sigmoid=False, smooth_nr=1e-5, smooth_dr=1e-5):
    """MONAI DiceLoss (include_background, mean reduction) over NC[spatial]."""
    if sigmoid:
        y_pred = torch.sigmoid(y_pred)
    axes = tuple(range(2, y_pred.dim()))
    intersection = torch.sum(y_pred * y, dim=axes)
    denom = torch.sum(y_pred, dim=axes) + torch.sum(y, dim=axes)
    dice = (2.0 * intersection + smooth_nr) / (denom + smooth_dr)
    return torch.mean(1.0 - dice)


def bce_with_logits(y_pred, y):
    return torch.mean(torch.clamp(y_pred, min=0) - y_pred * y
                      + torch.log1p(torch.exp(-torch.abs(y_pred))))


def bce(y_pred, y, eps=1e-7):
    p = torch.clamp(y_pred, eps, 1 - eps)
    return -torch.mean(y * torch.log(p) + (1 - y) * torch.log(1 - p))


class DiceBCELoss:
    """(Dice + BCE) / 2 (reference ``losses.py:111-121``)."""

    def __init__(self, sigmoid=False):
        self.sigmoid = sigmoid

    def __call__(self, y_pred, y):
        if self.sigmoid:
            return (dice_loss(y_pred, y, sigmoid=True)
                    + bce_with_logits(y_pred, y)) / 2
        return (dice_loss(y_pred, y) + bce(y_pred, y)) / 2


class L1Loss:
    def __call__(self, y_pred, y):
        return torch.mean(torch.abs(y_pred - y))


class MSELoss:
    def __call__(self, y_pred, y):
        return torch.mean((y_pred - y) ** 2)


class CrossEntropyLoss:
    def __init__(self, weight=None):
        self.weight = weight

    def __call__(self, logits, labels):
        logp = torch.log_softmax(logits, dim=-1)
        labels = labels.long()
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        if self.weight is not None:
            w = torch.as_tensor(self.weight, dtype=logp.dtype,
                                device=logp.device)[labels]
            return torch.sum(nll * w) / torch.sum(w)
        return torch.mean(nll)


class WeightedCosineLoss:
    def __init__(self, weights=(1, 1, 1)):
        self.weights = torch.as_tensor(weights, dtype=torch.float32)

    def __call__(self, y_pred, y):
        y = y.long()
        ypn = y_pred / (torch.linalg.norm(y_pred, dim=-1, keepdim=True) + 1e-12)
        onehot = F.one_hot(y, y_pred.shape[-1]).to(y_pred.dtype)
        cos = torch.sum(ypn * onehot, dim=-1)
        w = self.weights.to(y_pred.device)[y]
        return 1 - torch.sum(w * cos) / torch.sum(w)


class WeightedMSELoss:
    def __init__(self, weights):
        self.weights = torch.as_tensor(weights, dtype=torch.float32)

    def __call__(self, y_pred, y):
        per = (y_pred - y) ** 2
        w = self.weights.to(y_pred.device)[y.long()]
        return torch.sum(per * w) / torch.sum(w)


class QWKLoss:
    """Quadratic-weighted-kappa loss (reference ``losses.py:136-170``)."""

    def __init__(self, scale=2.0, num_classes=3):
        self.scale = scale
        self.num_classes = num_classes

    def __call__(self, output, target):
        n = self.num_classes
        target = F.one_hot(target.reshape(-1).long(), n).to(output.dtype)
        output = torch.softmax(output, dim=1)
        w = torch.arange(n, dtype=torch.float32, device=output.device) / (n - 1)
        w = (w - w[:, None]) ** 2
        conf = (output.T @ target).T
        hist_true = torch.sum(target, dim=0)[:, None]
        hist_pred = torch.sum(output, dim=0)[:, None]
        expected = (hist_true @ hist_pred.T) / torch.sum(conf)
        qwk = 1 - torch.sum(w * conf) / torch.sum(w * expected)
        return -torch.log(torch.sigmoid(self.scale * qwk))


def _cl_dice_combo_loss(y_pred, y, alpha=0.5):
    """DiceBCE + soft-clDice combination on NCHW logits."""
    base = DiceBCELoss(True)(y_pred, y)
    cl = soft_cl_dice_loss(torch.sigmoid(y_pred)[:, 0], y[:, 0])
    return (1 - alpha) * base + alpha * cl


def get_loss_function_by_name(name: str, config: dict, scaler=None, loss=None):
    """Loss registry (reference ``losses.py:325-353``)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"loss '{name}' is not ported to octa_tpu_torch yet: it comes with "
            f"{_NOT_PORTED[name]}")
    weight = None
    if "Data" in config:
        weight = [1.0 / c for c in config["Data"]["class_balance"]]
    loss_map = {
        "DiceBCELoss": lambda: DiceBCELoss(True),
        "CrossEntropyLoss": lambda: CrossEntropyLoss(weight=weight),
        "CosineEmbeddingLoss": lambda: WeightedCosineLoss(weights=weight),
        "MSELoss": lambda: MSELoss(),
        "WeightedMSELoss": lambda: WeightedMSELoss(weights=weight),
        "QWKLoss": lambda: QWKLoss(),
        "L1Loss": lambda: L1Loss(),
        "ClDiceLoss": lambda: _cl_dice_combo_loss,
    }
    if name in loss_map:
        return loss_map[name]()
    print("Warning: No loss function defined. "
          "Ignore this message for parameterless models.")
    return lambda *args, **kwargs: None
