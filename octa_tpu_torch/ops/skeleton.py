"""Skeletonization and clDice.

Counterpart of ``octa_tpu/ops/skeleton.py``: the Zhang-Suen
:func:`skeletonize` (:27-108), bit-exact; the differentiable
``soft_erode`` / ``soft_dilate`` / ``soft_open`` / :func:`soft_skeletonize`
(:270-312); :func:`cl_score` and :func:`cl_dice` (:315-332); and
:func:`soft_cl_dice_loss` (:335). The volumetric thinning
``skeletonize_3d`` (:111-267) is not ported: only 3D inputs reach it.

Images are [..., H, W] tensors. :func:`skeletonize` reads one flag a
Zhang-Suen iteration back to the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _neighbors(img: torch.Tensor):
    """The 8 neighbours P2..P9 (N, NE, E, SE, S, SW, W, NW) through zero
    padding."""
    h, w = img.shape[-2:]
    z = F.pad(img, (1, 1, 1, 1))

    def sh(dr, dc):
        return z[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    return (sh(-1, 0), sh(-1, 1), sh(0, 1), sh(1, 1), sh(1, 0), sh(1, -1),
            sh(0, -1), sh(-1, -1))


def _zhang_subiter(img: torch.Tensor, first: bool) -> torch.Tensor:
    p2, p3, p4, p5, p6, p7, p8, p9 = _neighbors(img)
    b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9
    seq = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
    a = torch.zeros_like(b)
    for i in range(8):
        a = a + ((seq[i] == 0) & (seq[i + 1] == 1)).int()
    cond = (img == 1) & (b >= 2) & (b <= 6) & (a == 1)
    if first:
        cond = cond & (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
    else:
        cond = cond & (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
    return torch.where(cond, 0, img)


def skeletonize(img: torch.Tensor) -> torch.Tensor:
    """Zhang-Suen thinning of a binary image [..., H, W]; uint8 skeleton
    (``skimage.morphology.skeletonize``'s 2D method)."""
    x = (img > 0).int()
    while True:
        x2 = _zhang_subiter(_zhang_subiter(x, True), False)
        if torch.equal(x2, x):
            return x2.to(torch.uint8)
        x = x2


def _max_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max at stride 1 over the last two axes, -inf outside."""
    return F.max_pool2d(x.reshape(-1, 1, *x.shape[-2:]), 3, stride=1,
                        padding=1).reshape(x.shape)


def soft_erode(x):
    return -_max_pool3(-x)


def soft_dilate(x):
    return _max_pool3(x)


def soft_open(x):
    return soft_dilate(soft_erode(x))


def soft_skeletonize(x: torch.Tensor, iters: int = 25) -> torch.Tensor:
    """Differentiable soft skeleton (clDice loss; Shit et al. CVPR'21) of a
    soft segmentation [..., H, W] in [0, 1]."""
    skel = F.relu(x - soft_open(x))
    img = soft_erode(x)
    for _ in range(iters):
        img = soft_erode(img)
        delta = F.relu(img - soft_open(img))
        skel = skel + F.relu(delta - skel * delta)
    return skel


def cl_score(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Skeleton volume overlap (reference ``cldice.py:6-16``)."""
    return torch.sum(v * s) / torch.clamp(torch.sum(s), min=1e-8)


def cl_dice(v_p: torch.Tensor, v_l: torch.Tensor) -> torch.Tensor:
    """clDice between a binary prediction and label [H, W]."""
    if v_p.dim() == 3:
        raise NotImplementedError(
            "cl_dice of a volume needs skeletonize_3d, which comes with the "
            "3D-reconstruction slice of the port")
    v_p = (v_p > 0).float()
    v_l = (v_l > 0).float()
    tprec = cl_score(v_p, skeletonize(v_l).float())
    tsens = cl_score(v_l, skeletonize(v_p).float())
    return 2 * tprec * tsens / torch.clamp(tprec + tsens, min=1e-8)


def soft_cl_dice_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
                      iters: int = 25, smooth: float = 1.0) -> torch.Tensor:
    """Differentiable clDice loss term (1 - soft clDice)."""
    skel_pred = soft_skeletonize(y_pred, iters)
    skel_true = soft_skeletonize(y_true, iters)
    tprec = (torch.sum(skel_pred * y_true) + smooth) / (torch.sum(skel_pred) + smooth)
    tsens = (torch.sum(skel_true * y_pred) + smooth) / (torch.sum(skel_true) + smooth)
    return 1.0 - 2.0 * tprec * tsens / (tprec + tsens)
