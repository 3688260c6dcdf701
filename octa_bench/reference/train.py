"""The training steps of both configurations in float32: the losses, a
plain Adam, and the steps the comparison follows.

- S (``config_ves_seg-S.yml``): DynUNet logits, DiceBCE (``(Dice(sigmoid)
  + BCE with logits) / 2``, Dice over H, W per image and channel with
  smoothing 1e-5, then the mean), Adam (0.5, 0.999), eps 1e-8.
- GAN-seg (``config_gan_ves_seg.yml``): the discriminator's LSGAN step on
  the detached translation, then one backward pass of ``loss_G + (loss_S +
  loss_S_idt) / 2`` into generator and segmentor through the updated
  discriminator, which takes no gradient; the segmentor sees the 304²
  images bilinearly upsampled to 1216², and the label of ``idt_B`` is
  ``S(real_B) > 0.5``; Adam (0.5, 0.999) for G and D, (0.9, 0.999) for S.

``half`` leaves out the second half of every batch (the mean taken over
the rest): a fault the comparison has to catch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from octa_bench.reference import nets


def dice_bce(logits, y):
    p = torch.sigmoid(logits)
    inter = (p * y).sum((2, 3))
    den = p.sum((2, 3)) + y.sum((2, 3))
    dice = torch.mean(1.0 - (2.0 * inter + 1e-5) / (den + 1e-5))
    bce = torch.mean(torch.clamp(logits, min=0) - logits * y
                     + torch.log1p(torch.exp(-logits.abs())))
    return (dice + bce) / 2


def lsgan(pred, real: bool):
    return torch.mean((pred - (1.0 if real else 0.0)) ** 2)


class Adam:
    """Adam with bias correction (coupled weight decay 0)."""

    def __init__(self, params: dict, lr: float, betas, eps: float = 1e-8):
        self.p, self.lr, self.b1, self.b2, self.eps = params, lr, *betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt().add_(self.eps)
            self.p[k].sub_(self.lr * (self.m[k] / c1) / denom)


def _leaves(params: dict) -> dict:
    return {k: v.detach().clone().float().requires_grad_(True)
            for k, v in params.items()}


def seg_steps(config: dict, weights: dict, batches: list, prec="fp32",
              half=False, per_image=False) -> dict:
    """Steps of S on ``batches`` (``(image, label)`` NCHW) from ``weights``
    (``{"segmentor": {...}}``). Returns the losses a step, each step's
    logits, the first step's gradients and the parameters after the last
    step; with ``per_image`` also the first step's gradient of each image's
    loss alone (the instance norm and the per-image Dice make the batch's
    loss their mean)."""
    run = config["run"]
    m = config["networks"]["segmentor"]
    p = nets.Prec("fp8" if prec == "low" else "fp32")
    params = {"segmentor": _leaves(weights["segmentor"])}
    leaves = list(params["segmentor"].values())
    opt = Adam(params["segmentor"], run["Train"]["lr"], (0.5, 0.999))
    out = {"losses": [], "grads": None, "logits": []}
    for x, y in batches:
        x, y = x.float(), y.float()
        if half:
            x, y = x[: len(x) // 2], y[: len(y) // 2]
        if per_image and out["grads"] is None:
            out["image_grads"] = [dict(zip(params["segmentor"], torch.autograd.grad(
                dice_bce(nets.dynunet(params["segmentor"], m, x[j:j + 1], p,
                                      recompute=True), y[j:j + 1]), leaves)))
                for j in range(len(x))]
        logits = nets.dynunet(params["segmentor"], m, x, p, recompute=True)
        loss = dice_bce(logits, y)
        g = torch.autograd.grad(loss, leaves)
        grads = dict(zip(params["segmentor"], g))
        if out["grads"] is None:
            out["grads"] = {"segmentor": grads}
        opt.step(grads)
        out["logits"].append(logits.detach())
        out["losses"].append({run["Train"]["loss"]: float(loss.detach())})
    out["params"] = {"segmentor": {k: v.detach() for k, v in
                                   params["segmentor"].items()}}
    return out


def gan_seg_steps(config: dict, weights: dict, batches: list, prec="fp32",
                  half=False, per_image=False) -> dict:
    """Steps of GAN-seg on ``batches`` (``(real_A, real_B, real_A_seg)``).
    ``per_image`` is not taken: the batch is coupled through the
    discriminator's step and the identity labels."""
    run = config["run"]
    nw = config["networks"]
    p = nets.Prec("fp8" if prec == "low" else "fp32")
    lr = run["Train"]["lr"]
    par = {k: _leaves(weights[k]) for k in ("generator", "discriminator",
                                           "segmentor")}
    opt = {"generator": Adam(par["generator"], lr, (0.5, 0.999)),
           "discriminator": Adam(par["discriminator"], lr, (0.5, 0.999)),
           "segmentor": Adam(par["segmentor"], lr, (0.9, 0.999))}
    G = lambda x: nets.generator(par["generator"], nw["generator"], x, p)  # noqa: E731
    D = lambda x: nets.discriminator(par["discriminator"],  # noqa: E731
                                     nw["discriminator"], x, p)

    upshape = tuple(run["General"]["model"].get("upshape", (1216, 1216)))

    def S(x):
        up = F.interpolate(x, size=upshape, mode="bilinear",
                           align_corners=False)
        return nets.dynunet(par["segmentor"], nw["segmentor"], up, p,
                            recompute=True)

    out = {"losses": [], "grads": None}
    for real_A, real_B, real_A_seg in batches:
        real_A, real_B, real_A_seg = (t.float() for t in (real_A, real_B,
                                                            real_A_seg))
        if half:
            n = len(real_A) // 2
            real_A, real_B, real_A_seg = real_A[:n], real_B[:n], real_A_seg[:n]
        fake_B = G(real_A)
        idt_B = G(real_B)
        d_fake = lsgan(D(fake_B.detach()), False)
        d_real = lsgan(D(real_B), True)
        dl = list(par["discriminator"].values())
        gd = dict(zip(par["discriminator"],
                      torch.autograd.grad(0.5 * (d_fake + d_real), dl)))
        opt["discriminator"].step(gd)
        with torch.no_grad():
            real_B_seg = (S(real_B) > 0.5).float()
        loss_g = lsgan(D(fake_B), True)
        loss_s = dice_bce(S(fake_B), real_A_seg)
        loss_s_idt = dice_bce(S(idt_B), real_B_seg)
        total = loss_g + 0.5 * (loss_s + loss_s_idt)
        gl = list(par["generator"].values()) + list(par["segmentor"].values())
        g = torch.autograd.grad(total, gl)
        ng = len(par["generator"])
        gg = dict(zip(par["generator"], g[:ng]))
        gs = dict(zip(par["segmentor"], g[ng:]))
        if out["grads"] is None:
            out["grads"] = {"generator": gg, "discriminator": gd,
                            "segmentor": gs}
        opt["generator"].step(gg)
        opt["segmentor"].step(gs)
        out["losses"].append({"D_fake": float(d_fake.detach()), "D_real": float(d_real.detach()),
                              "G": float(loss_g.detach()), "S": float(loss_s.detach()),
                              "S_idt": float(loss_s_idt.detach())})
    out["params"] = {k: {n: v.detach() for n, v in d.items()}
                     for k, d in par.items()}
    return out


STEPS = {"SegAlgorithm": seg_steps, "GanSegAlgorithm": gan_seg_steps}
