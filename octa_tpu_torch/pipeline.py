"""Adapt-and-segment pipeline: vessel graphs -> splat -> noise model ->
generator -> bilinear upsample -> DynUNet -> threshold.

Counterpart of ``bench.py`` ``pipeline`` (:136-148) and ``adapted_pass``
(:419-433), the ``adapt_segment`` scope of the JAX bench (:282-324): edges
at 304² (input, ``k_max`` 4096) and 1216² (label, ``k_max`` 512) go through
K1, the label is ``splat > 0.1``, the noise model adapts the input, the
shipped ``resnetGenerator9`` translates it at 304², a bilinear upsample
brings it to 1216², and the shipped ``DynUNet`` segments it; the mask is
``sigmoid(logits) > 0.5``.

On the card the networks run bf16 weights and activations, as
``bench.py:117-120`` does; ``dtype=torch.float32`` runs them in float32.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.io.checkpoints import load_checkpoint, load_flax_params
from octa_tpu_torch.models import noise_model as nm
from octa_tpu_torch.models.dynunet import DynUNet
from octa_tpu_torch.models.layers import set_conv_dtype
from octa_tpu_torch.models.resnet_gan import resnetGenerator9
from octa_tpu_torch.ops import raster
from octa_tpu_torch.ops.splat import splat_lines_2d
from octa_tpu_torch.utils import trace

RES_IN, RES_LAB = 304, 1216
K_IN, K_LAB = 4096, 512
LABEL_THRESHOLD = 0.1
_MODELS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docker", "trained_models")
G_CKPT = os.path.join(_MODELS, "GAN", "10_G_model.ckpt")
S_CKPT = os.path.join(_MODELS, "ves_seg-S-GAN", "10_model.ckpt")


def build_segmentor() -> DynUNet:
    """The reference's 2D segmentor (``configs/config_gan_ves_seg.yml``)."""
    return DynUNet(spatial_dims=2, in_channels=1, out_channels=1,
                   kernel_size=[3] * 5, strides=[1, 2, 2, 2, 1],
                   upsample_kernel_size=[1, 2, 2, 2, 1])


def load_networks(device="cuda", dtype=torch.bfloat16, g_ckpt=G_CKPT,
                  s_ckpt=S_CKPT):
    """``(generator, segmentor)`` with the shipped weights, in eval mode on
    ``device``, convolutions in ``dtype``."""
    dev = resolve_device(device)
    nets = []
    for net, path in ((resnetGenerator9(), g_ckpt), (build_segmentor(), s_ckpt)):
        load_flax_params(net, load_checkpoint(path)["model"])
        nets.append(set_conv_dtype(net.to(dev).eval(), dtype))
    return tuple(nets)


def background(batch: int, res: int = RES_IN) -> np.ndarray:
    """The bench's background-noise crops (``bench.py:123-124``)."""
    return np.random.default_rng(0).random((batch, res, res), np.float32)


def dice(pred: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """Per-image Dice of boolean masks [B, H, W] (``bench.py:375-379``)."""
    inter = (pred & lab).sum((1, 2))
    return 2 * inter / torch.clamp(pred.sum((1, 2)) + lab.sum((1, 2)), min=1)


def edges_to_device(samples, device="cuda", res_in=RES_IN, res_lab=RES_LAB):
    """Parsed graphs -> ``{"in": (a, b, w, v), "lab": (...)}`` tensors on
    ``device`` (``bench.py:291-293``)."""
    dev = resolve_device(device)
    prep = raster.pad_batch_edges(samples, res_in, res_lab)
    return {k: tuple(torch.from_numpy(x).to(dev) for x in v)
            for k, v in prep.items()}


def forest_edges(state):
    """A grown (batched) ``GrowthState`` -> unit-cube edges on its device:
    ``forest_edges_device`` of the arterial and the venous forest,
    concatenated on the edge axis (``bench.py:174-178``). Returns
    ``(a, b, radius, valid)`` with ``a, b`` [B, 2*NC, 2]."""
    from octa_tpu_torch.sim.greenhouse import forest_edges_device

    parts = [forest_edges_device(f) for f in (state.art, state.ven)]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(4))


def edges_from_unit(a, b, radius, valid, res_in=RES_IN, res_lab=RES_LAB):
    """Unit-cube device edges (from :func:`forest_edges`) -> pixel
    coordinates and stroke widths at both resolutions, with no host round
    trip (``bench.py:150-156`` ``pipeline_device``): the stroke width is
    ``radius * 1.3 * (100/72) * res``. Returns ``{"in": (a, b, w, v),
    "lab": (...)}`` as :func:`edges_to_device` does."""
    lw = radius * raster._RADIUS_FUDGE * raster._PT_TO_PX
    return {"in": (a * res_in, b * res_in, lw * res_in, valid),
            "lab": (a * res_lab, b * res_lab, lw * res_lab, valid)}


class AdaptSegment:
    """The adapted path on one device: ``__call__`` maps one batch of edges
    to ``(pred, lab, dice)``."""

    def __init__(self, device="cuda", dtype=torch.bfloat16, nets=None,
                 res_in=RES_IN, res_lab=RES_LAB, k_in=K_IN, k_lab=K_LAB,
                 max_batch=4):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.gen, self.seg = nets if nets is not None else load_networks(
            self.device, dtype)
        self.res_in, self.res_lab = res_in, res_lab
        self.k_in, self.k_lab = k_in, k_lab
        self.bg = torch.from_numpy(background(max_batch, res_in)).to(self.device)

    @torch.inference_mode()
    def splat(self, edges_in, edges_lab):
        """K1 twice: the input image at res_in and the bool label at res_lab."""
        img = splat_lines_2d(*edges_in, height=self.res_in, width=self.res_in,
                             k_max=self.k_in)
        lab = splat_lines_2d(*edges_lab, height=self.res_lab,
                             width=self.res_lab, k_max=self.k_lab)
        return img, lab > LABEL_THRESHOLD

    @torch.inference_mode()
    def adapt(self, img, noise_params, generator=None, gammas=None):
        return nm.apply_noise_model(noise_params, img, self.bg[:img.shape[0]],
                                    generator, gammas=gammas)

    @torch.inference_mode()
    def translate(self, noised):
        """Generator at res_in: [B, H, W] -> [B, 1, H, W] float32."""
        return self.gen(noised[:, None].to(self.dtype))

    @torch.inference_mode()
    def segment(self, fake):
        """Bilinear upsample to res_lab, then DynUNet logits (float32)."""
        up = F.interpolate(fake, size=(self.res_lab, self.res_lab),
                           mode="bilinear", align_corners=False)
        return self.seg(up)

    def stages(self, edges_in, edges_lab, noise_params: nm.NoiseParams,
               generator: torch.Generator | None = None, gammas=None):
        """Every stage's output for one batch: ``img`` (splat at res_in),
        ``lab`` (bool label at res_lab), ``noised``, ``fake`` (generator
        output), ``logits`` and ``pred`` (bool mask). While a profiler
        session records, the stages are the spans ``octa.adapt.splat``,
        ``octa.adapt.noise``, ``octa.adapt.generator``, ``octa.adapt.segment``
        and ``octa.adapt.threshold`` (:mod:`octa_tpu_torch.utils.trace`)."""
        with trace.span("octa.adapt.splat"):
            img, lab = self.splat(edges_in, edges_lab)
        with trace.span("octa.adapt.noise"):
            noised = self.adapt(img, noise_params, generator, gammas)
        with trace.span("octa.adapt.generator"):
            fake = self.translate(noised)
        with trace.span("octa.adapt.segment"):
            logits = self.segment(fake)
        with trace.span("octa.adapt.threshold"):
            pred = torch.sigmoid(logits)[:, 0] > 0.5
        return {"img": img, "lab": lab, "noised": noised, "fake": fake,
                "logits": logits, "pred": pred}

    def __call__(self, edges_in, edges_lab, noise_params: nm.NoiseParams,
                 generator: torch.Generator | None = None, gammas=None):
        """edges_*: ``(a, b, w, v)`` batches on the device. The noise draws
        come from ``generator`` or, ready-made, from ``gammas``. Returns the
        predicted mask and the label (bool [B, res_lab, res_lab]) and the
        per-image Dice [B]."""
        out = self.stages(edges_in, edges_lab, noise_params, generator, gammas)
        return out["pred"], out["lab"], dice(out["pred"], out["lab"])
