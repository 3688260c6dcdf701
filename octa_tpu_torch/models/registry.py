"""Network registry: config ``General.model.name`` -> constructor.

Counterpart of ``octa_tpu/models/registry.py``: ``NETWORK_DICT`` with the
networks the port has, the classical baselines ``frangi``, ``oof`` and
``skrgan`` as parameterless callables on NCHW batches (:37-79),
``ALGORITHM_NAMES`` and ``build_network`` (:102). The contrastive heads
(``PatchSamplerF``, ``PatchSampleF``, ``Negative_Generator``) take
``in_channels``, their levels' channel counts, and NICE-GAN's generator
``NiceResnetGenerator`` the channel count of the encoding it decodes,
besides their config keys.
"""
from __future__ import annotations

import numpy as np
import torch

from octa_tpu_torch.models.dynunet import DynUNet
from octa_tpu_torch.models.nice_gan_nets import (
    NiceDiscriminator,
    NiceResnetGenerator,
)
from octa_tpu_torch.models.resnet_gan import (
    NegativeGenerator,
    NLayerDiscriminator,
    PatchSampleF,
    ResnetGenerator,
    patchGAN70x70,
    resnetGenerator9,
)

# multi-network training procedures, resolved by train.algorithms
ALGORITHM_NAMES = (
    "GanSegModel",
    "CycleGAN",
    "CUTModel",
    "NEGCUTModel",
    "DCLGAN",
    "NiceGAN",
)


def _frangi_ctor(**kw):
    from octa_tpu_torch.ops.filters import frangi

    def run(img: torch.Tensor) -> torch.Tensor:  # [B, C, H, W] -> [B, 1, H, W]
        return frangi(img[:, 0], **kw)[:, None]

    return run


def _oof_ctor(**kw):
    from octa_tpu_torch.ops.filters import oof

    def run(img: torch.Tensor) -> torch.Tensor:  # [B, C, H, W] -> [B, 1, H, W]
        # batched, with the reference's per-image normalisation
        # (``oof.py:40-41``) per sample, as the JAX package's vmap
        out = oof(img[:, 0] * 255.0, **kw)
        out = out + torch.amax(out, dim=(1, 2), keepdim=True)
        out = out / torch.amax(out, dim=(1, 2), keepdim=True)
        return out[:, None]

    return run


def _skrgan_ctor(**kw):
    from octa_tpu_torch.ops.filters import skrgan_sketch

    def run(img: torch.Tensor) -> torch.Tensor:  # batch 1 -> [1, 1, H, W]
        out = skrgan_sketch(img.detach().float().cpu().numpy(), **kw)
        return torch.from_numpy(np.ascontiguousarray(out))[None, None].to(
            img.device)

    return run


NETWORK_DICT = {
    "DynUNet": DynUNet,
    "resnetGenerator9": resnetGenerator9,
    "patchGAN70x70": patchGAN70x70,
    "ResnetGenerator": ResnetGenerator,
    "NLayerDiscriminator": NLayerDiscriminator,
    "PatchSamplerF": PatchSampleF,  # the reference registry's spelling
    "PatchSampleF": PatchSampleF,
    "Negative_Generator": NegativeGenerator,
    "NiceResnetGenerator": NiceResnetGenerator,
    "NiceDiscriminator": NiceDiscriminator,
    "oof": _oof_ctor,
    "frangi": _frangi_ctor,
    "skrgan": _skrgan_ctor,
}

def network_constructor(name: str):
    if name not in NETWORK_DICT:
        raise KeyError(f"unknown network {name!r}; known: "
                       f"{sorted(NETWORK_DICT)}")
    return NETWORK_DICT[name]


def build_network(model_config: dict, **extra):
    """Construct a network from a config dict with a ``name`` key; the other
    keys become constructor arguments."""
    cfg = dict(model_config)
    ctor = network_constructor(cfg.pop("name"))
    cfg.update(extra)
    return ctor(**cfg)
