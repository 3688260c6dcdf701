"""Network registry: config ``General.model.name`` -> constructor.

Counterpart of ``octa_tpu/models/registry.py``: ``NETWORK_DICT`` with the
networks the port has, ``ALGORITHM_NAMES`` and ``build_network`` (:102).
The classical baselines ``frangi``, ``oof`` and ``skrgan`` and the GAN
networks are named but raise ``NotImplementedError`` until their slices.
"""
from __future__ import annotations

from octa_tpu_torch.models.dynunet import DynUNet
from octa_tpu_torch.models.resnet_gan import resnetGenerator9

# multi-network training procedures, resolved by train.algorithms
ALGORITHM_NAMES = (
    "GanSegModel",
    "CycleGAN",
    "CUTModel",
    "NEGCUTModel",
    "DCLGAN",
    "NiceGAN",
)

NETWORK_DICT = {
    "DynUNet": DynUNet,
    "resnetGenerator9": resnetGenerator9,
}

NOT_PORTED = {
    "oof": "the classical-baselines slice",
    "frangi": "the classical-baselines slice",
    "skrgan": "the classical-baselines slice",
    "patchGAN70x70": "the GAN slice",
    "ResnetGenerator": "the GAN slice",
    "NLayerDiscriminator": "the GAN slice",
    "NiceResnetGenerator": "the GAN slice",
    "NiceDiscriminator": "the GAN slice",
    "PatchSamplerF": "the GAN slice",
    "PatchSampleF": "the GAN slice",
    "Negative_Generator": "the GAN slice",
}


def network_constructor(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"network '{name}' is not ported to octa_tpu_torch yet: it comes "
            f"with {NOT_PORTED[name]}")
    return NETWORK_DICT[name]


def build_network(model_config: dict, **extra):
    """Construct a network from a config dict with a ``name`` key; the other
    keys become constructor arguments."""
    cfg = dict(model_config)
    ctor = network_constructor(cfg.pop("name"))
    cfg.update(extra)
    return ctor(**cfg)
