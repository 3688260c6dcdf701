"""Training: optimizer and schedule (``state``), the segmentation and
GAN-seg trainers (``algorithms``), the unpaired GAN zoo (``gan_algorithms``:
CycleGAN, CUT, NEGCUT, DCLGAN, NICE-GAN), the epoch loop (``engine``) and the
CLI (``cli``, run as ``python -m octa_tpu_torch.train``, data-parallel over
several cards under ``python -m torch.distributed.run``). ``train`` is the
engine's entry point.
"""
from octa_tpu_torch.train.engine import train

__all__ = ["train"]
