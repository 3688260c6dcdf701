"""PyTorch/CUDA port of ``octa_tpu`` for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package ``octa_tpu`` is the reference; module names here mirror
its modules so that each counterpart is easy to find. Layout is NCHW, random
draws take an explicit ``torch.Generator``, and every TPU (Pallas) kernel on
a ported path is a hand-written CUDA kernel behind a dispatcher that runs its
plain PyTorch version on CPU tensors only.

This package imports neither JAX nor anything of ``octa_tpu``.
"""
from octa_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
