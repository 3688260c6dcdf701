"""Device selection for the port's entry points.

Entry points default to ``"cuda"`` and never fall back to the CPU: a run
that asks for the card and finds none raises, so a CPU timing can never be
mistaken for a device one. Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "octa_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "explicitly to run the plain PyTorch path")
    return dev
