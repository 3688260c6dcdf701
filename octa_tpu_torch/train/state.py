"""Learning-rate schedule and optimizer factory.

Counterpart of ``octa_tpu/train/state.py:25-47``. ``make_optimizer`` there
is ``optax.chain(add_decayed_weights(wd), adam(lr, b1, b2))``: L2 weight
decay added to the gradient before Adam (coupled), which is
``torch.optim.Adam(weight_decay=wd)``, not ``AdamW``. Adam's ``eps`` is
optax's 1e-8, added to the bias-corrected root of the second moment as
torch does.
"""
from __future__ import annotations

import torch


def linear_decay_factor(epoch: int, max_epochs: int, epochs_decay: int) -> float:
    """Constant for ``max_epochs - epochs_decay`` epochs, then linear to 0
    (reference ``base_model_abc.py:57-61``)."""
    if epoch < (max_epochs - epochs_decay):
        return 1.0
    return (max_epochs - epoch) * (1.0 / max(1, epochs_decay))


def make_optimizer(params, lr: float, betas=(0.5, 0.999),
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8,
                            weight_decay=weight_decay or 0.0)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
