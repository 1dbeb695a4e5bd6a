"""Adam (amsgrad) and the per-epoch learning-rate decay (parity target:
``gastx.train.optimizer``).

The JAX package implements torch's amsgrad update rule by hand
(``scale_by_amsgrad``) because optax has none; the port uses
``torch.optim.Adam(amsgrad=True)`` itself, whose update it is. The
learning rate is set on the parameter group before each step
(:func:`set_lr`), so a decayed rate rebuilds nothing.
"""
from __future__ import annotations

from typing import Iterable

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   lr: float = 1e-3) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS,
                            amsgrad=True)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def exponential_epoch_decay(initial_lr: float, decay: float,
                            epoch: int) -> float:
    """The learning rate after ``epoch`` full epochs of x``decay``."""
    return initial_lr * (decay**epoch)
