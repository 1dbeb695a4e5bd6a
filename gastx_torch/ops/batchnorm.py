"""Eval-mode batch normalization over the channel (last) axis.

Parity target: ``gastx.ops.batchnorm.batch_norm(train=False)``, i.e. torch
``nn.BatchNorm2d(eps=1e-5)`` in eval mode applied channels-last. The port's
slice is eval only: running statistics are read, never updated.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

EPS = 1e-5


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Normalize ``x`` (..., C) with ``bn``'s running statistics."""
    inv = 1.0 / torch.sqrt(bn.running_var + EPS)
    return (x - bn.running_mean) * (inv * bn.weight) + bn.bias


def fold_bn(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as an affine: y = x * scale + shift, each (C,)."""
    scale = bn.weight / torch.sqrt(bn.running_var + EPS)
    shift = bn.bias - bn.running_mean * scale
    return scale, shift
