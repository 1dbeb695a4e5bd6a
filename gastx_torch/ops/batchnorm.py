"""Batch normalization over the channel (last) axis.

Parity target: ``gastx.ops.batchnorm.batch_norm``, i.e. torch
``nn.BatchNorm2d(momentum=0.1, eps=1e-5)`` applied channels-last. In eval
mode the running statistics are read. In train mode the batch statistics
normalize (biased variance) and the running statistics take one momentum
step in place (the unbiased variance), as ``nn.BatchNorm2d`` does. Every
row of the batch enters the statistics, the zero-weight filler rows of a
ragged last batch included, as in the JAX package (``PARITY.md``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

EPS = 1e-5
MOMENTUM = 0.1


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, *,
               train: bool = False) -> torch.Tensor:
    """Normalize ``x`` (..., C) with ``bn``'s running statistics, or in
    train mode with the batch's, updating ``bn``'s running statistics."""
    if train:
        var, mean = torch.var_mean(x, dim=tuple(range(x.dim() - 1)),
                                   correction=0)
        n = x.numel() // x.shape[-1]
        with torch.no_grad():
            bn.running_mean.copy_((1.0 - MOMENTUM) * bn.running_mean
                                  + MOMENTUM * mean)
            bn.running_var.copy_((1.0 - MOMENTUM) * bn.running_var
                                 + MOMENTUM * (var * (n / max(n - 1, 1))))
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
    inv = 1.0 / torch.sqrt(var + EPS)
    return (x - mean) * (inv * bn.weight) + bn.bias


def fold_bn(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as an affine: y = x * scale + shift, each (C,)."""
    scale = bn.weight / torch.sqrt(bn.running_var + EPS)
    shift = bn.bias - bn.running_mean * scale
    return scale, shift
