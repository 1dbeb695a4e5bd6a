"""Batch normalization over the channel (last) axis.

Parity target: ``gastx.ops.batchnorm.batch_norm``, i.e. torch
``nn.BatchNorm2d(momentum=0.1, eps=1e-5)`` applied channels-last. In eval
mode the running statistics are read. In train mode the batch statistics
normalize (biased variance) and the running statistics take one momentum
step in place (the unbiased variance), as ``nn.BatchNorm2d`` does. Every
row of the batch enters the statistics, the zero-weight filler rows of a
ragged last batch included, as in the JAX package (``PARITY.md``).

Under a mesh of more than one rank (``gastx_torch.parallel``) train mode
takes the statistics of the global batch, every rank's rows, as the JAX
mesh's ``psum`` gives them: the sum over ranks of each rank's sum, then
of its sum of squares about that mean (:func:`all_reduce_sum`, whose
backward sums the gradients over the ranks), and the running variance's
n / (n - 1) with the global n. Every rank holds the same number of rows
(``shard_batch`` pads to a multiple of the mesh size).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gastx_torch.parallel.mesh import Mesh, all_reduce_sum

EPS = 1e-5
MOMENTUM = 0.1


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, *,
               train: bool = False, mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """Normalize ``x`` (..., C) with ``bn``'s running statistics, or in
    train mode with the batch's (the global batch's under a ``mesh`` of
    more than one rank), updating ``bn``'s running statistics."""
    if train:
        dims = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1]
        if mesh is None or mesh.size == 1:
            var, mean = torch.var_mean(x, dim=dims, correction=0)
        else:
            n *= mesh.size
            mean = all_reduce_sum(x.sum(dim=dims), mesh) / n
            var = all_reduce_sum(torch.square(x - mean).sum(dim=dims),
                                 mesh) / n
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
    """Eval BN as an affine: y = x * scale + shift, each (C,); a bf16 BN
    (bf16 storage) is folded in float32, as the TPU kernels fold theirs."""
    weight, bias, mean, var = (
        t.to(torch.float32) if t.dtype == torch.bfloat16 else t
        for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var))
    scale = weight / torch.sqrt(var + EPS)
    shift = bias - mean * scale
    return scale, shift
