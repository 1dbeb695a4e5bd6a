"""The train and eval steps (parity target: ``gastx.train.loop``).

:func:`train_step` is ``train_step_body``: the target's root joint
zeroed, the train forward (plain ops with autograd, batch-statistic BN,
dropout; each plain site at the config's matmul tier on the card, as the
JAX package trains under its tiers), the per-sample weighted MPJPE, backward and one amsgrad step at
the given learning rate. Ragged last batches are padded to the fixed
batch with zero-weight filler rows, so the loss and its gradient are the
partial batch's mean; the filler rows still enter the BN batch
statistics, as in the JAX package (``PARITY.md``).

Under a data-parallel mesh (``gastx_torch.parallel``) each rank steps on
its rows of the global batch through the DDP-wrapped model: the BN
statistics and dropout masks are the global batch's, and the local loss
is ``world * sum_local(err * w) / sum_global(w)``, so that DDP's mean of
the ranks' gradients is the gradient of the JAX loss ``sum(err * w) /
sum(w)`` over the whole batch. Every rank assembled the same global
batch, so ``sum_global(w)`` is known on the host (``weight_sum``), and a
rank holding only filler rows divides by it, not by its own zero.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gastx_torch.device import check_f32_matmul
from gastx_torch.eval.metrics import mpjpe
from gastx_torch.models.gastnet import GastNet
from gastx_torch.parallel.mesh import Mesh, all_reduce_sum
from gastx_torch.train.optimizer import set_lr


def root_relative(batch_3d: torch.Tensor) -> torch.Tensor:
    """The target with its root joint (joint 0) zeroed."""
    target = batch_3d.clone()
    target[:, :, 0] = 0.0
    return target


def weighted_loss(pred: torch.Tensor, target: torch.Tensor,
                  sample_weight: torch.Tensor,
                  weight_sum: Optional[float] = None) -> torch.Tensor:
    """Per-sample MPJPE weighted by ``sample_weight`` (B,), summed and
    divided by ``weight_sum`` (default: the sum of ``sample_weight``)."""
    err = torch.linalg.norm(pred - target, dim=-1).mean(dim=(1, 2))
    total = torch.sum(sample_weight) if weight_sum is None else weight_sum
    return torch.sum(err * sample_weight) / total


def train_step(model: GastNet, opt: torch.optim.Optimizer,
               batch_2d: torch.Tensor, batch_3d: torch.Tensor,
               sample_weight: torch.Tensor, lr: float,
               generator: Optional[torch.Generator],
               variant: str = "strided", *, mesh: Optional[Mesh] = None,
               weight_sum: Optional[float] = None,
               plain: bool = False) -> torch.Tensor:
    """One step on ``batch_2d`` (B, T_in, J, C_in) and the camera-space
    targets ``batch_3d`` (B, T_out, J, 3), ``sample_weight`` (B,) zero
    for filler rows. Under a ``mesh`` these are this rank's rows, the
    ``model`` is wrapped by ``parallel.replicate``, and ``weight_sum``
    (the global batch's sum of ``sample_weight``; by default this batch's)
    is required beyond one rank. The forward's plain sites run at the
    config's tiers on the card (``models.gastnet``); ``plain`` runs their
    tiered products through the wrappers' plain versions (the kernels'
    reference on the card). Returns the loss of the whole batch (a device
    scalar, not synced)."""
    check_f32_matmul(batch_2d)
    ranks = 1 if mesh is None else mesh.size
    if ranks > 1 and weight_sum is None:
        raise ValueError("a step over more than one rank needs weight_sum, "
                         "the global batch's sum of sample weights")
    model.train()
    kw = {"plain": True} if plain else {}
    loss = weighted_loss(
        model(batch_2d, variant, generator=generator, mesh=mesh, **kw),
        root_relative(batch_3d), sample_weight,
        None if weight_sum is None else weight_sum / ranks)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    set_lr(opt, lr)
    opt.step()
    loss = loss.detach()
    return loss if ranks == 1 else all_reduce_sum(loss, mesh) / ranks


def eval_step(model: GastNet, batch_2d: torch.Tensor,
              batch_3d: torch.Tensor, variant: str = "dilated"
              ) -> Tuple[torch.Tensor, int]:
    """The eval forward (the kernel route on the card) -> (the sum over
    frames of the per-frame MPJPE, the frame count). The model goes back
    to the mode it came in."""
    check_f32_matmul(batch_2d)
    was_training = model.training
    model.eval()
    try:
        pred = model(batch_2d, variant)
    finally:
        model.train(was_training)
    n_frames = pred.shape[0] * pred.shape[1]
    return mpjpe(pred, root_relative(batch_3d)) * n_frames, n_frames
