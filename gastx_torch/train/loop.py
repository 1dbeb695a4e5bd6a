"""The train and eval steps (parity target: ``gastx.train.loop``).

:func:`train_step` is ``train_step_body``: the target's root joint
zeroed, the train forward (plain ops with autograd, batch-statistic BN,
dropout), the per-sample weighted MPJPE, backward and one amsgrad step at
the given learning rate. Ragged last batches are padded to the fixed
batch with zero-weight filler rows, so the loss and its gradient are the
partial batch's mean; the filler rows still enter the BN batch
statistics, as in the JAX package (``PARITY.md``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gastx_torch.device import check_f32_matmul
from gastx_torch.eval.metrics import mpjpe
from gastx_torch.models.gastnet import GastNet
from gastx_torch.train.optimizer import set_lr


def root_relative(batch_3d: torch.Tensor) -> torch.Tensor:
    """The target with its root joint (joint 0) zeroed."""
    target = batch_3d.clone()
    target[:, :, 0] = 0.0
    return target


def weighted_loss(pred: torch.Tensor, target: torch.Tensor,
                  sample_weight: torch.Tensor) -> torch.Tensor:
    """Per-sample MPJPE averaged with ``sample_weight`` (B,)."""
    err = torch.linalg.norm(pred - target, dim=-1).mean(dim=(1, 2))
    return torch.sum(err * sample_weight) / torch.sum(sample_weight)


def train_step(model: GastNet, opt: torch.optim.Optimizer,
               batch_2d: torch.Tensor, batch_3d: torch.Tensor,
               sample_weight: torch.Tensor, lr: float,
               generator: Optional[torch.Generator],
               variant: str = "strided") -> torch.Tensor:
    """One step on ``batch_2d`` (B, T_in, J, C_in) and the camera-space
    targets ``batch_3d`` (B, T_out, J, 3), ``sample_weight`` (B,) zero
    for filler rows. Returns the loss (a device scalar, not synced)."""
    check_f32_matmul(batch_2d)
    model.train()
    loss = weighted_loss(model(batch_2d, variant, generator=generator),
                         root_relative(batch_3d), sample_weight)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    set_lr(opt, lr)
    opt.step()
    return loss.detach()


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
