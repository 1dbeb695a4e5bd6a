"""Pose-error metrics (parity target: ``gastx.eval.metrics``).

``mpjpe`` (the training loss's per-joint error), ``weighted_mpjpe`` and
``n_mpjpe`` are torch and differentiable. The Procrustes-aligned
``p_mpjpe`` and the threshold metrics ``pck`` / ``auc`` are host numpy in
float64, as in the JAX package: a batched float32 SVD is too loose for a
sub-0.1 mm parity budget.
"""
from __future__ import annotations

import numpy as np
import torch


def _same_shape(a, b) -> None:
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"shapes differ: {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")


def mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error (Protocol #1)."""
    _same_shape(predicted, target)
    return torch.mean(torch.linalg.norm(predicted - target, dim=-1))


def weighted_mpjpe(predicted: torch.Tensor, target: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Per-joint weighted MPJPE (for ablations)."""
    _same_shape(predicted, target)
    return torch.mean(w * torch.linalg.norm(predicted - target, dim=-1))


def p_mpjpe(predicted, target) -> float:
    """MPJPE after rigid alignment (scale, rotation, translation),
    Protocol #2. ``predicted``/``target``: (B, J, 3) host arrays; the SVD
    recipe with the reflection fix."""
    predicted = np.asarray(predicted)
    target = np.asarray(target)
    _same_shape(predicted, target)

    mu_x = np.mean(target, axis=1, keepdims=True)
    mu_y = np.mean(predicted, axis=1, keepdims=True)
    x0 = target - mu_x
    y0 = predicted - mu_y
    norm_x = np.sqrt(np.sum(x0**2, axis=(1, 2), keepdims=True))
    norm_y = np.sqrt(np.sum(y0**2, axis=(1, 2), keepdims=True))
    x0 = x0 / norm_x
    y0 = y0 / norm_y

    h = np.matmul(np.swapaxes(x0, 1, 2), y0)
    u, s, vt = np.linalg.svd(h)
    v = np.swapaxes(vt, 1, 2)
    r = np.matmul(v, np.swapaxes(u, 1, 2))

    # Fix improper rotations (reflections).
    sign_det_r = np.sign(np.expand_dims(np.linalg.det(r), axis=1))
    v[:, :, -1] *= sign_det_r
    s[:, -1] *= sign_det_r.flatten()
    r = np.matmul(v, np.swapaxes(u, 1, 2))

    tr = np.expand_dims(np.sum(s, axis=1, keepdims=True), axis=2)
    a = tr * norm_x / norm_y                      # scale
    t = mu_x - a * np.matmul(mu_y, r)             # translation
    aligned = a * np.matmul(predicted, r) + t
    return float(np.mean(np.linalg.norm(aligned - target, axis=-1)))


def n_mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MPJPE after optimal scaling only (Protocol #1 variant);
    (B, T, J, 3) inputs."""
    _same_shape(predicted, target)
    norm_predicted = torch.mean(
        torch.sum(predicted**2, dim=3, keepdim=True), dim=2, keepdim=True)
    norm_target = torch.mean(
        torch.sum(target * predicted, dim=3, keepdim=True), dim=2,
        keepdim=True)
    return mpjpe(norm_target / norm_predicted * predicted, target)


def euclidean_losses(actual, target) -> np.ndarray:
    """Per-point Euclidean distances, (B, J)."""
    actual = np.asarray(actual)
    target = np.asarray(target)
    _same_shape(actual, target)
    return np.sqrt(np.sum((actual - target) ** 2, axis=-1))


def pck(actual, expected, threshold: float = 150.0) -> float:
    """Percentage of correct keypoints under ``threshold``."""
    dists = euclidean_losses(actual, expected)
    return float(np.mean((dists < threshold).astype(np.float64)))


def auc(actual, expected) -> float:
    """Mean PCK over thresholds 0..150 in 31 steps."""
    thresholds = np.linspace(0.0, 150.0, 31)
    return float(np.mean([pck(actual, expected, t) for t in thresholds]))
