"""Screen normalization and the world<->camera transforms (parity target:
``gastx.geometry.camera``). The screen maps and ``world_to_camera`` are
host numpy (the dataset harness runs them); ``camera_to_world`` is
torch."""
from __future__ import annotations

import numpy as np
import torch

from gastx_torch.geometry.quaternion import qrot


def normalize_screen_coordinates(X: np.ndarray, w: float, h: float
                                 ) -> np.ndarray:
    """Map pixel coords so that [0, w] -> [-1, 1], keeping the aspect
    ratio. Host-side numpy in and out."""
    if X.shape[-1] != 2:
        raise ValueError(f"expected (..., 2) pixel coords, got {X.shape}")
    return X / w * 2.0 - np.asarray([1.0, h / w], dtype=X.dtype)


def image_coordinates(X: np.ndarray, w: float, h: float) -> np.ndarray:
    """Inverse of :func:`normalize_screen_coordinates`."""
    if X.shape[-1] != 2:
        raise ValueError(f"expected (..., 2) screen coords, got {X.shape}")
    return (X + np.asarray([1.0, h / w], dtype=X.dtype)) * w / 2.0


def _qrot_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def world_to_camera(X: np.ndarray, R: np.ndarray, t) -> np.ndarray:
    """World points ``X`` (..., 3) into the frame of a camera whose
    camera->world unit quaternion is ``R`` (4,) and whose world
    translation is ``t``: the inverse rotation of ``X - t``. Returns a new
    array."""
    X = np.asarray(X)
    R = np.asarray(R, dtype=X.dtype)
    r_inv = np.concatenate([R[..., :1], -R[..., 1:]], axis=-1)
    r_inv = np.broadcast_to(r_inv, X.shape[:-1] + (4,))
    return _qrot_np(r_inv, X - np.asarray(t, dtype=X.dtype))


def camera_to_world(X: torch.Tensor, R: torch.Tensor, t) -> torch.Tensor:
    """Rotate camera-frame points ``X`` (..., 3) by the camera->world unit
    quaternion ``R`` (4,) and translate by ``t``."""
    R = torch.as_tensor(R, dtype=X.dtype, device=X.device)
    return qrot(R.expand(X.shape[:-1] + (4,)), X) + torch.as_tensor(
        t, dtype=X.dtype, device=X.device)
