"""Screen normalization and camera->world transform (parity target:
``gastx.geometry.camera``)."""
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


def camera_to_world(X: torch.Tensor, R: torch.Tensor, t) -> torch.Tensor:
    """Rotate camera-frame points ``X`` (..., 3) by the camera->world unit
    quaternion ``R`` (4,) and translate by ``t``."""
    R = torch.as_tensor(R, dtype=X.dtype, device=X.device)
    return qrot(R.expand(X.shape[:-1] + (4,)), X) + torch.as_tensor(
        t, dtype=X.dtype, device=X.device)
