"""Screen normalization, the world<->camera transforms and the Human3.6M
projection (parity target: ``gastx.geometry.camera``). The screen maps and
``world_to_camera`` are host numpy (the dataset harness runs them);
``camera_to_world`` and ``project_to_2d`` are torch."""
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


def project_to_2d(X: torch.Tensor, camera_params: torch.Tensor
                  ) -> torch.Tensor:
    """Project camera-space 3D points to 2D with the H36M distortion model.

    ``X``: (N, ..., 3) camera-space points; ``camera_params``: (N, 9)
    intrinsics laid out ``[fx, fy, cx, cy, k1, k2, k3, p1, p2]``.
    Reference: common/camera.py:31-62.
    """
    if X.shape[-1] != 3 or camera_params.dim() != 2 \
            or camera_params.shape[-1] != 9 \
            or X.shape[0] != camera_params.shape[0]:
        raise ValueError(f"project_to_2d takes (N, ..., 3) points and (N, 9) "
                         f"intrinsics, got {tuple(X.shape)} and "
                         f"{tuple(camera_params.shape)}")
    camera_params = camera_params.reshape(
        camera_params.shape[:1] + (1,) * (X.dim() - 2) + (9,))
    f = camera_params[..., :2]
    c = camera_params[..., 2:4]
    k = camera_params[..., 4:7]
    p = camera_params[..., 7:]

    XX = X[..., :2] / X[..., 2:]
    r2 = torch.sum(XX**2, dim=-1, keepdim=True)
    radial = 1 + torch.sum(k * torch.cat([r2, r2**2, r2**3], dim=-1),
                           dim=-1, keepdim=True)
    tan = torch.sum(p * XX, dim=-1, keepdim=True)
    XXX = XX * (radial + tan) + p * r2
    return f * XXX + c
