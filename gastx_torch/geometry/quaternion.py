"""Quaternion rotation (parity target: ``gastx.geometry.quaternion.qrot``).

Quaternions are ``(..., 4)`` tensors ``[w, x, y, z]``, assumed unit-norm.
"""
from __future__ import annotations

import torch


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` (..., 3) by unit quaternion(s) ``q`` (..., 4):
    ``v' = v + 2*(w*(qv x v) + qv x (qv x v))``."""
    if q.shape[-1] != 4 or v.shape[-1] != 3:
        raise ValueError(f"qrot takes (..., 4) and (..., 3), got "
                         f"{tuple(q.shape)} and {tuple(v.shape)}")
    lead = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
    q, v = q.expand(lead + (4,)), v.expand(lead + (3,))
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)
