"""One attention head over the joints, on Hopper.

Replaces the TPU kernel ``gastx/ops/pallas/head_attn.py``
``head_attention``: for one head, the rank-1 scores of theta and phi,
LeakyReLU(0.2), the softmax over the keys, +C_k and the apply to g. The
TPU kernel runs it once per head so that the (M, J, J) score tensors,
which pad J to 128 lanes, never reach HBM; the projections and the cat
stay outside it. Here it is one launch of the ``joint_attention`` CUDA
kernel with one head (``gastx_torch/csrc/joint_attention.cu``: persistent
blocks over tiles of frames, the scores in shared memory, bound by
device-memory bytes). That kernel reads column views of one projection
output, so the head's slices go in without a copy; its 16-byte
instantiation takes them where I and G are multiples of 4
(``kernels.graph_variant``).
"""
from __future__ import annotations

import torch

from gastx_torch.ops.cuda import kernels as K


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """(M, J, width) -> the (M*J, width) view of the same memory."""
    if t.dim() != 3:
        raise ValueError(f"{name} must be (M, J, width), got "
                         f"{tuple(t.shape)}")
    try:
        return t.view(-1, t.shape[2])
    except RuntimeError as e:
        raise ValueError(f"{name}'s frames and joints do not merge into "
                         f"rows without a copy") from e


def _args(theta_k, phi_k, g_k, proj_t, proj_p, c_k):
    """``joint_attention``'s arguments with one head (K = 1)."""
    theta, phi, g = (_rows(theta_k, "theta_k"), _rows(phi_k, "phi_k"),
                     _rows(g_k, "g_k"))
    _, j, inter = theta_k.shape
    if (phi_k.shape != theta_k.shape or g_k.shape[:2] != theta_k.shape[:2]
            or proj_t.shape != (inter, 1) or proj_p.shape != (inter, 1)
            or c_k.shape != (j, j)):
        raise ValueError(
            f"head_attention takes theta/phi (M, J, I), g (M, J, G), "
            f"proj_t/proj_p (I, 1) and c_k (J, J); got {tuple(theta_k.shape)}"
            f", {tuple(phi_k.shape)}, {tuple(g_k.shape)}, "
            f"{tuple(proj_t.shape)}, {tuple(proj_p.shape)}, "
            f"{tuple(c_k.shape)}")
    return (theta, phi, g, proj_t.reshape(1, inter),
            proj_p.reshape(1, inter), c_k.reshape(1, j, j))


def head_attention_plain(theta_k, phi_k, g_k, proj_t, proj_p, c_k, *,
                         score_tier: str = "highest",
                         apply_tier: str = "highest") -> torch.Tensor:
    """Plain PyTorch version of :func:`head_attention`."""
    out = K.joint_attention_plain(*_args(theta_k, phi_k, g_k, proj_t,
                                         proj_p, c_k),
                                  score_tier=score_tier,
                                  apply_tier=apply_tier)
    return out.reshape(g_k.shape)


def head_attention(theta_k: torch.Tensor, phi_k: torch.Tensor,
                   g_k: torch.Tensor, proj_t: torch.Tensor,
                   proj_p: torch.Tensor, c_k: torch.Tensor, *,
                   score_tier: str = "highest",
                   apply_tier: str = "highest") -> torch.Tensor:
    """One head: theta_k/phi_k (M, J, I) and g_k (M, J, G) -> (M, J, G).

    ``proj_t``/``proj_p`` (I, 1) are the rank-1 score vectors, ``c_k``
    (J, J) the bias added after the softmax. The three activations must
    share one row stride, as column views of one projection output do.
    ``score_tier``/``apply_tier``: the tiers of the score and apply dots
    (the TPU kernel's, ``gastx/ops/pallas/head_attn.py:43-56``); the same
    ``joint_attention`` instantiations as the chain's.
    """
    K.check_no_grad("head_attention", theta_k, phi_k, g_k, proj_t, proj_p,
                    c_k)
    args = _args(theta_k, phi_k, g_k, proj_t, proj_p, c_k)
    if not K.use_kernel(theta_k.device):
        return head_attention_plain(theta_k, phi_k, g_k, proj_t, proj_p, c_k,
                                    score_tier=score_tier,
                                    apply_tier=apply_tier)
    with K.entry_point("head_attention"):
        out = K.joint_attention(*args, score_tier=score_tier,
                                apply_tier=apply_tier)
    return out.reshape(g_k.shape)
