"""Temporal convolution primitives, channels-last.

Parity target: ``gastx.ops.temporal``. The conv is written as tap
matmuls, never through cuDNN: PyTorch runs float32 convolutions in TF32
by default, which the f32 port must not do.
"""
from __future__ import annotations

import torch

from gastx_torch.device import check_f32_matmul


def temporal_conv(x: torch.Tensor, w: torch.Tensor, *,
                  dilation: int = 1, stride: int = 1) -> torch.Tensor:
    """Valid dilated, strided temporal conv.

    ``x``: (B, T, N, Cin); ``w``: (fw, Cin, Cout). Returns (B, T', N, Cout)
    with T' = (T - (fw-1)*dilation - 1) // stride + 1, the length the JAX
    package's VALID ``conv_general_dilated`` gives: output frame t sums tap
    k of input frame t*stride + k*dilation. Each tap is one matmul on a
    strided frame view; bf16 operands (bf16 storage) take the taps side by
    side in one product, so that the conv sums in float32 and rounds once,
    as the JAX package's bf16 conv does.
    """
    check_f32_matmul(x)
    fw = w.shape[0]
    span = (fw - 1) * dilation + 1
    if x.shape[1] < span:
        raise ValueError(f"sequence of {x.shape[1]} frames is shorter than "
                         f"the conv's span {span}")
    t_out = (x.shape[1] - span) // stride + 1
    last = (t_out - 1) * stride + 1
    if x.dtype == torch.bfloat16:
        taps = [x[:, k * dilation:k * dilation + last:stride]
                for k in range(fw)]
        return torch.matmul(torch.cat(taps, dim=-1),
                            w.reshape(fw * w.shape[1], w.shape[2]))
    y = torch.matmul(x[:, 0:last:stride], w[0])
    for k in range(1, fw):
        s = k * dilation
        y = y + torch.matmul(x[:, s:s + last:stride], w[k])
    return y


def pointwise(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv == dense matmul over the channel axis; ``w``: (Cin, Cout)."""
    check_f32_matmul(x)
    return torch.matmul(x, w)


def tconv_weight(conv: torch.nn.Conv2d) -> torch.Tensor:
    """Torch temporal conv weight (Cout, Cin, fw, 1) -> (fw, Cin, Cout)."""
    return conv.weight[:, :, :, 0].permute(2, 1, 0)


def pconv_weight(conv: torch.nn.Module) -> torch.Tensor:
    """Torch 1x1 conv weight (Cout, Cin, 1[, 1]) -> (Cin, Cout)."""
    return conv.weight.reshape(conv.weight.shape[0], -1).t()
