"""Temporal convolution primitives, channels-last.

Parity target: ``gastx.ops.temporal``. The conv is written as tap
matmuls, never through cuDNN: PyTorch runs float32 convolutions in TF32
by default, which the f32 port must not do.

Both functions are plain sites (the JAX package's XLA sites) and take the
site's ``tier`` (``gastx_torch.ops.precision``; the model resolves it,
``"highest"`` on the CPU) and an optional eval epilogue: ``bn`` (an
``nn.BatchNorm2d`` on its running statistics), ``relu``, and for
:func:`pointwise` a bias ``shift``. At ``"highest"``, and on bf16
operands (every tier the same function), they are torch products with
the epilogue in torch, in that order. Below it on float32 operands the
product runs on ``kernels.gemm_epilogue`` at the tier (``gemm_tc``, or
``gemm_smallk`` for the expand conv's K = 2 taps; their plain versions
with ``plain``), the epilogue folded into the kernel's: the conv's taps as
pieces of one product over the tap row map, as ``fused_level`` reads
them. Where autograd records the product (the train step: grad mode on
and ``x`` or ``w`` requiring a gradient), the tiered product runs through
``site_grad.SiteGemm`` instead, whose backward computes the input and
weight gradients at the same tier; the epilogue is then torch's, and the
train forward passes none (it applies the train BN itself).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gastx_torch.device import check_f32_matmul
from gastx_torch.ops.batchnorm import batch_norm, fold_bn
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.site_grad import MAX_PIECES, conv_site, \
    grad_needed, site_conv, site_product


def _torch_tail(y, bn, relu):
    if bn is not None:
        y = batch_norm(y, bn)
    return torch.relu(y) if relu else y


def _epilogue(bn: Optional[nn.Module], relu: bool, n: int, like, shift=None
              ) -> dict:
    """gemm_epilogue's scale/shift/relu keywords for a BN or a bias."""
    if bn is not None:
        scale, shift = fold_bn(bn)
    elif shift is not None:
        scale = torch.ones(n, dtype=torch.float32, device=like.device)
    else:
        scale = None
    return dict(scale=scale, shift=shift, relu=relu)


def temporal_conv(x: torch.Tensor, w: torch.Tensor, *,
                  dilation: int = 1, stride: int = 1,
                  tier: str = "highest", bn: Optional[nn.Module] = None,
                  relu: bool = False, plain: bool = False,
                  op: str = "temporal") -> torch.Tensor:
    """Valid dilated, strided temporal conv, then ``bn`` and ``relu``.

    ``x``: (B, T, N, Cin); ``w``: (fw, Cin, Cout). Returns (B, T', N, Cout)
    with T' = (T - (fw-1)*dilation - 1) // stride + 1, the length the JAX
    package's VALID ``conv_general_dilated`` gives: output frame t sums tap
    k of input frame t*stride + k*dilation. At ``"highest"`` each tap is
    one matmul on a strided frame view; bf16 operands (bf16 storage) take
    the taps side by side in one product, so that the conv sums in float32
    and rounds once, as the JAX package's bf16 conv does. Below it (the
    module docstring; ``op`` names the site's class, ``"expand"`` or
    ``"temporal"``) the taps are the pieces of ``gemm_epilogue`` launches
    at ``tier``: the row map reads frame t + k*dilation of each sequence
    (stride 1), or, strided, frame t*stride + k of one output frame's
    sequence, once the input is cut to its first T'*stride frames (a
    stride past the taps' reach, (fw-1)*dilation < stride). More than
    three taps (the dense convs) chain launches of three, each adding the
    last one's partial sum, with ``bn`` and ``relu`` in torch after.
    """
    check_f32_matmul(x)
    fw = w.shape[0]
    span = (fw - 1) * dilation + 1
    if x.shape[1] < span:
        raise ValueError(f"sequence of {x.shape[1]} frames is shorter than "
                         f"the conv's span {span}")
    t_out = (x.shape[1] - span) // stride + 1
    if tier != "highest" and x.dtype == torch.float32 and grad_needed(x, w):
        return _torch_tail(site_conv(op, x, w, dilation, stride, t_out, tier,
                                     plain), bn, relu)
    if tier != "highest" and x.dtype == torch.float32:
        return _tiered_conv(x, w, dilation, stride, t_out, tier, bn, relu,
                            plain, op)
    K.count_site(op, "highest", x)
    last = (t_out - 1) * stride + 1
    if x.dtype == torch.bfloat16:
        taps = [x[:, k * dilation:k * dilation + last:stride]
                for k in range(fw)]
        y = torch.matmul(torch.cat(taps, dim=-1),
                         w.reshape(fw * w.shape[1], w.shape[2]))
        return _torch_tail(y, bn, relu)
    y = torch.matmul(x[:, 0:last:stride], w[0])
    for k in range(1, fw):
        s = k * dilation
        y = y + torch.matmul(x[:, s:s + last:stride], w[k])
    return _torch_tail(y, bn, relu)


def _tiered_conv(x, w, dilation, stride, t_out, tier, bn, relu, plain, op):
    b, _, j, _ = x.shape
    fw, n = w.shape[0], w.shape[2]
    site, rows = conv_site(op, x, fw, dilation, stride, t_out, tier, plain)
    w = w.to(torch.float32).contiguous()
    if fw <= MAX_PIECES:
        return site.forward(w, [rows], **_epilogue(bn, relu, n, x)).reshape(
            b, t_out, j, n)
    return _torch_tail(site.forward(w, [rows]).reshape(b, t_out, j, n), bn,
                       relu)


def pointwise(x: torch.Tensor, w: torch.Tensor, *, tier: str = "highest",
              shift: Optional[torch.Tensor] = None,
              bn: Optional[nn.Module] = None, relu: bool = False,
              plain: bool = False, op: str = "mid1x1") -> torch.Tensor:
    """1x1 conv == dense matmul over the channel axis; ``w``: (Cin, Cout);
    then ``+ shift``, ``bn`` and ``relu``; below ``"highest"`` one
    ``gemm_epilogue`` launch at ``tier`` (the module docstring; ``op``
    names the site's class)."""
    check_f32_matmul(x)
    if tier != "highest" and x.dtype == torch.float32 and grad_needed(x, w):
        y = site_product(op, [x], w, tier, plain)
        if shift is not None:
            y = y + shift
        return _torch_tail(y, bn, relu)
    if tier != "highest" and x.dtype == torch.float32:
        n = w.shape[1]
        y = K.site_gemm(op, [(x.reshape(-1, x.shape[-1]).contiguous(),
                              w.to(torch.float32).contiguous(), 0)],
                        x.numel() // x.shape[-1], tier, plain,
                        **_epilogue(bn, relu, n, x, shift))
        return y.reshape(*x.shape[:-1], n)
    K.count_site(op, "highest", x)
    y = torch.matmul(x, w)
    if shift is not None:
        y = y + shift
    return _torch_tail(y, bn, relu)


def tconv_weight(conv: torch.nn.Conv2d) -> torch.Tensor:
    """Torch temporal conv weight (Cout, Cin, fw, 1) -> (fw, Cin, Cout)."""
    return conv.weight[:, :, :, 0].permute(2, 1, 0)


def pconv_weight(conv: torch.nn.Module) -> torch.Tensor:
    """Torch 1x1 conv weight (Cout, Cin, 1[, 1]) -> (Cin, Cout)."""
    return conv.weight.reshape(conv.weight.shape[0], -1).t()
