"""One architecture level on Hopper: the conv chain, then the GAB.

Replaces the TPU kernels ``gastx/ops/pallas/fused_level.py``
``fused_level`` (dilated conv -> BN -> ReLU -> 1x1 -> BN -> ReLU ->
+residual -> GAB, one kernel per sequence) and ``fused_level0`` (init_bn
folded into the expand conv -> BN -> ReLU -> GAB).

On the TPU one kernel holds a whole sequence's level in VMEM. Here the
conv chain is two launches of ``gemm_epilogue`` over all B*T'*J output
rows: the dilated valid conv is three pieces of one product whose tap row
map reads rows q + k*d*J of each sequence (no gather, no im2col copy), BN
and ReLU ride in the epilogue, and the 1x1 product's epilogue adds the
residual slice at ``res_off`` frames. The GAB then runs through
``gastx_torch.ops.cuda.fused_gab.fused_gab``. The TPU's VMEM gate on the sequence
length is not carried: these wrappers take any T, so whole-sequence
lifting stays on them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gastx_torch.ops.batchnorm import fold_bn
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.fused_gab import (GabTables, fused_gab,
                                            fused_gab_plain)
from gastx_torch.ops.temporal import pconv_weight, tconv_weight


class LevelTables(NamedTuple):
    """Folded conv-chain weights of an interior level (float32)."""

    wt: torch.Tensor          # (fw, C, C) dilated conv taps
    bnt_scale: torch.Tensor   # (C,)
    bnt_shift: torch.Tensor
    w1: torch.Tensor          # (C, C) 1x1 conv
    bn1_scale: torch.Tensor
    bn1_shift: torch.Tensor


class Level0Tables(NamedTuple):
    """The expand level with init_bn folded in: w' = w * a[c], and the
    bias sum_{k,c} w[k,c,o] * b[c] goes into expand_bn's shift."""

    w: torch.Tensor           # (fw, C_in, C)
    scale: torch.Tensor       # (C,)
    shift: torch.Tensor


@torch.no_grad()
def level_tables(conv_t: nn.Module, bn_t: nn.Module, conv_1: nn.Module,
                 bn_1: nn.Module) -> LevelTables:
    s_t, t_t = fold_bn(bn_t)
    s_1, t_1 = fold_bn(bn_1)
    return LevelTables(*(K.as_table(t) for t in (
        tconv_weight(conv_t), s_t, t_t, pconv_weight(conv_1), s_1, t_1)))


@torch.no_grad()
def level0_tables(init_bn: nn.Module, expand_conv: nn.Module,
                  expand_bn: nn.Module) -> Level0Tables:
    a_i, b_i = fold_bn(init_bn)
    w = tconv_weight(expand_conv)                          # (fw, C_in, C)
    bias = torch.einsum("kco,c->o", w, b_i)
    s_e, t_e = fold_bn(expand_bn)
    return Level0Tables(K.as_table(w * a_i[None, :, None]), K.as_table(s_e),
                        K.as_table(t_e + bias * s_e))


def _check_x(x: torch.Tensor, c_in: int, span: int) -> None:
    if (x.dim() != 4 or x.shape[-1] != c_in or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous float32 (B, T, J, {c_in}) "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.shape[1] < span:
        raise ValueError(f"{x.shape[1]} frames are fewer than the level's "
                         f"span of {span}")


def _taps(x2, w, j, dilation):
    return [(x2, w[k], k * dilation * j) for k in range(w.shape[0])]


def _level(x, lt, gt, fw, dilation, res_off, gemm, gab):
    b, t, j, c = x.shape
    t_out = t - (fw - 1) * dilation
    m, s_out = b * t_out * j, t_out * j
    x2 = x.reshape(-1, c)
    z = gemm(_taps(x2, lt.wt, j, dilation), m, s_out=s_out, a_s_in=t * j,
             scale=lt.bnt_scale, shift=lt.bnt_shift, relu=True)
    y1 = gemm([(z, lt.w1, 0)], m, s_out=s_out, scale=lt.bn1_scale,
              shift=lt.bn1_shift, relu=True, res=x2, res_s_in=t * j,
              res_off=res_off * j)
    return gab(y1.reshape(b, t_out, j, c), gt)


def _level0(x, l0, gt, gemm, gab):
    b, t, j, c_in = x.shape
    fw, c = l0.w.shape[0], l0.w.shape[2]
    t_out = t - (fw - 1)
    m, s_out = b * t_out * j, t_out * j
    z = gemm(_taps(x.reshape(-1, c_in), l0.w, j, 1), m, s_out=s_out,
             a_s_in=t * j, scale=l0.scale, shift=l0.shift, relu=True)
    return gab(z.reshape(b, t_out, j, c), gt)


def _check_level(x, lt, fw, dilation, res_off):
    if lt.wt.shape[0] != fw:
        raise ValueError(f"conv has {lt.wt.shape[0]} taps, fw is {fw}")
    _check_x(x, lt.wt.shape[1], (fw - 1) * dilation + 1)
    t_out = x.shape[1] - (fw - 1) * dilation
    if not 0 <= res_off <= x.shape[1] - t_out:
        raise ValueError(f"residual offset {res_off} leaves the sequence")


def fused_level_plain(x, lt: LevelTables, gt: GabTables, *, fw: int,
                      dilation: int, res_off: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_level`."""
    _check_level(x, lt, fw, dilation, res_off)
    return _level(x, lt, gt, fw, dilation, res_off, K.gemm_epilogue_plain,
                  fused_gab_plain)


def fused_level(x: torch.Tensor, lt: LevelTables, gt: GabTables, *,
                fw: int, dilation: int, res_off: int) -> torch.Tensor:
    """(B, T, J, C) -> (B, T', J, 2C), T' = T - (fw-1)*dilation: dilated
    conv -> BN -> ReLU -> 1x1 -> BN -> ReLU -> + x[res_off:res_off+T'] ->
    GAB. ``res_off`` is in frames (pad + causal shift)."""
    _check_level(x, lt, fw, dilation, res_off)
    if not K.use_kernel(x.device):
        return fused_level_plain(x, lt, gt, fw=fw, dilation=dilation,
                                 res_off=res_off)
    with K.entry_point("fused_level"):
        return _level(x, lt, gt, fw, dilation, res_off, K.gemm_epilogue,
                      fused_gab)


def fused_level0_plain(x, l0: Level0Tables, gt: GabTables) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_level0`."""
    _check_x(x, l0.w.shape[1], l0.w.shape[0])
    return _level0(x, l0, gt, K.gemm_epilogue_plain, fused_gab_plain)


def fused_level0(x: torch.Tensor, l0: Level0Tables, gt: GabTables
                 ) -> torch.Tensor:
    """Raw (B, T, J, C_in) keypoints -> (B, T-fw+1, J, 2C): the expand
    level [init_bn -> expand conv -> BN -> ReLU -> GAB0], init_bn folded."""
    _check_x(x, l0.w.shape[1], l0.w.shape[0])
    if not K.use_kernel(x.device):
        return fused_level0_plain(x, l0, gt)
    with K.entry_point("fused_level0"):
        return _level0(x, l0, gt, K.gemm_epilogue, fused_gab)
