"""The eval multi-head global branch on Hopper.

Replaces the TPU kernel ``gastx/ops/pallas/global_attn.py``
``fused_global_attention``: ``multi_global_graph`` from the theta/phi/g
projections through the head concat, the K*G -> C cat, its BN and ReLU,
for C <= 512. The TPU kernel keeps the 4*C^2 weights in VMEM and runs
the whole branch per row tile. Here it is the GAB chain's global half
(``kernels.global_chain``), three launches over M = B*T*J rows:

  1. ``gemm_epilogue``: P = x @ [theta | phi | g] + biases (2KI + KG
     columns, head-major);
  2. ``joint_attention``: each head's rank-1 scores, LeakyReLU, softmax,
     +C_k and apply, from column views of P;
  3. ``gemm_epilogue``: relu(BN(heads @ W_cat)).

The two products are bound by the float32 FMA rate, the attention by
device-memory bytes (see the sources). No model route of the JAX package
reaches the TPU kernel, and none of the port's does: the model's GAB runs
the same chain inside ``fused_gab``. It has tables of its own
(:func:`global_tables`) because the TPU kernel takes the branch's
weights and its folded BN alone.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from gastx_torch.ops.batchnorm import fold_bn
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.temporal import pconv_weight

MAX_CHANNELS = 512
# The TPU kernel's dots by op class (gastx/ops/pallas/global_attn.py:38);
# ``tiers`` below is a dict over them (None: all "highest").
KERNEL_OPS = ("attn_proj", "attn_score", "attn_apply", "attn_cat")


class GlobalTables(NamedTuple):
    """Host-side weights of one ``MultiGlobalGraph`` in the kernels'
    layouts (float32, contiguous, on the module's device)."""

    w_attn: torch.Tensor      # (C, 2KI + KG)  theta | phi | g, head-major
    attn_scale: torch.Tensor  # (2KI + KG,)    ones
    attn_shift: torch.Tensor  # (2KI + KG,)    biases
    proj_t: torch.Tensor      # (K, I)
    proj_p: torch.Tensor      # (K, I)
    c_k: torch.Tensor         # (K, J, J)
    acat_w: torch.Tensor      # (KG, C)
    acat_scale: torch.Tensor  # (C,)
    acat_shift: torch.Tensor


def attn_columns(mod: nn.Module):
    """One ``MultiGlobalGraph``'s projection, unfolded: its head-major
    [theta | phi | g] weight blocks, (C, KI), (C, KI) and (C, KG), and
    their (2KI + KG,) biases. The GAB's tables put them beside the local
    branch's in one projection."""
    heads = list(mod.attentions)

    def cat_cols(name):  # head-major (C, K*width) columns and (K*width,)
        return (torch.cat([pconv_weight(getattr(h, name)) for h in heads], 1),
                torch.cat([getattr(h, name).bias for h in heads]))

    (wt, bt), (wp, bp), (wg, bg) = (cat_cols("theta"), cat_cols("phi"),
                                    cat_cols("g"))
    return [wt, wp, wg], torch.cat([bt, bp, bg])


def fold_columns(mod: nn.Module):
    """:func:`attn_columns` in the TPU kernels' fold form
    (``_global_ins_fold``, ``gastx/ops/pallas/fused_gab.py:673``): each
    head k's theta and phi columns contracted with its score vectors,
    wsa_k = W_theta_k @ p_theta_k and wsb_k likewise, (C, K) each, their
    biases b_theta_k . p_theta_k and b_phi_k . p_phi_k, then g's columns
    as they are; computed in float32."""
    (wt, wp, wg), bias = attn_columns(mod)
    heads = list(mod.attentions)
    k = len(heads)
    proj = torch.stack([K.upcast(h.concat_project[0].weight.reshape(-1))
                        for h in heads])                      # (K, 2I)
    inter = proj.shape[1] // 2
    c = wt.shape[0]

    def fold(w, b, p):  # (C, KI), (KI,), (K, I) -> (C, K), (K,)
        w = K.upcast(w).reshape(c, k, inter)
        return ((w * p).sum(-1), (K.upcast(b).reshape(k, inter) * p).sum(-1))

    (wsa, bsa), (wsb, bsb) = (fold(wt, bias[:k * inter], proj[:, :inter]),
                              fold(wp, bias[k * inter:2 * k * inter],
                                   proj[:, inter:]))
    return ([wsa, wsb, K.upcast(wg)],
            torch.cat([bsa, bsb, K.upcast(bias[2 * k * inter:])]))


def head_tables(mod: nn.Module) -> dict:
    """The :class:`GlobalTables` fields after the projection: the score
    vectors, the biases C_k and the folded K*G -> C cat."""
    heads = list(mod.attentions)
    proj = torch.stack([h.concat_project[0].weight.reshape(-1)
                        for h in heads])                      # (K, 2I)
    inter = proj.shape[1] // 2
    s_a, t_a = fold_bn(mod.cat_bn)
    return dict(proj_t=K.as_table(proj[:, :inter]),
                proj_p=K.as_table(proj[:, inter:]),
                c_k=K.as_table(torch.stack([h.C_k for h in heads])),
                acat_w=K.as_table(pconv_weight(mod.cat_conv)),
                acat_scale=K.as_table(s_a), acat_shift=K.as_table(t_a))


@torch.no_grad()
def global_tables(mod: nn.Module) -> GlobalTables:
    """Fold one ``MultiGlobalGraph``'s weights into :class:`GlobalTables`."""
    cols, shift = attn_columns(mod)
    return GlobalTables(
        w_attn=K.as_table(torch.cat(cols, dim=1)),
        attn_scale=K.as_table(torch.ones_like(shift)),
        attn_shift=K.as_table(shift), **head_tables(mod))


def _check(x: torch.Tensor, t: GlobalTables) -> int:
    c = t.w_attn.shape[0]
    K.check_blocks(x, c, t.c_k.shape[1], MAX_CHANNELS,
                   "fused_global_attention")
    return c


def fused_global_attention_plain(x: torch.Tensor, t: GlobalTables,
                                 tiers: Optional[Dict[str, str]] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_global_attention`."""
    c = _check(x, t)
    y = K.global_chain(x.reshape(-1, c), t, K.gemm_epilogue_plain,
                       K.joint_attention_plain, tiers=tiers)
    return y.reshape(x.shape)


def fused_global_attention(x: torch.Tensor, t: GlobalTables,
                           tiers: Optional[Dict[str, str]] = None
                           ) -> torch.Tensor:
    """(B, T, J, C) -> (B, T, J, C), the eval ``multi_global_graph``,
    C <= 512, its dots at ``tiers`` (``KERNEL_OPS``)."""
    K.check_no_grad("fused_global_attention", x, t)
    c = _check(x, t)
    if not K.use_kernel(x.device):
        return fused_global_attention_plain(x, t, tiers)
    with K.entry_point("fused_global_attention"):
        y = K.global_chain(x.reshape(-1, c), t, K.gemm_epilogue,
                           K.joint_attention, tiers=tiers)
    return y.reshape(x.shape)
