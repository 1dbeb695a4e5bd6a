"""Ablation and alternative spatial modules kept for reference parity (the
counterpart of ``gastx.ops.ablations``).

Modules the reference ships but does not use in its default
configuration, each an ``nn.Module`` with the reference's state-dict keys
and a functional forward:

  * :class:`SemGraphConv` / :func:`sem_graph_conv` — the NON-channel-wise
    semantic graph conv, one edge-weight vector shared across channels
    (reference ``model/sem_graph_conv.py:10-55``; the production model
    uses the channel-wise one).
  * :class:`LocalGraphSimple` / :func:`local_graph_simple` — the
    LocalGraph built on it (``model/sem_graph_conv.py:58-153``).
  * :class:`SingleGlobalGraph` / :func:`single_global_graph` — the
    single-head non-local alternative to MultiGlobalGraph
    (``model/global_attention.py:133-173``).

They mask the adjacency with the JAX fill (-9e15) and drop out where the
JAX functions do, in plain PyTorch on any device, as the JAX package runs
them in plain XLA. In train mode each BN takes the batch statistics and
updates its running ones in place (``ops.batchnorm``). The JAX parameter
dicts load through ``gastx_torch.io.ablation_params_from_jax``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gastx_torch.device import check_f32_matmul
from gastx_torch.models.config import GraphStatics
from gastx_torch.models.gastnet import GlobalHead
from gastx_torch.ops.batchnorm import batch_norm
from gastx_torch.ops.graph import MASK_FILL, dropout
from gastx_torch.ops.temporal import pconv_weight


class SemGraphConv(nn.Module):
    """W (2, Cin, Cout) self/neighbour weights, e (1, nnz) edge logits
    shared by every channel, in the flat row-major order of the
    adjacency's nonzeros ``mask_idx``, and an optional bias (Cout,)."""

    def __init__(self, c_in: int, c_out: int, mask_idx: np.ndarray,
                 num_joints: int, bias: bool = True):
        super().__init__()
        self.mask_idx, self.num_joints = mask_idx, num_joints
        self.W = nn.Parameter(torch.zeros(2, c_in, c_out))
        self.e = nn.Parameter(torch.ones(1, len(mask_idx)))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sem_graph_conv(x, self, self.mask_idx, self.num_joints)


def sem_graph_conv(x: torch.Tensor, mod: SemGraphConv, mask_idx: np.ndarray,
                   num_joints: int) -> torch.Tensor:
    """Shared-edge-weight semantic graph conv of ``x`` (B, T, J, Cin)."""
    check_f32_matmul(x)
    j = num_joints
    h0 = torch.matmul(x, mod.W[0])
    h1 = torch.matmul(x, mod.W[1])
    logits = torch.full((j * j,), MASK_FILL, dtype=x.dtype, device=x.device)
    logits[torch.as_tensor(mask_idx, device=x.device)] = mod.e.reshape(-1)
    adj = torch.softmax(logits.reshape(j, j), dim=1)
    diag = torch.diagonal(adj)
    off = adj * (1.0 - torch.eye(j, dtype=x.dtype, device=x.device))
    out = h0 * diag[:, None] + torch.einsum("jk,btkc->btjc", off, h1)
    return out if mod.bias is None else out + mod.bias


class LocalGraphSimple(nn.Module):
    """The two-branch local module on :class:`SemGraphConv`: the mirror
    symmetry and kinematic connection branches, each BN/ReLU, a 2C->C 1x1
    conv, BN, ReLU and dropout at ``rate`` in train mode."""

    def __init__(self, c: int, statics: GraphStatics, rate: float = 0.0):
        super().__init__()
        self.statics, self.rate = statics, rate
        j = statics.num_joints
        self.gcn_sym = SemGraphConv(c, c, statics.sym_idx, j)
        self.gcn_con = SemGraphConv(c, c, statics.con_idx, j)
        self.bn_1 = nn.BatchNorm2d(c)
        self.bn_2 = nn.BatchNorm2d(c)
        self.cat_conv = nn.Conv2d(2 * c, c, 1, bias=False)
        self.cat_bn = nn.BatchNorm2d(c)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return local_graph_simple(x, self, self.statics, train=self.training,
                                  rate=self.rate, generator=generator)


def local_graph_simple(x: torch.Tensor, mod: LocalGraphSimple, statics, *,
                       train: bool = False, rate: float = 0.0,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """(B, T, J, C) -> (B, T, J, C) (``model/sem_graph_conv.py:126-153``)."""
    j = statics.num_joints
    a = sem_graph_conv(x, mod.gcn_sym, statics.sym_idx, j)
    b = sem_graph_conv(x, mod.gcn_con, statics.con_idx, j)
    a = torch.relu(batch_norm(a, mod.bn_1, train=train))
    b = torch.relu(batch_norm(b, mod.bn_2, train=train))
    y = torch.matmul(torch.cat([a, b], dim=-1), pconv_weight(mod.cat_conv))
    y = torch.relu(batch_norm(y, mod.cat_bn, train=train))
    if train and rate > 0.0:
        y = dropout(y, rate, generator)
    return y


class SingleGlobalGraph(nn.Module):
    """One attention head (theta/phi/g 1x1 projections, the rank-1
    ``concat_project`` score, the (J, J) bias C_k) with BN directly on its
    output: no cat conv."""

    def __init__(self, c: int, inter: int, g_ch: int, num_joints: int,
                 rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.attentions = GlobalHead(c, inter, g_ch, num_joints)
        self.bn = nn.BatchNorm2d(g_ch)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return single_global_graph(x, self, train=self.training,
                                   rate=self.rate, generator=generator)


def single_global_graph(x: torch.Tensor, mod: SingleGlobalGraph, *,
                        train: bool = False, rate: float = 0.0,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """(B, T, J, C) -> (B, T, J, G) (``global_attention.py:146-173``)."""
    check_f32_matmul(x)
    head = mod.attentions
    theta = torch.matmul(x, pconv_weight(head.theta)) + head.theta.bias
    phi = torch.matmul(x, pconv_weight(head.phi)) + head.phi.bias
    g = torch.matmul(x, pconv_weight(head.g)) + head.g.bias
    proj = head.concat_project[0].weight.reshape(-1)
    inter = theta.shape[-1]
    score = (torch.matmul(theta, proj[:inter])[..., :, None]
             + torch.matmul(phi, proj[inter:])[..., None, :])
    attn = torch.softmax(F.leaky_relu(score, 0.2), dim=-1) + head.C_k
    y = torch.relu(batch_norm(torch.matmul(attn, g), mod.bn, train=train))
    if train and rate > 0.0:
        y = dropout(y, rate, generator)
    return y
