"""Graph-attention primitives over the joint axis, channels-last, eval mode.

Parity target: the eval path of ``gastx.ops.graph``. These are the port's
plain references: the model's ``reference_forward`` runs them, and the
CUDA kernels of ``gastx_torch.ops.cuda`` are held against them. The
model's hybrid routes put kernels between :func:`global_concat` and
:func:`block_concat`, the plain tails of the two modules below.

  * :func:`sem_ch_graph_conv` — channel-wise semantic graph conv with a
    masked softmax over each adjacency row (fill -9e15, not -inf, as the
    reference model/local_attention.py:40 does).
  * :func:`local_graph` — the sym + con two-branch local module.
  * :func:`multi_global_graph` — multi-head non-local attention over
    joints; the reference's ``concat_project`` score decomposes into two
    rank-1 terms f[q, m] = <p_theta, theta_q> + <p_phi, phi_m>.
  * :func:`graph_attention_block` — [x, local, global] -> 3C->2C.

Activations are (B, T, J, C); the modules carry the weights in the
upstream torch layout (gastx_torch.models.gastnet).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gastx_torch.device import check_f32_matmul
from gastx_torch.ops.batchnorm import batch_norm
from gastx_torch.ops.temporal import pconv_weight

MASK_FILL = -9e15


def sem_adjacency(e: torch.Tensor, mask_idx: np.ndarray, j: int
                  ) -> torch.Tensor:
    """Per-channel (C, J, J) row-softmaxed adjacency from edge logits ``e``
    (C, nnz); ``mask_idx`` is the flat row-major order of the nonzeros."""
    c_out = e.shape[0]
    logits = torch.full((c_out, j * j), MASK_FILL, dtype=e.dtype,
                        device=e.device)
    logits[:, torch.as_tensor(mask_idx, device=e.device)] = e
    return torch.softmax(logits.reshape(c_out, j, j), dim=2)


def sem_ch_graph_conv(x: torch.Tensor, w: torch.Tensor, e: torch.Tensor,
                      mask_idx: np.ndarray, j: int) -> torch.Tensor:
    """``x`` (B, T, J, Cin); ``w`` (2, Cin, Cout) self/neighbour weights;
    ``e`` (Cout, nnz) edge logits."""
    check_f32_matmul(x)
    h0 = torch.matmul(x, w[0])
    h1 = torch.matmul(x, w[1])
    adj = sem_adjacency(e, mask_idx, j)
    diag = torch.diagonal(adj, dim1=1, dim2=2)                # (C, J)
    off = adj * (1.0 - torch.eye(j, dtype=x.dtype, device=x.device))
    return h0 * diag.t() + torch.einsum("cjk,btkc->btjc", off, h1)


def local_graph(x: torch.Tensor, mod: nn.Module, statics) -> torch.Tensor:
    """Two-branch (mirror symmetry + kinematic connection) local module."""
    j = statics.num_joints
    a = sem_ch_graph_conv(x, mod.gcn_sym.W, mod.gcn_sym.e, statics.sym_idx, j)
    b = sem_ch_graph_conv(x, mod.gcn_con.W, mod.gcn_con.e, statics.con_idx, j)
    a = torch.relu(batch_norm(a, mod.bn_1))
    b = torch.relu(batch_norm(b, mod.bn_2))
    y = torch.matmul(torch.cat([a, b], dim=-1), pconv_weight(mod.cat_conv))
    return torch.relu(batch_norm(y, mod.cat_bn))


def multi_global_graph(x: torch.Tensor, mod: nn.Module) -> torch.Tensor:
    """Multi-head attention over joints, one head at a time; head outputs
    concatenate head-major as in the reference's torch.cat."""
    check_f32_matmul(x)
    outs = []
    for head in mod.attentions:
        theta = torch.matmul(x, pconv_weight(head.theta)) + head.theta.bias
        phi = torch.matmul(x, pconv_weight(head.phi)) + head.phi.bias
        g = torch.matmul(x, pconv_weight(head.g)) + head.g.bias
        proj = head.concat_project[0].weight.reshape(-1)       # (2I,)
        inter = theta.shape[-1]
        sa = torch.matmul(theta, proj[:inter])                 # (B, T, J)
        sb = torch.matmul(phi, proj[inter:])
        f = F.leaky_relu(sa[..., :, None] + sb[..., None, :], 0.2)
        attn = torch.softmax(f, dim=-1) + head.C_k
        outs.append(torch.matmul(attn, g))                     # (B, T, J, G)
    return global_concat(outs, mod)


def global_concat(heads: list, mod: nn.Module) -> torch.Tensor:
    """The global branch's head outputs (head-major) -> K*G->C 1x1 conv ->
    BN -> ReLU."""
    y = torch.matmul(torch.cat(heads, dim=-1), pconv_weight(mod.cat_conv))
    return torch.relu(batch_norm(y, mod.cat_bn))


def graph_attention_block(x: torch.Tensor, mod: nn.Module, statics
                          ) -> torch.Tensor:
    """residual ++ local ++ global -> 1x1 conv (3C->2C) -> BN -> ReLU."""
    local = local_graph(x, mod.local_graph_layer, statics)
    globl = multi_global_graph(x, mod.global_graph_layer)
    return block_concat(x, local, globl, mod)


def block_concat(x: torch.Tensor, local: torch.Tensor, globl: torch.Tensor,
                 mod: nn.Module) -> torch.Tensor:
    """The GAB's [x, local, global] -> 1x1 conv (3C->2C) -> BN -> ReLU."""
    y = torch.matmul(torch.cat([x, local, globl], dim=-1),
                     pconv_weight(mod.cat_conv))
    return torch.relu(batch_norm(y, mod.cat_bn))
