"""Graph-attention primitives over the joint axis, channels-last.

Parity target: the XLA path of ``gastx.ops.graph``, eval and train. These
are the port's plain references: the model's ``reference_forward`` and
its train forward run them, and the CUDA kernels of
``gastx_torch.ops.cuda`` are held against them. The model's hybrid routes
put kernels between :func:`global_concat` and :func:`block_concat`, the
plain tails of the two modules below.

With ``train=True`` every BN takes the batch statistics (and updates its
running ones), and :func:`dropout` runs at the JAX package's two GAB
sites: the local branch's output after its cat BN/ReLU and the global
branch's after its cat. Every op is differentiable: no in-place write
touches a tensor that autograd saved. Under a ``mesh`` of more than one
rank (``gastx_torch.parallel``) the BN statistics and the dropout masks
are the global batch's, so that the ranks together compute what one
process computes on the whole batch.

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

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gastx_torch.device import check_f32_matmul
from gastx_torch.ops.batchnorm import batch_norm
from gastx_torch.parallel.mesh import Mesh, batch_sharding
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


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Inverted dropout: keep each value with probability 1 - ``rate``
    (a mask drawn from ``generator``) and scale the kept ones by
    1 / (1 - rate), as the JAX ``_dropout`` does. Under a ``mesh`` of more
    than one rank the mask is drawn at the global batch's shape (the
    generator's offset advances alike on every rank) and this rank keeps
    its own rows of it, as JAX's dropout over a sharded batch does."""
    keep = 1.0 - rate
    if mesh is None or mesh.size == 1:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        u = torch.rand((x.shape[0] * mesh.size, *x.shape[1:]),
                       generator=generator, device=x.device)
        u = u[batch_sharding(mesh, u.shape[0])]
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _maybe_dropout(y: torch.Tensor, train: bool, rate: float,
                   generator, mesh: Optional[Mesh]) -> torch.Tensor:
    if train and rate > 0.0:
        return dropout(y, rate, generator, mesh)
    return y


def local_graph(x: torch.Tensor, mod: nn.Module, statics, *,
                train: bool = False, rate: float = 0.0,
                generator=None, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """Two-branch (mirror symmetry + kinematic connection) local module."""
    j = statics.num_joints
    a = sem_ch_graph_conv(x, mod.gcn_sym.W, mod.gcn_sym.e, statics.sym_idx, j)
    b = sem_ch_graph_conv(x, mod.gcn_con.W, mod.gcn_con.e, statics.con_idx, j)
    a = torch.relu(batch_norm(a, mod.bn_1, train=train, mesh=mesh))
    b = torch.relu(batch_norm(b, mod.bn_2, train=train, mesh=mesh))
    y = torch.matmul(torch.cat([a, b], dim=-1), pconv_weight(mod.cat_conv))
    y = torch.relu(batch_norm(y, mod.cat_bn, train=train, mesh=mesh))
    return _maybe_dropout(y, train, rate, generator, mesh)


def multi_global_graph(x: torch.Tensor, mod: nn.Module, *,
                       train: bool = False, rate: float = 0.0,
                       generator=None, mesh: Optional[Mesh] = None
                       ) -> torch.Tensor:
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
    return global_concat(outs, mod, train=train, rate=rate,
                         generator=generator, mesh=mesh)


def global_concat(heads: list, mod: nn.Module, *, train: bool = False,
                  rate: float = 0.0, generator=None,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The global branch's head outputs (head-major) -> K*G->C 1x1 conv ->
    BN -> ReLU (-> dropout in train mode)."""
    y = torch.matmul(torch.cat(heads, dim=-1), pconv_weight(mod.cat_conv))
    y = torch.relu(batch_norm(y, mod.cat_bn, train=train, mesh=mesh))
    return _maybe_dropout(y, train, rate, generator, mesh)


def graph_attention_block(x: torch.Tensor, mod: nn.Module, statics, *,
                          train: bool = False, rate: float = 0.0,
                          generator=None, mesh: Optional[Mesh] = None
                          ) -> torch.Tensor:
    """residual ++ local ++ global -> 1x1 conv (3C->2C) -> BN -> ReLU.
    In train mode the local branch's dropout mask is drawn before the
    global branch's, the JAX package's order."""
    kw = dict(train=train, rate=rate, generator=generator, mesh=mesh)
    local = local_graph(x, mod.local_graph_layer, statics, **kw)
    globl = multi_global_graph(x, mod.global_graph_layer, **kw)
    return block_concat(x, local, globl, mod, train=train, mesh=mesh)


def block_concat(x: torch.Tensor, local: torch.Tensor, globl: torch.Tensor,
                 mod: nn.Module, *, train: bool = False,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The GAB's [x, local, global] -> 1x1 conv (3C->2C) -> BN -> ReLU."""
    y = torch.matmul(torch.cat([x, local, globl], dim=-1),
                     pconv_weight(mod.cat_conv))
    return torch.relu(batch_norm(y, mod.cat_bn, train=train, mesh=mesh))
