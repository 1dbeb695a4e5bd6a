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

The eval forward's plain GAB (``gab_impl="xla"``, the hybrid route's
global branch and concatenations) passes ``tiers``, the {op_class: tier}
of its plain sites (``models.gastnet.GAB_SITE_OPS``; the JAX package's
``prec(op)`` at ``gastx/ops/graph.py:105-106, 129, 166, 228-234, 260,
274-275, 290, 302, 305, 471``). Below ``"highest"`` on float32 operands
the row-wide products (``local_sem``, ``local_cat``, ``attn_proj``,
``attn_cat``, ``gab_cat``) launch ``kernels.gemm_epilogue`` at their tier,
the BN and ReLU after each in its epilogue (``plain``: the plain version),
and the J x J contractions (``local_off``, ``attn_score``,
``attn_apply``) are torch products of tier-rounded operands
(``precision.tiered``), as XLA's are einsums. The train forward passes
its ``tiers`` too (``train=True``, as the JAX package trains under its
tiers): there the row-wide products run through
``ops.cuda.site_grad.SiteGemm`` (forward and both gradients on the GEMM
kernels at the tier, BN on the batch statistics and dropout in torch
after) and the J x J contractions through
``precision.TieredContraction`` (both gradients at the tier). Without
``tiers`` (``reference_forward``), at ``"highest"`` (every site on the
CPU) and on bf16 operands every product is the torch one it always was.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gastx_torch.device import check_f32_matmul
from gastx_torch.ops.batchnorm import batch_norm, fold_bn
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.site_grad import grad_needed, site_product
from gastx_torch.ops.precision import TieredContraction, tiered
from gastx_torch.parallel.mesh import Mesh, batch_sharding
from gastx_torch.ops.temporal import pconv_weight

MASK_FILL = -9e15
Tiers = Optional[Dict[str, str]]


def _tier(tiers: Tiers, op: str, x: torch.Tensor) -> str:
    """The tier a product of class ``op`` on operand ``x`` computes:
    ``"highest"`` without ``tiers`` and on bf16 (every tier the same
    function there), else its entry, counted in ``K.SITE_PRODUCTS`` at
    ``"highest"`` (the caller's torch product) or at the J x J classes'
    rounded torch products (a GEMM launch counts in ``K.site_gemm``)."""
    tier = "highest" if tiers is None or x.dtype != torch.float32 \
        else tiers[op]
    if tier == "highest" or op in ("local_off", "attn_score", "attn_apply"):
        K.count_site(op, tier, x)
    return tier


def _jj(op: str, tiers: Tiers, fn, a: torch.Tensor, b: torch.Tensor
        ) -> torch.Tensor:
    """The J x J contraction ``fn(a, b)`` of class ``op`` at its tier:
    ``fn`` itself at ``"highest"``, else a torch product of the
    tier-rounded operands (``precision.tiered``); where autograd records
    it, through ``precision.TieredContraction`` (its gradients at the
    tier, each counted in ``K.SITE_GRADS``)."""
    tier = _tier(tiers, op, a)
    if tier == "highest" or not grad_needed(a, b):
        return tiered(fn, a, b, tier)
    return TieredContraction.apply(
        fn, JJ_VJPS[op], a, b, tier,
        lambda which, t, g: K.count_site_grad(op, f"{which} {t}", g))


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def _bn_gemm(op, pieces, bn, tier, plain) -> torch.Tensor:
    """``relu(BN(sum_p a_p @ w_p))`` of a plain site below ``"highest"``,
    one GEMM launch with the BN and ReLU in its epilogue."""
    scale, shift = fold_bn(bn)
    return K.site_gemm(op, pieces, pieces[0][0].shape[0], tier, plain,
                       scale=scale, shift=shift, relu=True)


def sem_adjacency(e: torch.Tensor, mask_idx: np.ndarray, j: int
                  ) -> torch.Tensor:
    """Per-channel (C, J, J) row-softmaxed adjacency from edge logits ``e``
    (C, nnz); ``mask_idx`` is the flat row-major order of the nonzeros."""
    c_out = e.shape[0]
    logits = torch.full((c_out, j * j), MASK_FILL, dtype=e.dtype,
                        device=e.device)
    logits[:, torch.as_tensor(mask_idx, device=e.device)] = e
    return torch.softmax(logits.reshape(c_out, j, j), dim=2)


@functools.lru_cache(maxsize=None)
def local_gather_tables(mask_idx: Tuple[int, ...], j: int):
    """Padded-degree neighbour tables of a (J, J) adjacency from the flat
    row-major indices of its nonzeros: (J, D) ``col`` (neighbour joint),
    ``valid`` and ``is_diag`` masks, D the largest row degree."""
    idx = np.asarray(mask_idx, np.int64)
    rows, cols = idx // j, idx % j
    per_row = [np.flatnonzero(rows == r) for r in range(j)]
    d = max(len(p) for p in per_row)
    col = np.zeros((j, d), np.int32)
    valid = np.zeros((j, d), bool)
    for r, p in enumerate(per_row):
        col[r, : len(p)] = cols[p]
        valid[r, : len(p)] = True
    is_diag = valid & (col == np.arange(j)[:, None])
    return col, valid, is_diag


def local_weight_tables(e: torch.Tensor, mask_idx, j: int):
    """Softmax edge weights -> (J, C) self and (J, D, C) neighbour tables.

    Equivalent to the masked softmax of ``sem_ch_graph_conv``: each row
    softmaxes over the -9e15-filled logits; the diagonal goes to
    ``w_self``, the other nonzeros to ``w_nbr`` (zero-padded to the row
    degree D). Returns (w_self, w_nbr, col (J, D) numpy int32).
    """
    adj = sem_adjacency(e, np.asarray(mask_idx), j)           # (C, J, J)
    col, valid, is_diag = local_gather_tables(
        tuple(int(i) for i in np.asarray(mask_idx)), j)
    w_self = torch.diagonal(adj, dim1=1, dim2=2).t()           # (J, C)
    adj_t = adj.permute(1, 2, 0)                               # (J, J, C)
    w_nbr = adj_t[torch.arange(j, device=e.device)[:, None],
                  torch.as_tensor(col, device=e.device).long()]  # (J, D, C)
    keep = torch.as_tensor(valid & ~is_diag, device=e.device)
    w_nbr = torch.where(keep[..., None], w_nbr, torch.zeros_like(w_nbr))
    return w_self, w_nbr, col


def _aggregate(off: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
    return torch.einsum("cjk,btkc->btjc", off, h1)


# The vjp maps of each J x J class's contraction, (d/da (g, b), d/db (a,
# g)), which ``precision.TieredContraction`` runs at the tier: the local
# branch's aggregation (off (C, J, K), h1 (B, T, K, C)), a head's score
# (theta (..., J, I) by a vector (I,)) and its attention applied to g
# ((..., J, J) by (..., J, G)).
JJ_VJPS = {
    "local_off": (lambda g, h1: torch.einsum("btjc,btkc->cjk", g, h1),
                  lambda off, g: torch.einsum("cjk,btjc->btkc", off, g)),
    "attn_score": (lambda g, v: g[..., None] * v,
                   lambda theta, g: torch.tensordot(
                       g, theta, dims=(list(range(g.dim())),
                                       list(range(g.dim()))))),
    "attn_apply": (lambda g, gm: torch.matmul(g, gm.transpose(-1, -2)),
                   lambda attn, g: torch.matmul(attn.transpose(-1, -2), g)),
}


def sem_ch_graph_conv(x: torch.Tensor, w: torch.Tensor, e: torch.Tensor,
                      mask_idx: np.ndarray, j: int,
                      impl: str = "einsum", tiers: Tiers = None,
                      plain: bool = False) -> torch.Tensor:
    """``x`` (B, T, J, Cin); ``w`` (2, Cin, Cout) self/neighbour weights;
    ``e`` (Cout, nnz) edge logits. ``impl="einsum"`` aggregates with the
    channel-batched (C, J, J) adjacency, ``"gather"`` with the
    padded-degree neighbour tables of :func:`local_weight_tables` (the
    JAX ``local_impl``s; the same function). ``tiers``: ``local_sem``
    (both products, one GEMM launch below ``"highest"``) and
    ``local_off`` (the einsum's aggregation)."""
    check_f32_matmul(x)
    tier = _tier(tiers, "local_sem", x)
    if tier == "highest":
        h0 = torch.matmul(x, w[0])
        h1 = torch.matmul(x, w[1])
    else:
        c_out = w.shape[2]
        h = site_product("local_sem", [x], torch.cat([w[0], w[1]], dim=1),
                         tier, plain)
        h0, h1 = h[..., :c_out], h[..., c_out:]
    if impl == "gather":
        w_self, w_nbr, col = local_weight_tables(e, mask_idx, j)
        nbr = h1[..., torch.as_tensor(col, device=x.device).long(), :]
        return h0 * w_self + (nbr * w_nbr).sum(dim=-2)
    adj = sem_adjacency(e, mask_idx, j)
    diag = torch.diagonal(adj, dim1=1, dim2=2)                # (C, J)
    off = adj * (1.0 - torch.eye(j, dtype=x.dtype, device=x.device))
    return h0 * diag.t() + _jj("local_off", tiers, _aggregate, off, h1)


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
                generator=None, mesh: Optional[Mesh] = None,
                impl: str = "einsum", tiers: Tiers = None,
                plain: bool = False) -> torch.Tensor:
    """Two-branch (mirror symmetry + kinematic connection) local module,
    each branch's aggregation by ``impl`` (:func:`sem_ch_graph_conv`);
    ``tiers`` also gives ``local_cat``'s."""
    j = statics.num_joints
    a = sem_ch_graph_conv(x, mod.gcn_sym.W, mod.gcn_sym.e, statics.sym_idx, j,
                          impl, tiers, plain)
    b = sem_ch_graph_conv(x, mod.gcn_con.W, mod.gcn_con.e, statics.con_idx, j,
                          impl, tiers, plain)
    a = torch.relu(batch_norm(a, mod.bn_1, train=train, mesh=mesh))
    b = torch.relu(batch_norm(b, mod.bn_2, train=train, mesh=mesh))
    tier = _tier(tiers, "local_cat", x)
    if tier != "highest" and not train:
        w = pconv_weight(mod.cat_conv).contiguous()
        c = a.shape[-1]
        y = _bn_gemm("local_cat", [(_rows(a), w[:c], 0),
                                   (_rows(b), w[c:], 0)], mod.cat_bn, tier,
                     plain)
        return y.reshape(*x.shape[:-1], -1)
    y = _cat_product("local_cat", [a, b], pconv_weight(mod.cat_conv), tier,
                     plain)
    y = torch.relu(batch_norm(y, mod.cat_bn, train=train, mesh=mesh))
    return _maybe_dropout(y, train, rate, generator, mesh)


def _cat_product(op: str, xs: list, w: torch.Tensor, tier: str,
                 plain: bool) -> torch.Tensor:
    """``cat(xs, -1) @ w``: the torch product at ``"highest"``, else (the
    train step) ``site_grad.site_product`` at ``tier``."""
    if tier == "highest":
        return torch.matmul(xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1),
                            w)
    return site_product(op, xs, w, tier, plain)


def _head(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor,
          head: nn.Module, tiers: Tiers = None) -> torch.Tensor:
    """One head's rank-1 scores, LeakyReLU, softmax, +C_k, applied to g;
    the score and apply products at ``tiers``' ``attn_score`` and
    ``attn_apply`` (torch products of rounded operands)."""
    proj = head.concat_project[0].weight.reshape(-1)           # (2I,)
    inter = theta.shape[-1]
    sa = _jj("attn_score", tiers, torch.matmul, theta, proj[:inter])
    sb = _jj("attn_score", tiers, torch.matmul, phi, proj[inter:])
    f = F.leaky_relu(sa[..., :, None] + sb[..., None, :], 0.2)
    attn = torch.softmax(f, dim=-1) + head.C_k
    return _jj("attn_apply", tiers, torch.matmul, attn, g)     # (B, T, J, G)


def multi_global_graph(x: torch.Tensor, mod: nn.Module, *,
                       train: bool = False, rate: float = 0.0,
                       generator=None, mesh: Optional[Mesh] = None,
                       impl: str = "einsum", tiers: Tiers = None,
                       plain: bool = False) -> torch.Tensor:
    """Multi-head attention over joints; head outputs concatenate
    head-major as in the reference's torch.cat. ``impl="einsum"``
    projects one head at a time; ``"batched"`` (the JAX ``attn_impl``
    that unrolls the heads over flat projections) projects every head's
    theta, phi and g in one product, then runs each head on its column
    slices. The same function. Below ``"highest"`` (``tiers``' ``attn_
    proj``) every impl projects in one GEMM launch, the biases in its
    epilogue; ``tiers`` also gives each head's and the cat's."""
    check_f32_matmul(x)
    heads = list(mod.attentions)
    names = ("theta", "phi", "g")
    k, inter = len(heads), heads[0].theta.out_channels
    g_ch = heads[0].g.out_channels
    tier = _tier(tiers, "attn_proj", x)
    if impl == "batched" or tier != "highest":
        w = torch.cat([pconv_weight(getattr(h, n)) for n in names
                       for h in heads], dim=1)
        bias = torch.cat([getattr(h, n).bias for n in names for h in heads])
        if tier == "highest":
            p = torch.matmul(x, w) + bias
        elif train:
            p = site_product("attn_proj", [x], w, tier, plain) + bias
        else:
            p = K.site_gemm("attn_proj", [(_rows(x), w, 0)],
                            x.numel() // x.shape[-1], tier, plain,
                            scale=torch.ones_like(bias), shift=bias)
            p = p.reshape(*x.shape[:-1], -1)
        outs = [_head(p[..., h * inter:(h + 1) * inter],
                      p[..., (k + h) * inter:(k + h + 1) * inter],
                      p[..., 2 * k * inter + h * g_ch:
                        2 * k * inter + (h + 1) * g_ch], head, tiers)
                for h, head in enumerate(heads)]
    else:
        outs = [_head(torch.matmul(x, pconv_weight(h.theta)) + h.theta.bias,
                      torch.matmul(x, pconv_weight(h.phi)) + h.phi.bias,
                      torch.matmul(x, pconv_weight(h.g)) + h.g.bias, h,
                      tiers)
                for h in heads]
    return global_concat(outs, mod, train=train, rate=rate,
                         generator=generator, mesh=mesh, tiers=tiers,
                         plain=plain)


def global_concat(heads: list, mod: nn.Module, *, train: bool = False,
                  rate: float = 0.0, generator=None,
                  mesh: Optional[Mesh] = None, tiers: Tiers = None,
                  plain: bool = False) -> torch.Tensor:
    """The global branch's head outputs (head-major) -> K*G->C 1x1 conv ->
    BN -> ReLU (-> dropout in train mode); the conv at ``tiers``'
    ``attn_cat``."""
    tier = _tier(tiers, "attn_cat", heads[0])
    if tier != "highest" and not train:
        y = _bn_gemm("attn_cat", [(_rows(torch.cat(heads, dim=-1)),
                                   pconv_weight(mod.cat_conv).contiguous(),
                                   0)], mod.cat_bn, tier, plain)
        return y.reshape(*heads[0].shape[:-1], -1)
    y = _cat_product("attn_cat", [torch.cat(heads, dim=-1)],
                     pconv_weight(mod.cat_conv), tier, plain)
    y = torch.relu(batch_norm(y, mod.cat_bn, train=train, mesh=mesh))
    return _maybe_dropout(y, train, rate, generator, mesh)


def graph_attention_block(x: torch.Tensor, mod: nn.Module, statics, *,
                          train: bool = False, rate: float = 0.0,
                          generator=None, mesh: Optional[Mesh] = None,
                          tiers: Tiers = None, plain: bool = False
                          ) -> torch.Tensor:
    """residual ++ local ++ global -> 1x1 conv (3C->2C) -> BN -> ReLU,
    each product at ``tiers``' (the train forward's site tiers).
    In train mode the local branch's dropout mask is drawn before the
    global branch's, the JAX package's order."""
    kw = dict(train=train, rate=rate, generator=generator, mesh=mesh,
              tiers=tiers, plain=plain)
    local = local_graph(x, mod.local_graph_layer, statics, **kw)
    globl = multi_global_graph(x, mod.global_graph_layer, **kw)
    return block_concat(x, local, globl, mod, train=train, mesh=mesh,
                        tiers=tiers, plain=plain)


def block_concat(x: torch.Tensor, local: torch.Tensor, globl: torch.Tensor,
                 mod: nn.Module, *, train: bool = False,
                 mesh: Optional[Mesh] = None, tiers: Tiers = None,
                 plain: bool = False) -> torch.Tensor:
    """The GAB's [x, local, global] -> 1x1 conv (3C->2C) -> BN -> ReLU;
    the conv at ``tiers``' ``gab_cat`` (below ``"highest"`` three pieces
    of one GEMM launch, the concatenation never made)."""
    tier = _tier(tiers, "gab_cat", x)
    if tier != "highest" and not train:
        w = pconv_weight(mod.cat_conv).contiguous()
        c = x.shape[-1]
        y = _bn_gemm("gab_cat", [(_rows(x), w[:c], 0),
                                 (_rows(local), w[c:2 * c], 0),
                                 (_rows(globl), w[2 * c:], 0)], mod.cat_bn,
                     tier, plain)
        return y.reshape(*x.shape[:-1], -1)
    y = _cat_product("gab_cat", [x, local, globl],
                     pconv_weight(mod.cat_conv), tier, plain)
    return torch.relu(batch_norm(y, mod.cat_bn, train=train, mesh=mesh))
