"""Eval-mode graph-attention block (GAB) on Hopper.

Replaces the TPU kernels ``gastx/ops/pallas/fused_gab.py``
``fused_gab_pbatch`` (C < 128, frames packed into the lanes),
``fused_gab`` (C <= 256, one VMEM-resident kernel) and
``fused_gab_split`` (C <= 512, two kernels): one wrapper,
:func:`fused_gab`, covers C <= 512 and routes by width.

**C < 128: one kernel.** ``gab_narrow`` (``gastx_torch/csrc``) runs the
whole block for a tile of whole frames in one launch, every intermediate
in shared memory: at J=17 a frame's x and projection output take 18 KB
at C=32 and 35 KB at C=64, so a block holds a few frames, only x is read
and the 2C output written, and the weights (64 and 256 KB) stream through
shared memory in slabs.

**C >= 128: a chain.** The TPU kernels keep every weight resident in VMEM
and run the block per row tile. That does not carry over: at C=512 the
block's weights are about 13 MB, and a Hopper block has 227 KB of shared
memory, so a kernel per frame would re-read every weight for each of B*T
frames. Here the block is a chain over M = B*T*J rows of three CUDA
kernels (``kernels.gab_chain``):

  1. ``gemm_epilogue``: P = x @ [W0_sym|W1_sym|W0_con|W1_con|theta|phi|g]
     + bias (shift at scale 1), the seven C-wide projections in one
     launch;
  2. ``sem_graph``: relu(BN(sym)) | relu(BN(con)) from P's first 4C columns
     and the host-side masked-softmax tables;
  3. ``gemm_epilogue``: local = relu(BN([sym|con] @ W_cat_local));
  4. ``joint_attention``: the per-head scores, softmax, +C_k and apply from
     P's theta/phi/g columns, head-major;
  5. ``gemm_epilogue``: global = relu(BN(heads @ W_cat_global));
  6. ``gemm_epilogue``: out = relu(BN(x@W_a + local@W_b + global@W_c)), the
     3C->2C block concat as three pieces, never materialised.

The GEMMs and ``gab_narrow`` are bound by the float32 FMA rate, the two
graph kernels by device-memory bytes (see each source's note). All BNs
are folded on the host into scale/shift, as ``_fold_bn`` does. The plain
version, :func:`fused_gab_plain`, runs the same chain through the
kernels' plain PyTorch versions at every width; ``gastx_torch.ops.graph.
graph_attention_block`` is the unfused reference.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from gastx_torch.ops.batchnorm import fold_bn
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.graph import sem_adjacency
from gastx_torch.ops.temporal import pconv_weight


class GabTables(NamedTuple):
    """Host-side weights of one GAB in the kernels' layouts (all float32
    contiguous on the block's device, ``col`` int32)."""

    w_proj: torch.Tensor      # (C, 4C + 2KI + KG)
    proj_scale: torch.Tensor  # (4C + 2KI + KG,)  ones
    proj_shift: torch.Tensor  # (4C + 2KI + KG,)  biases, zero on the 4C sem
    w_self: torch.Tensor      # (2, J, C)         sym, con
    w_nbr: torch.Tensor       # (2, J, D, C)
    col: torch.Tensor         # (2, J, D) int32
    sem_scale: torch.Tensor   # (2C,)
    sem_shift: torch.Tensor
    lcat_w: torch.Tensor      # (2C, C)
    lcat_scale: torch.Tensor  # (C,)
    lcat_shift: torch.Tensor
    proj_t: torch.Tensor      # (K, I)
    proj_p: torch.Tensor      # (K, I)
    c_k: torch.Tensor         # (K, J, J)
    acat_w: torch.Tensor      # (KG, C)
    acat_scale: torch.Tensor  # (C,)
    acat_shift: torch.Tensor
    gcat_w: torch.Tensor      # (3C, 2C)
    gcat_scale: torch.Tensor  # (2C,)
    gcat_shift: torch.Tensor


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


def _pad_degree(w_nbr: torch.Tensor, col: np.ndarray, d: int):
    pad = d - col.shape[1]
    if pad:
        w_nbr = torch.cat([w_nbr, w_nbr.new_zeros(
            (w_nbr.shape[0], pad, w_nbr.shape[2]))], dim=1)
        col = np.concatenate([col, np.zeros((col.shape[0], pad), np.int32)],
                             axis=1)
    return w_nbr, col


@torch.no_grad()
def gab_tables(block: nn.Module, statics) -> GabTables:
    """Fold one ``GraphAttentionBlock``'s weights into :class:`GabTables`."""
    j = statics.num_joints
    loc, glb = block.local_graph_layer, block.global_graph_layer
    heads = list(glb.attentions)
    c = loc.gcn_sym.W.shape[1]

    ws_s, wn_s, col_s = local_weight_tables(loc.gcn_sym.e, statics.sym_idx, j)
    ws_c, wn_c, col_c = local_weight_tables(loc.gcn_con.e, statics.con_idx, j)
    d = max(col_s.shape[1], col_c.shape[1])
    wn_s, col_s = _pad_degree(wn_s, col_s, d)
    wn_c, col_c = _pad_degree(wn_c, col_c, d)
    col = np.stack([col_s, col_c])
    if col.min() < 0 or col.max() >= j:
        raise ValueError("neighbour table holds a joint index out of range")

    def cat_cols(name):  # head-major (C, K*width) columns and (K*width,)
        return (torch.cat([pconv_weight(getattr(h, name)) for h in heads], 1),
                torch.cat([getattr(h, name).bias for h in heads]))

    (wt, bt), (wp, bp), (wg, bg) = (cat_cols("theta"), cat_cols("phi"),
                                    cat_cols("g"))
    w_proj = torch.cat([loc.gcn_sym.W[0], loc.gcn_sym.W[1], loc.gcn_con.W[0],
                        loc.gcn_con.W[1], wt, wp, wg], dim=1)
    proj_shift = torch.cat([bt.new_zeros(4 * c), bt, bp, bg])
    proj = torch.stack([h.concat_project[0].weight.reshape(-1)
                        for h in heads])                      # (K, 2I)
    inter = wt.shape[1] // len(heads)

    s_sym, t_sym = fold_bn(loc.bn_1)
    s_con, t_con = fold_bn(loc.bn_2)
    s_l, t_l = fold_bn(loc.cat_bn)
    s_a, t_a = fold_bn(glb.cat_bn)
    s_g, t_g = fold_bn(block.cat_bn)

    def f32(t):
        return t.detach().to(torch.float32).contiguous()

    return GabTables(
        w_proj=f32(w_proj), proj_scale=f32(torch.ones_like(proj_shift)),
        proj_shift=f32(proj_shift),
        w_self=f32(torch.stack([ws_s, ws_c])),
        w_nbr=f32(torch.stack([wn_s, wn_c])),
        col=torch.as_tensor(col, dtype=torch.int32,
                            device=w_proj.device).contiguous(),
        sem_scale=f32(torch.cat([s_sym, s_con])),
        sem_shift=f32(torch.cat([t_sym, t_con])),
        lcat_w=f32(pconv_weight(loc.cat_conv)),
        lcat_scale=f32(s_l), lcat_shift=f32(t_l),
        proj_t=f32(proj[:, :inter]), proj_p=f32(proj[:, inter:]),
        c_k=f32(torch.stack([h.C_k for h in heads])),
        acat_w=f32(pconv_weight(glb.cat_conv)),
        acat_scale=f32(s_a), acat_shift=f32(t_a),
        gcat_w=f32(pconv_weight(block.cat_conv)),
        gcat_scale=f32(s_g), gcat_shift=f32(t_g))


def _check_x(x: torch.Tensor, t: GabTables) -> None:
    c = t.w_proj.shape[0]
    if (x.dim() != 4 or x.shape[-1] != c or x.shape[-2] != t.c_k.shape[1]
            or x.dtype != torch.float32 or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous float32 (B, T, "
                         f"{t.c_k.shape[1]}, {c}) tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if c > 512:
        raise ValueError(f"fused_gab supports C <= 512, got {c}")


def fused_gab_plain(x: torch.Tensor, t: GabTables) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_gab`."""
    _check_x(x, t)
    b, tt, j, c = x.shape
    y = K.gab_chain(x.reshape(-1, c), t, K.gemm_epilogue_plain,
                    K.sem_graph_plain, K.joint_attention_plain)
    return y.reshape(b, tt, j, 2 * c)


def fused_gab(x: torch.Tensor, t: GabTables) -> torch.Tensor:
    """(B, T, J, C) -> (B, T, J, 2C), the eval-mode GAB, C <= 512. C < 128
    runs ``gab_narrow`` and counts under ``fused_gab_pbatch``; wider blocks
    run the chain and count under ``fused_gab`` (C <= 256) or
    ``fused_gab_split``: the TPU kernels each replaces."""
    _check_x(x, t)
    if not K.use_kernel(x.device):
        return fused_gab_plain(x, t)
    b, tt, j, c = x.shape
    if c <= K.NARROW_MAX_CHANNELS:
        with K.entry_point("fused_gab_pbatch"):
            y = K.gab_narrow(x.reshape(-1, c), t)
    else:
        with K.entry_point("fused_gab" if c <= 256 else "fused_gab_split"):
            y = K.gab_chain(x.reshape(-1, c), t, K.gemm_epilogue,
                            K.sem_graph, K.joint_attention)
    return y.reshape(b, tt, j, 2 * c)
