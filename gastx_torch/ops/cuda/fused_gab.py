"""Eval-mode graph-attention block (GAB) on Hopper.

Replaces the TPU kernels ``gastx/ops/pallas/fused_gab.py``
``fused_gab_pbatch`` (C < 128, frames packed into the lanes),
``fused_gab`` (C <= 256, one VMEM-resident kernel) and
``fused_gab_split`` (C <= 512, two kernels): one wrapper,
:func:`fused_gab`, covers C <= 512 and routes by width.

**Narrow widths: one kernel.** ``gab_narrow`` (``gastx_torch/csrc``) runs
the whole block for a tile of whole frames in one launch, every
intermediate in shared memory (five C-wide column groups a row), so only
x is read and the 2C output written, and the weights (64 KB at C=32, 256
KB at C=64) stream through shared memory in slabs. ``kernels.gab_route``
sends a GAB to it where its shape rule holds and it beat the chain on the
card; every other GAB runs the chain below, whatever its width.

**Wide blocks: a chain.** The TPU kernels keep every weight resident in VMEM
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

Two more entry points replace TPU kernels of the same file:

  * :func:`fused_local_branch` (``fused_local_branch``, C <= 512, the
    ``gab_impl="pallas_local"`` hybrid): steps 1-3 of the chain alone
    (``kernels.local_chain``), its projection onto the 4C sem columns;
  * :func:`fused_gab_packed` (``fused_gab_packed``, C <= 256): the GAB on
    the packed (B, T, J*C) layout, which is a view of the (B, T, J, C)
    that :func:`fused_gab` takes. The TPU kernel packs J into the lanes
    to cut the lane padding of narrow C; Hopper has no lanes to pad, so
    the port keeps the layout at its interface and runs ``fused_gab``'s
    kernels on the view.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from gastx_torch.ops.batchnorm import fold_bn
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.global_attn import attn_columns, head_tables
from gastx_torch.ops.graph import sem_adjacency
from gastx_torch.ops.temporal import pconv_weight

MAX_CHANNELS = 512
# The TPU kernel fused_gab_packed's width limit (MAX_FUSED_CHANNELS).
PACKED_MAX_CHANNELS = 256


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


class LocalTables(NamedTuple):
    """Host-side weights of one ``LocalGraph`` (the GAB's local branch
    alone) in the kernels' layouts; the fields after ``w_sem`` are those
    of :class:`GabTables`."""

    w_sem: torch.Tensor       # (C, 4C)  W0_sym | W1_sym | W0_con | W1_con
    w_self: torch.Tensor      # (2, J, C)
    w_nbr: torch.Tensor       # (2, J, D, C)
    col: torch.Tensor         # (2, J, D) int32
    sem_scale: torch.Tensor   # (2C,)
    sem_shift: torch.Tensor
    lcat_w: torch.Tensor      # (2C, C)
    lcat_scale: torch.Tensor  # (C,)
    lcat_shift: torch.Tensor


def sem_columns(loc: nn.Module) -> list:
    """One ``LocalGraph``'s projection, unfolded: the (C, C) blocks
    W0_sym, W1_sym, W0_con, W1_con."""
    return [loc.gcn_sym.W[0], loc.gcn_sym.W[1], loc.gcn_con.W[0],
            loc.gcn_con.W[1]]


def _local_after_projection(loc: nn.Module, statics) -> dict:
    """The :class:`LocalTables` fields after ``w_sem``."""
    j = statics.num_joints
    ws_s, wn_s, col_s = local_weight_tables(loc.gcn_sym.e, statics.sym_idx, j)
    ws_c, wn_c, col_c = local_weight_tables(loc.gcn_con.e, statics.con_idx, j)
    d = max(col_s.shape[1], col_c.shape[1])
    wn_s, col_s = _pad_degree(wn_s, col_s, d)
    wn_c, col_c = _pad_degree(wn_c, col_c, d)
    col = np.stack([col_s, col_c])
    if col.min() < 0 or col.max() >= j:
        raise ValueError("neighbour table holds a joint index out of range")
    s_sym, t_sym = fold_bn(loc.bn_1)
    s_con, t_con = fold_bn(loc.bn_2)
    s_l, t_l = fold_bn(loc.cat_bn)
    return dict(
        w_self=K.as_table(torch.stack([ws_s, ws_c])),
        w_nbr=K.as_table(torch.stack([wn_s, wn_c])),
        col=torch.as_tensor(col, dtype=torch.int32,
                            device=ws_s.device).contiguous(),
        sem_scale=K.as_table(torch.cat([s_sym, s_con])),
        sem_shift=K.as_table(torch.cat([t_sym, t_con])),
        lcat_w=K.as_table(pconv_weight(loc.cat_conv)),
        lcat_scale=K.as_table(s_l), lcat_shift=K.as_table(t_l))


@torch.no_grad()
def local_tables(loc: nn.Module, statics) -> LocalTables:
    """Fold one ``LocalGraph``'s weights into :class:`LocalTables`."""
    return LocalTables(w_sem=K.as_table(torch.cat(sem_columns(loc), dim=1)),
                       **_local_after_projection(loc, statics))


@torch.no_grad()
def gab_tables(block: nn.Module, statics) -> GabTables:
    """Fold one ``GraphAttentionBlock``'s weights into :class:`GabTables`:
    one projection of both branches' columns, each branch's other tables,
    and the block concat."""
    loc, glb = block.local_graph_layer, block.global_graph_layer
    attn_cols, attn_shift = attn_columns(glb)
    shift = torch.cat([attn_shift.new_zeros(4 * loc.gcn_sym.W.shape[2]),
                       attn_shift])
    s_g, t_g = fold_bn(block.cat_bn)
    return GabTables(
        w_proj=K.as_table(torch.cat(sem_columns(loc) + attn_cols, dim=1)),
        proj_scale=K.as_table(torch.ones_like(shift)),
        proj_shift=K.as_table(shift),
        **_local_after_projection(loc, statics), **head_tables(glb),
        gcat_w=K.as_table(pconv_weight(block.cat_conv)),
        gcat_scale=K.as_table(s_g), gcat_shift=K.as_table(t_g))


def _check_x(x: torch.Tensor, t: GabTables) -> None:
    K.check_blocks(x, t.w_proj.shape[0], t.c_k.shape[1], MAX_CHANNELS,
                   "fused_gab")


def fused_gab_plain(x: torch.Tensor, t: GabTables) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_gab`."""
    _check_x(x, t)
    b, tt, j, c = x.shape
    y = K.gab_chain(x.reshape(-1, c), t, K.gemm_epilogue_plain,
                    K.sem_graph_plain, K.joint_attention_plain)
    return y.reshape(b, tt, j, 2 * c)


def _gab_kernels(x: torch.Tensor, t: GabTables) -> torch.Tensor:
    """The GAB's kernels on CUDA (B, T, J, C) activations: ``gab_narrow``
    where ``kernels.gab_route`` picks it, else the chain above."""
    b, tt, j, c = x.shape
    if K.gab_route(*K.gab_shape(t)) == "gab_narrow":
        y = K.gab_narrow(x.reshape(-1, c), t)
    else:
        y = K.gab_chain(x.reshape(-1, c), t, K.gemm_epilogue, K.sem_graph,
                        K.joint_attention)
    return y.reshape(b, tt, j, 2 * c)


def fused_gab(x: torch.Tensor, t: GabTables) -> torch.Tensor:
    """(B, T, J, C) -> (B, T, J, 2C), the eval-mode GAB, C <= 512. It runs
    ``gab_narrow`` where ``kernels.gab_route`` picks it, else the chain, and
    counts by width, under the TPU kernel each class replaces:
    ``fused_gab_pbatch`` (C < 128), ``fused_gab`` (C <= 256) or
    ``fused_gab_split``."""
    _check_x(x, t)
    if not K.use_kernel(x.device):
        return fused_gab_plain(x, t)
    c = x.shape[-1]
    entry = ("fused_gab_pbatch" if c <= K.NARROW_MAX_CHANNELS
             else "fused_gab" if c <= 256 else "fused_gab_split")
    with K.entry_point(entry):
        return _gab_kernels(x, t)


def _unpack(x: torch.Tensor, t: GabTables, num_joints: int) -> torch.Tensor:
    """The (B, T, J, C) view of packed (B, T, J*C) activations."""
    c = t.w_proj.shape[0]
    if (x.dim() != 3 or num_joints != t.c_k.shape[1]
            or x.shape[-1] != num_joints * c or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous float32 (B, T, "
                         f"{t.c_k.shape[1]}*{c}) tensor of {t.c_k.shape[1]} "
                         f"joints, got {tuple(x.shape)} {x.dtype} and "
                         f"{num_joints} joints")
    if c > PACKED_MAX_CHANNELS:
        raise ValueError(f"fused_gab_packed supports C <= "
                         f"{PACKED_MAX_CHANNELS}, got {c}")
    return x.view(x.shape[0], x.shape[1], num_joints, c)


def fused_gab_packed_plain(x: torch.Tensor, t: GabTables,
                           num_joints: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_gab_packed`."""
    y = fused_gab_plain(_unpack(x, t, num_joints), t)
    return y.view(x.shape[0], x.shape[1], -1)


def fused_gab_packed(x: torch.Tensor, t: GabTables,
                     num_joints: int) -> torch.Tensor:
    """(B, T, J*C) -> (B, T, J*2C), the eval-mode GAB on the packed
    layout, C <= 256: :func:`fused_gab`'s kernels on the (B, T, J, C)
    view, counted under ``fused_gab_packed`` alone."""
    xv = _unpack(x, t, num_joints)
    _check_x(xv, t)
    if not K.use_kernel(x.device):
        return fused_gab_packed_plain(x, t, num_joints)
    with K.entry_point("fused_gab_packed"):
        y = _gab_kernels(xv, t)
    return y.view(x.shape[0], x.shape[1], -1)


def _check_local(x: torch.Tensor, t: LocalTables) -> int:
    c = t.w_sem.shape[0]
    K.check_blocks(x, c, t.w_self.shape[1], MAX_CHANNELS,
                   "fused_local_branch")
    return c


def fused_local_branch_plain(x: torch.Tensor, t: LocalTables
                             ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_local_branch`."""
    c = _check_local(x, t)
    y = K.local_chain(x.reshape(-1, c), t, K.gemm_epilogue_plain,
                      K.sem_graph_plain)
    return y.reshape(x.shape)


def fused_local_branch(x: torch.Tensor, t: LocalTables) -> torch.Tensor:
    """(B, T, J, C) -> (B, T, J, C), the eval-mode local branch (both
    semantic graph convs, their BN/ReLU, the 2C -> C cat, BN, ReLU),
    C <= 512."""
    c = _check_local(x, t)
    if not K.use_kernel(x.device):
        return fused_local_branch_plain(x, t)
    with K.entry_point("fused_local_branch"):
        y = K.local_chain(x.reshape(-1, c), t, K.gemm_epilogue, K.sem_graph)
    return y.reshape(x.shape)
