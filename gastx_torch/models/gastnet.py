"""GastNet in PyTorch: the module tree and the eval forwards.

The ``nn.Module`` tree follows the upstream model's ``state_dict`` key
layout (init_bn / expand_conv / expand_bn / layers_conv / layers_bn /
layers_graph_conv.{i}.{local_graph_layer, global_graph_layer, cat_conv,
cat_bn} / shrink), so an upstream ``.bin`` and the JAX package's weights
(through ``gastx_torch.io.params_from_jax``) load with
``load_state_dict``. The conv modules only hold weights: no convolution
runs through cuDNN. ``dense=True`` widens each level's temporal conv to
its whole span (``GastNetConfig.conv_width``) at dilation 1.

Both forwards take ``variant``, as the JAX ``gastnet_forward`` does, with
activations channels-last (B, T, J, C):

  * ``"dilated"`` (default): valid dilated convs over any T >= the
    receptive field rf, T - rf + 1 frames out;
  * ``"strided"``: each level's conv strides by its filter width and its
    residual is ``y[:, shift + fw//2 :: fw]`` (the upstream
    ``SpatioTemporalModelOptimized1f``), so a window of rf frames gives one
    frame. It takes the T that ``GastNetConfig.output_frames`` admits
    (T = n * rf gives n frames) and has no dense form. Causal streaming
    (``gastx_torch.infer.streaming``) runs it on one window a push.

The two forwards:

  * :meth:`GastNet.forward` — the route the config picks, as the JAX
    package's knobs of the same names pick it (``gastx/models/
    gastnet.py``, ``gastx/ops/graph.py``):

    ==============  =======================================================
    route           levels
    ==============  =======================================================
    ``"auto"``      dilated, not dense: level 0 ``fused_level0``; every
    (default)       level with C <= 256 ``fused_level``; the C=512 tail its
                    conv chain in plain torch, then ``fused_gab`` (the
                    TPU's ``fused_gab_split``). Strided or dense: the plain
                    expand prefix or conv chain, then ``fused_gab``, at
                    every level (the JAX level kernels are gated to the
                    dilated, non-dense forward)
    ``"pallas"``    every level: the plain expand prefix or conv chain,
                    then ``fused_gab``
    ``"pallas_      every level: the plain prefix or conv chain, then the
    local"``        hybrid GAB: ``fused_local_branch``, the global branch
                    (by ``attn_impl``) and the 3C->2C concat in plain torch
    ``"xla"``       the plain ops throughout, the global branch by
                    ``attn_impl``
    ==============  =======================================================

    ``attn_impl="pallas_head"`` runs each head of a plain global branch
    (``"pallas_local"``, ``"xla"``) through ``head_attention``, its
    projection and cat in plain torch. ``packed_channels`` (``"pallas"``
    only; the config rejects it elsewhere) runs every GAB of C <=
    ``packed_channels`` of the dilated forward through
    ``fused_gab_packed`` on the (B, T, J*C) view of its conv chain's
    output (the JAX package's ``_packed_prefix``, which the strided
    forward does not take; its block-diagonal convs compute the same
    function as the per-joint convs run here). Inside every wrapper the
    GAB goes by shape (``kernels.gab_route``): one ``gab_narrow`` launch at
    the narrow widths where it beat the chain, else the three-kernel
    chain. The final 1x1 shrink is ``torch.matmul``. On a CPU tensor each
    wrapper runs its plain version.
  * :meth:`GastNet.reference_forward` — the unfused ops of
    ``gastx_torch.ops.graph`` (the JAX package's XLA route with the einsum
    attention) for every config, the reference every route is held to.

Training is a later slice.
"""
from __future__ import annotations

import torch
from torch import nn

from gastx_torch.models.config import GastNetConfig, graph_statics
from gastx_torch.ops.batchnorm import batch_norm
from gastx_torch.ops.cuda.fused_gab import (fused_gab, fused_gab_packed,
                                            fused_local_branch, gab_tables,
                                            local_tables)
from gastx_torch.ops.cuda.fused_level import (fused_level, fused_level0,
                                              level0_tables, level_tables)
from gastx_torch.ops.cuda.global_attn import global_tables
from gastx_torch.ops.cuda.head_attn import head_attention
from gastx_torch.ops.graph import (block_concat, global_concat,
                                   graph_attention_block, local_graph,
                                   multi_global_graph)
from gastx_torch.ops.temporal import (pconv_weight, pointwise,
                                      tconv_weight, temporal_conv)

# Levels up to this width run the level wrapper; wider ones run the conv
# chain in torch and then fused_gab (see the module docstring).
LEVEL_KERNEL_MAX_CHANNELS = 256


class SemCHGraphConv(nn.Module):
    """Channel-wise semantic graph conv weights: W (2, Cin, Cout) self and
    neighbour matrices, e (Cout, nnz) edge logits in the flat row-major
    order of the adjacency's nonzeros."""

    def __init__(self, c_in: int, c_out: int, nnz: int):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(2, c_in, c_out))
        self.e = nn.Parameter(torch.ones(c_out, nnz))


class LocalGraph(nn.Module):
    def __init__(self, c: int, statics):
        super().__init__()
        self.gcn_sym = SemCHGraphConv(c, c, len(statics.sym_idx))
        self.gcn_con = SemCHGraphConv(c, c, len(statics.con_idx))
        self.bn_1 = nn.BatchNorm2d(c)
        self.bn_2 = nn.BatchNorm2d(c)
        self.cat_conv = nn.Conv2d(2 * c, c, 1, bias=False)
        self.cat_bn = nn.BatchNorm2d(c)


class GlobalHead(nn.Module):
    """One attention head: theta/phi/g 1x1 projections, the rank-1
    ``concat_project`` score weights and the (J, J) bias C_k."""

    def __init__(self, c: int, inter: int, g_ch: int, j: int):
        super().__init__()
        self.theta = nn.Conv1d(c, inter, 1)
        self.phi = nn.Conv1d(c, inter, 1)
        self.g = nn.Conv1d(c, g_ch, 1)
        self.concat_project = nn.Sequential(
            nn.Conv2d(2 * inter, 1, 1, bias=False))
        self.C_k = nn.Parameter(torch.zeros(j, j))


class MultiGlobalGraph(nn.Module):
    def __init__(self, c: int, inter: int, j: int):
        super().__init__()
        k = c // inter
        g_ch = c if inter == c // 2 else inter
        self.attentions = nn.ModuleList(
            GlobalHead(c, inter, g_ch, j) for _ in range(k))
        self.cat_conv = nn.Conv2d(k * g_ch, c, 1, bias=False)
        self.cat_bn = nn.BatchNorm2d(c)


class GraphAttentionBlock(nn.Module):
    def __init__(self, c: int, statics):
        super().__init__()
        self.local_graph_layer = LocalGraph(c, statics)
        self.global_graph_layer = MultiGlobalGraph(c, c // 4,
                                                   statics.num_joints)
        self.cat_conv = nn.Conv2d(3 * c, 2 * c, 1, bias=False)
        self.cat_bn = nn.BatchNorm2d(2 * c)


class GastNet(nn.Module):
    """The GAST-Net lifting model (eval mode), dilated and strided."""

    def __init__(self, cfg: GastNetConfig):
        super().__init__()
        self.cfg = cfg
        self.statics = graph_statics(cfg.layout)
        fw, c = cfg.filter_widths, cfg.channels
        self.init_bn = nn.BatchNorm2d(cfg.in_features)
        self.expand_conv = nn.Conv2d(cfg.in_features, c, (fw[0], 1),
                                     bias=False)
        self.expand_bn = nn.BatchNorm2d(c)
        convs, bns = [], []
        for i in range(1, cfg.num_levels):
            ci = cfg.block_channels(i)
            convs += [nn.Conv2d(ci, ci, (cfg.conv_width(i), 1), bias=False),
                      nn.Conv2d(ci, ci, 1, bias=False)]
            bns += [nn.BatchNorm2d(ci), nn.BatchNorm2d(ci)]
        self.layers_conv = nn.ModuleList(convs)
        self.layers_bn = nn.ModuleList(bns)
        self.layers_graph_conv = nn.ModuleList(
            GraphAttentionBlock(cfg.block_channels(i), self.statics)
            for i in range(cfg.num_levels))
        self.shrink = nn.Conv2d(cfg.out_channels, 3, 1, bias=False)

    def _check_input(self, x: torch.Tensor, variant: str) -> None:
        cfg = self.cfg
        if (x.dim() != 4 or x.shape[2] != cfg.num_joints_in
                or x.shape[3] != cfg.in_features):
            raise ValueError(
                f"expected (B, T, {cfg.num_joints_in}, {cfg.in_features}) "
                f"keypoints, got {tuple(x.shape)}")
        cfg.output_frames(x.shape[1], variant)

    def level_modules(self, i: int):
        """(temporal conv, its BN, 1x1 conv, its BN) of level i >= 1."""
        return (self.layers_conv[2 * i - 2], self.layers_bn[2 * i - 2],
                self.layers_conv[2 * i - 1], self.layers_bn[2 * i - 1])

    @torch.no_grad()
    def forward(self, x: torch.Tensor, variant: str = "dilated"
                ) -> torch.Tensor:
        """(B, T, J, C_in) normalized 2D keypoints -> (B, T_out, J, 3)
        (``cfg.output_frames(T, variant)`` frames), on the route
        ``cfg.gab_impl``, ``cfg.attn_impl`` and ``cfg.packed_channels``
        pick for ``variant`` (the module docstring's table)."""
        self._check_input(x, variant)
        cfg, statics = self.cfg, self.statics
        fw, pads = cfg.filter_widths, cfg.pads()
        shifts = cfg.causal_shifts(variant)
        gabs = self.layers_graph_conv
        x = x.to(torch.float32).contiguous()
        # The level kernels run on the dilated, non-dense forward under
        # "auto" alone, as the JAX gates (l0_fused, level_fuse_ok) have it.
        level_kernels = (cfg.gab_impl == "auto" and variant == "dilated"
                         and not cfg.dense)
        if level_kernels:
            y = fused_level0(
                x, level0_tables(self.init_bn, self.expand_conv,
                                 self.expand_bn),
                gab_tables(gabs[0], statics))
        else:
            y = self._gab(self._expand(x, variant), 0, variant)
        dilation = fw[0]
        for i in range(1, cfg.num_levels):
            if (level_kernels
                    and cfg.block_channels(i) <= LEVEL_KERNEL_MAX_CHANNELS):
                y = fused_level(y, level_tables(*self.level_modules(i)),
                                gab_tables(gabs[i], statics), fw=fw[i],
                                dilation=dilation,
                                res_off=pads[i] + shifts[i])
            else:
                y = self._gab(self._conv_chain(y, i, dilation, variant), i,
                              variant)
            dilation *= fw[i]
        return pointwise(y, pconv_weight(self.shrink))

    def _gab(self, y: torch.Tensor, i: int, variant: str) -> torch.Tensor:
        """GAB ``i`` on the route's wrapper: ``fused_gab_packed`` on the
        (B, T, J*C) view at a packed width of the dilated forward,
        ``fused_gab`` under "auto" and "pallas", else the plain block with
        the hybrid's kernels in it."""
        cfg, gab, statics = self.cfg, self.layers_graph_conv[i], self.statics
        b, t, j, c = y.shape
        if variant == "dilated" and c <= cfg.packed_channels:
            y = fused_gab_packed(y.contiguous().view(b, t, j * c),
                                 gab_tables(gab, statics), j)
            return y.view(b, t, j, 2 * c)
        if cfg.gab_impl in ("auto", "pallas"):
            return fused_gab(y.contiguous(), gab_tables(gab, statics))
        loc, glb = gab.local_graph_layer, gab.global_graph_layer
        if cfg.gab_impl == "pallas_local":
            local = fused_local_branch(y.contiguous(),
                                       local_tables(loc, statics))
        else:
            local = local_graph(y, loc, statics)
        if cfg.attn_impl == "pallas_head":
            globl = global_concat(self._heads(y, glb), glb)
        else:
            globl = multi_global_graph(y, glb)
        return block_concat(y, local, globl, gab)

    @staticmethod
    def _heads(y: torch.Tensor, glb: nn.Module) -> list:
        """The global branch's head outputs, each head through
        ``head_attention`` on column views of one plain projection
        [theta | phi | g] (head-major within each), as the JAX package
        keeps the projections outside its per-head kernel."""
        t = global_tables(glb)
        b, tt, j, _ = y.shape
        p = (pointwise(y, t.w_attn) + t.attn_shift).reshape(b * tt, j, -1)
        k, inter = t.proj_t.shape
        g_ch = (p.shape[-1] - 2 * k * inter) // k
        outs = []
        for h in range(k):
            out = head_attention(
                p[..., h * inter:(h + 1) * inter],
                p[..., (k + h) * inter:(k + h + 1) * inter],
                p[..., 2 * k * inter + h * g_ch:2 * k * inter
                  + (h + 1) * g_ch],
                t.proj_t[h].reshape(-1, 1), t.proj_p[h].reshape(-1, 1),
                t.c_k[h])
            outs.append(out.reshape(b, tt, j, g_ch))
        return outs

    def _expand(self, x: torch.Tensor, variant: str) -> torch.Tensor:
        """init_bn -> expand conv (strided by fw[0] in the strided
        variant) -> BN -> ReLU, in plain torch."""
        stride = self.cfg.filter_widths[0] if variant == "strided" else 1
        y = batch_norm(x, self.init_bn)
        y = temporal_conv(y, tconv_weight(self.expand_conv), stride=stride)
        return torch.relu(batch_norm(y, self.expand_bn))

    def _conv_chain(self, y: torch.Tensor, i: int, dilation: int,
                    variant: str) -> torch.Tensor:
        """Level ``i``'s temporal conv -> BN -> ReLU -> 1x1 -> BN -> ReLU
        -> + residual: dilated (at dilation 1 and the dense width with
        ``dense``) with the pads' residual slice, or strided by fw[i] with
        the residual ``y[:, shift + fw//2 :: fw]``."""
        cfg = self.cfg
        conv_t, bn_t, conv_1, bn_1 = self.level_modules(i)
        fw, shift = cfg.filter_widths[i], cfg.causal_shifts(variant)[i]
        if variant == "strided":
            res = y[:, shift + fw // 2::fw]
            z = temporal_conv(y, tconv_weight(conv_t), stride=fw)
        else:
            pad = cfg.pads()[i]
            res = y[:, pad + shift: y.shape[1] - pad + shift]
            z = temporal_conv(y, tconv_weight(conv_t),
                              dilation=1 if cfg.dense else dilation)
        z = torch.relu(batch_norm(z, bn_t))
        z = pointwise(z, pconv_weight(conv_1))
        z = torch.relu(batch_norm(z, bn_1))
        return res + z

    @torch.no_grad()
    def reference_forward(self, x: torch.Tensor, variant: str = "dilated"
                          ) -> torch.Tensor:
        """The same function through the unfused plain ops, whatever the
        config's route."""
        self._check_input(x, variant)
        cfg, statics = self.cfg, self.statics
        gabs = self.layers_graph_conv
        y = self._expand(x.to(torch.float32), variant)
        y = graph_attention_block(y, gabs[0], statics)
        dilation = cfg.filter_widths[0]
        for i in range(1, cfg.num_levels):
            y = graph_attention_block(
                self._conv_chain(y, i, dilation, variant), gabs[i], statics)
            dilation *= cfg.filter_widths[i]
        return pointwise(y, pconv_weight(self.shrink))
