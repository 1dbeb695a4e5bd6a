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

  * :meth:`GastNet.forward` — the route the config picks, level by level,
    as the JAX package's knobs of the same names pick it
    (``gastx/models/gastnet.py:186-428``, ``gastx/ops/graph.py:380-475``).
    ``cfg.gab_impl_for(i)`` names level i's route (a ``_interpret``
    suffix: the same route through every wrapper's plain version, on any
    device); ``x`` below is the model input in level 0's storage dtype.

    ==================  ===================================================
    gate (JAX line)     levels it takes
    ==================  ===================================================
    level 0 kernel      ``fused_level0``: dilated, not dense, level 0's
    (``l0_fused``,      route ``"auto"`` or ``"pallas_level"``, no
    ``:252-262``)       ``packed_channels``, x float32, C <= 256
    packed prefix       ``fused_gab_packed`` on the (B, T, J*C) view of
    (``use_packed``,    each level from 0 while C <= ``packed_channels``
    ``:292-298``)       (>= ``channels``): dilated, x float32,
                        ``gab_impl`` ``"pallas"`` or ``"auto"``
    level kernel        ``fused_level`` at level i >= 1: dilated, not
    (``use_level_       dense, C <= 256, route ``"pallas_level"`` (any
    fuse``, ``:341-     dtype) or ``"auto"`` with x float32
    355``)
    else                the plain expand prefix or conv chain at the
                        level's dtype, then the GAB by route: ``"auto"``
                        is ``"pallas"`` on float32 activations, else
                        ``"pallas_pbatch"`` below C=128 and ``"pallas"``
                        above; ``"pallas_local"`` on bf16 is ``"xla"``;
                        ``"pallas_pbatch"`` at C <= 64 ``fused_gab`` as
                        that entry point, else as ``"pallas"``;
                        ``"pallas"``/``"pallas_level"`` ``fused_gab`` at
                        C <= 512 (``gab_io_dtype="bfloat16"`` rounds its
                        float32 input and output to bf16 there alone);
                        ``"pallas_local"`` ``fused_local_branch``, the
                        global branch and the concat in plain torch;
                        ``"xla"`` (and C > 512) the plain block
    ==================  ===================================================

    The plain global branch runs by ``attn_impl`` (``"pallas_head"``:
    ``head_attention`` once per head, its projection and cat in plain
    torch) and the plain local branch by ``local_impl``. The JAX VMEM gates
    (``fits_vmem``, ``MAX_FUSED_CHANNELS``/``MAX_SPLIT_CHANNELS`` beyond
    the GAB's 512) are not carried: the wrappers take any T. Every kernel
    GAB takes ``cfg.gab_form_for(i)`` (``"fold"``: ``gab_tables``). Inside
    every wrapper the GAB goes by shape (``fused_gab.gab_route``): one
    ``gab_narrow`` launch (float32 or tiered) at the narrow widths where
    it beat the chain, else the three-kernel chain. The final 1x1 shrink
    is a plain site. On a CPU tensor each wrapper runs its plain version.

    Storage (eval only; ``cfg.level_storage()``): a level stored bf16 runs
    on a bf16 copy of its modules (``storage_copy``, cached) and its
    activations are cast at level entry; the shrink runs at the last
    level's dtype and the output is float32. Train mode ignores storage.
  * :meth:`GastNet.reference_forward` — the unfused ops of
    ``gastx_torch.ops.graph`` (the JAX package's XLA route with the einsum
    attention) for every config, the reference every route is held to.

Precision tiers (``cfg.matmul_precision``, ``cfg.precision_overrides``):
each kernel call site takes its {op_class: tier} dict, resolved per level
as the JAX forward resolves it (``gastx/models/gastnet.py:218-235``):
``fused_level0`` the ``"lvl0"``-qualified ``expand`` in its
``"temporal"`` slot and the ``"gab0"`` classes, ``fused_level`` the
``"lvl{i}"`` conv classes and the ``"gab{i}"`` GAB classes, every other
GAB wrapper its ``"gab{i}"`` classes (``ops.precision.resolve_tiers``;
all ``"highest"`` on a CPU tensor). Each plain site takes its XLA tier
(``ops.precision.resolve_site_tiers``, as the JAX forward's ``prec`` and
``level_prec`` resolve them): the expand conv and the shrink their bare
classes, a level's conv chain its ``"lvl{i}"`` ``CHAIN_SITE_OPS``, the
plain GAB (``gab_impl="xla"``, the hybrid route's global branch and
concatenations, ``_heads``' projection) its ``"gab{i}"``
``GAB_SITE_OPS``; below ``"highest"`` their row-wide products launch the
GEMM kernels (``ops.temporal``, ``ops.graph``). The train forward
resolves the same site tiers (the JAX package trains under
``jax.default_matmul_precision`` with every site at its tier, and no
Pallas kernel: ``gastx/models/gastnet.py:89-90, 341``).
:meth:`GastNet.plain_route_forward` runs the same route and tiers
through every wrapper's plain version, the tiered forward's reference on
the card; ``reference_forward`` is float32.

Both run under ``torch.no_grad()``, in eval mode. In train mode
(``model.train()``) :meth:`GastNet.forward` runs the train forward
instead, the counterpart of ``gastnet_forward(train=True)``: the same
plain ops as ``reference_forward``, with autograd, for every route and
variant, BN on the batch statistics (the running ones updated in place)
and dropout at the JAX package's three sites (each GAB's local and
global branch, and each level's conv chain before its residual add),
its masks drawn from the ``torch.Generator`` the caller passes. It
reaches no fused kernel, as the JAX package's train gates reach no Pallas
kernel (``level_fuse_ok = not train``). Each of its plain sites takes the
tier the eval forward's plain sites take (``resolve_site_tiers``: the
expand conv and the shrink their bare classes, level i's chain
``"lvl{i}"``, GAB i ``"gab{i}"``). At ``"highest"`` (the port's default,
and every site on the CPU or on float64 weights) the products are torch's
with autograd, as they always were. Below it each row-wide product runs
through ``ops.cuda.site_grad.SiteGemm`` (forward and input gradient on
``gemm_tc``/``gemm_smallk``, weight gradient on ``gemm_wgrad``, all at
the site's tier) and each J x J contraction through
``ops.precision.TieredContraction``; ``K.SITE_PRODUCTS`` and
``K.SITE_GRADS`` count them. The data-parallel step is this forward under
DDP, so it trains at the tiers too.
"""
from __future__ import annotations

import itertools
import weakref
from typing import Optional

import torch
from torch import nn

from gastx_torch.models.config import GastNetConfig, graph_statics
from gastx_torch.models.precision import cast_module
from gastx_torch.ops.batchnorm import batch_norm
from gastx_torch.ops.cuda.fused_gab import (
    KERNEL_OPS, fused_gab, fused_gab_packed, fused_gab_packed_plain,
    fused_gab_plain, fused_local_branch, fused_local_branch_plain,
    gab_tables, local_tables)
from gastx_torch.ops.cuda.fused_level import (
    LEVEL_OPS, fused_level, fused_level0, fused_level0_plain,
    fused_level_plain, level0_tables, level_tables)
from gastx_torch.ops.cuda.global_attn import global_tables
from gastx_torch.ops.cuda.head_attn import head_attention, \
    head_attention_plain
from gastx_torch.ops.graph import (block_concat, dropout, global_concat,
                                   graph_attention_block, local_graph,
                                   multi_global_graph)
from gastx_torch.ops.precision import resolve_site_tiers, resolve_tiers
from gastx_torch.ops.temporal import (pconv_weight, pointwise,
                                      tconv_weight, temporal_conv)
from gastx_torch.parallel.mesh import Mesh

# Levels up to this width run the level wrapper; wider ones run the conv
# chain in torch and then fused_gab (see the module docstring).
LEVEL_KERNEL_MAX_CHANNELS = 256
# The widest GAB the kernel entry points take (the TPU's split form).
GAB_KERNEL_MAX_CHANNELS = 512
# The op classes of the plain GAB's sites (gastx/ops/graph.py), and of a
# level's plain conv chain (gastx/models/gastnet.py:394-404).
GAB_SITE_OPS = ("local_sem", "local_off", "local_cat", "attn_proj",
                "attn_score", "attn_apply", "attn_cat", "gab_cat")
CHAIN_SITE_OPS = ("temporal", "mid1x1")
# The bf16 storage copies of each model, by dtype: (weights token, copy).
_STORAGE_COPIES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _base(impl: str) -> str:
    """A route without its ``_interpret`` suffix."""
    return impl.removesuffix("_interpret")


def _interpret(impl: str) -> bool:
    """Whether a route runs every wrapper's plain version (the port's
    interpret mode)."""
    return impl.endswith("_interpret")


def _wrappers(plain: bool) -> dict:
    """The entry points of the kernel route, or their plain versions
    (looked up at each forward)."""
    if plain:
        return dict(level0=fused_level0_plain, level=fused_level_plain,
                    gab=fused_gab_plain, packed=fused_gab_packed_plain,
                    local=fused_local_branch_plain,
                    head=head_attention_plain)
    return dict(level0=fused_level0, level=fused_level, gab=fused_gab,
                packed=fused_gab_packed, local=fused_local_branch,
                head=head_attention)


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
    """The GAST-Net lifting model, dilated and strided: the kernel route
    in eval mode, the plain ops with autograd in train mode."""

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

    def forward(self, x: torch.Tensor, variant: str = "dilated", *,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[Mesh] = None,
                plain: bool = False) -> torch.Tensor:
        """(B, T, J, C_in) normalized 2D keypoints -> (B, T_out, J, 3)
        (``cfg.output_frames(T, variant)`` frames). In eval mode, without
        gradients, on the route ``cfg.gab_impl``, ``cfg.attn_impl`` and
        ``cfg.packed_channels`` pick for ``variant`` (the module
        docstring's table). In train mode the train forward, its dropout
        masks drawn from ``generator`` (required when ``cfg.dropout`` >
        0); under a data-parallel ``mesh`` (``gastx_torch.parallel``) on
        this rank's rows of the global batch, whose BN statistics and
        dropout masks it takes. ``plain``: every tiered product through
        its wrappers' plain versions, in either mode (the card's
        reference; in eval mode :meth:`plain_route_forward`)."""
        if self.training:
            if self.cfg.dropout > 0.0 and generator is None:
                raise ValueError("a train forward with dropout > 0 needs a "
                                 "torch.Generator (generator=...)")
            self._check_input(x, variant)
            return self._plain_forward(x, variant, train=True,
                                       generator=generator, mesh=mesh,
                                       plain=plain)
        with torch.no_grad():
            return self._kernel_forward(x, variant, plain=plain)

    @torch.no_grad()
    def plain_route_forward(self, x: torch.Tensor, variant: str = "dilated"
                            ) -> torch.Tensor:
        """The eval forward's route and tiers through every wrapper's plain
        version, on any device and in any mode: the tiered forward's
        reference on the card (on the CPU the same as the eval forward)."""
        return self._kernel_forward(x, variant, plain=True)

    def storage_copy(self, dtype: torch.dtype) -> "GastNet":
        """This model with its weights and BN statistics stored as
        ``dtype`` (bf16 storage): ``self`` where they already are, else a
        copy, made once per dtype and rebuilt when a weight changes (by
        identity or in place), which carries ``self.cfg`` as it is now (a
        config may be reassigned). ``self`` is never touched."""
        if self.shrink.weight.dtype == dtype:
            return self
        token = tuple((t.data_ptr(), t._version) for t in itertools.chain(
            self.parameters(), self.buffers()))
        cache = _STORAGE_COPIES.setdefault(self, {})
        if dtype not in cache or cache[dtype][0] != token:
            cache[dtype] = (token, cast_module(self, dtype))
        copy = cache[dtype][1]
        copy.cfg = self.cfg
        return copy

    def level_dtypes(self) -> tuple:
        """Each level's eval storage dtype (``cfg.level_storage()``); all
        bf16 for a model whose weights are bf16 (``bf16_inference_fn``)."""
        if self.shrink.weight.dtype == torch.bfloat16:
            return (torch.bfloat16,) * self.cfg.num_levels
        return tuple(torch.bfloat16 if d == "bfloat16" else torch.float32
                     for d in self.cfg.level_storage())

    def _kernel_forward(self, x: torch.Tensor, variant: str,
                        plain: bool = False) -> torch.Tensor:
        self._check_input(x, variant)
        cfg, statics = self.cfg, self.statics
        fw, pads = cfg.filter_widths, cfg.pads()
        shifts = cfg.causal_shifts(variant)
        dts = self.level_dtypes()
        mods = [self.storage_copy(d) for d in dts]
        x = x.to(dts[0]).contiguous()
        dev = x.device
        # The JAX gates (module docstring) read x's dtype: level 0's.
        x_f32 = dts[0] == torch.float32
        level_ok = variant == "dilated" and not cfg.dense
        packed = (variant == "dilated" and x_f32
                  and 0 < cfg.channels <= cfg.packed_channels
                  and _base(cfg.gab_impl) in ("pallas", "auto"))
        impl0 = cfg.gab_impl_for(0)
        if (level_ok and _base(impl0) in ("pallas_level", "auto")
                and cfg.packed_channels == 0 and x_f32
                and cfg.channels <= LEVEL_KERNEL_MAX_CHANNELS):
            m0 = mods[0]
            tiers0 = resolve_tiers(cfg, "gab0", KERNEL_OPS, dev)
            tiers0["temporal"] = resolve_tiers(cfg, "lvl0", ("expand",),
                                               dev)["expand"]
            y = _wrappers(plain or _interpret(impl0))["level0"](
                x, level0_tables(m0.init_bn, m0.expand_conv, m0.expand_bn),
                gab_tables(m0.layers_graph_conv[0], statics,
                           cfg.gab_form_for(0)), tiers0)
        else:
            y = mods[0]._gab(mods[0]._expand(
                x, variant, tier=resolve_site_tiers(cfg, None, ("expand",),
                                                    dev)["expand"],
                plain=plain), 0, variant, plain, packed)
        dilation = fw[0]
        for i in range(1, cfg.num_levels):
            m, impl, ci = mods[i], cfg.gab_impl_for(i), cfg.block_channels(i)
            y = y.to(dts[i])
            if (level_ok and ci <= LEVEL_KERNEL_MAX_CHANNELS
                    and not (packed and ci <= cfg.packed_channels)
                    and (_base(impl) == "pallas_level"
                         or (_base(impl) == "auto" and x_f32))):
                tiers = {**resolve_tiers(cfg, f"lvl{i}", LEVEL_OPS, dev),
                         **resolve_tiers(cfg, f"gab{i}", KERNEL_OPS, dev)}
                y = _wrappers(plain or _interpret(impl))["level"](
                    y, level_tables(*m.level_modules(i)),
                    gab_tables(m.layers_graph_conv[i], statics,
                               cfg.gab_form_for(i)), fw=fw[i],
                    dilation=dilation, res_off=pads[i] + shifts[i],
                    tiers=tiers)
            else:
                y = m._gab(m._conv_chain(
                    y, i, dilation, variant, tiers=resolve_site_tiers(
                        cfg, f"lvl{i}", CHAIN_SITE_OPS, dev), plain=plain),
                    i, variant, plain, packed)
            dilation *= fw[i]
        return pointwise(y, pconv_weight(mods[-1].shrink),
                         tier=resolve_site_tiers(cfg, None, ("shrink",),
                                                 dev)["shrink"],
                         plain=plain, op="shrink").to(torch.float32)

    def _gab(self, y: torch.Tensor, i: int, variant: str, plain: bool,
             packed: bool) -> torch.Tensor:
        """GAB ``i`` by its route (the module docstring's last row):
        ``fused_gab_packed`` on the (B, T, J*C) view in the packed prefix,
        ``fused_gab`` on the kernel routes, else the plain block with the
        hybrid's kernels in it; each kernel at the ``"gab{i}"`` tiers and
        ``cfg.gab_form_for(i)``, or its plain version (``plain``, or the
        route's ``_interpret`` suffix)."""
        cfg, gab, statics = self.cfg, self.layers_graph_conv[i], self.statics
        b, t, j, c = y.shape
        tiers = resolve_tiers(cfg, f"gab{i}", KERNEL_OPS, y.device)
        form = cfg.gab_form_for(i)
        if packed and c <= cfg.packed_channels:
            y = _wrappers(plain or _interpret(cfg.gab_impl))["packed"](
                y.contiguous().view(b, t, j * c),
                gab_tables(gab, statics, form), j, tiers)
            return y.view(b, t, j, 2 * c)
        impl = cfg.gab_impl_for(i)
        wrap = _wrappers(plain or _interpret(impl))
        route = _base(impl)
        if route == "auto":
            route = ("pallas" if y.dtype == torch.float32 or c >= 128
                     else "pallas_pbatch")
        if route == "pallas_local" and y.dtype != torch.float32:
            route = "xla"
        # The TPU's pack factor (frames in 128 lanes, within its 256-wide
        # fused kernel) decides whether the narrow entry point runs.
        pack = min(128 // c, 256 // c, cfg.gab_pbatch_max_pack or 128)
        if route == "pallas_pbatch" and pack > 1:
            return wrap["gab"](y.contiguous(), gab_tables(gab, statics, form),
                               tiers)
        if (route in ("pallas", "pallas_level", "pallas_pbatch")
                and c <= GAB_KERNEL_MAX_CHANNELS):
            tables = gab_tables(gab, statics, form)
            if cfg.gab_io_dtype == "bfloat16" and y.dtype == torch.float32:
                return wrap["gab"](y.to(torch.bfloat16).contiguous(), tables,
                                   tiers).to(torch.float32)
            return wrap["gab"](y.contiguous(), tables, tiers)
        loc, glb = gab.local_graph_layer, gab.global_graph_layer
        site = dict(tiers=resolve_site_tiers(cfg, f"gab{i}", GAB_SITE_OPS,
                                             y.device), plain=plain)
        if route == "pallas_local" and c <= GAB_KERNEL_MAX_CHANNELS:
            local = wrap["local"](y.contiguous(), local_tables(loc, statics),
                                  tiers)
        else:
            local = local_graph(y, loc, statics, impl=cfg.local_impl, **site)
        if _base(cfg.attn_impl) == "pallas_head":
            head = _wrappers(plain or _interpret(cfg.attn_impl))["head"]
            globl = global_concat(self._heads(y, glb, head, tiers,
                                              site["tiers"], plain),
                                  glb, **site)
        else:
            globl = multi_global_graph(y, glb, impl=cfg.attn_impl, **site)
        return block_concat(y, local, globl, gab, **site)

    @staticmethod
    def _heads(y: torch.Tensor, glb: nn.Module, head, tiers: dict,
               site_tiers: dict, plain: bool) -> list:
        """The global branch's head outputs, each head through
        ``head_attention`` (``head``: it or its plain version) at the
        ``attn_score``/``attn_apply`` tiers (``tiers``, the kernel's), on
        column views of one plain projection [theta | phi | g] (head-major
        within each) at the site's ``attn_proj`` tier (``site_tiers``), as
        the JAX package keeps the projections outside its per-head kernel.
        Under bf16 storage the projection is bf16 and the kernel reads it
        upcast and writes float32, as the JAX kernel does; the outputs go
        on in y's dtype."""
        t = global_tables(glb)
        b, tt, j, _ = y.shape
        p = pointwise(y, t.w_attn.to(y.dtype),
                      shift=t.attn_shift.to(y.dtype),
                      tier=site_tiers["attn_proj"], plain=plain,
                      op="attn_proj")
        p = p.reshape(b * tt, j, -1).to(torch.float32)
        k, inter = t.proj_t.shape
        g_ch = (p.shape[-1] - 2 * k * inter) // k
        outs = []
        for h in range(k):
            out = head(
                p[..., h * inter:(h + 1) * inter],
                p[..., (k + h) * inter:(k + h + 1) * inter],
                p[..., 2 * k * inter + h * g_ch:2 * k * inter
                  + (h + 1) * g_ch],
                t.proj_t[h].reshape(-1, 1), t.proj_p[h].reshape(-1, 1),
                t.c_k[h], score_tier=tiers["attn_score"],
                apply_tier=tiers["attn_apply"])
            outs.append(out.reshape(b, tt, j, g_ch).to(y.dtype))
        return outs

    def _expand(self, x: torch.Tensor, variant: str, train: bool = False,
                mesh: Optional[Mesh] = None, tier: str = "highest",
                plain: bool = False) -> torch.Tensor:
        """init_bn -> expand conv (strided by fw[0] in the strided
        variant) -> BN -> ReLU, the conv a plain site at ``tier`` (eval:
        BN and ReLU in its epilogue below ``"highest"``)."""
        stride = self.cfg.filter_widths[0] if variant == "strided" else 1
        y = batch_norm(x, self.init_bn, train=train, mesh=mesh)
        w = tconv_weight(self.expand_conv)
        if train:
            y = temporal_conv(y, w, stride=stride, tier=tier, plain=plain,
                              op="expand")
            return torch.relu(batch_norm(y, self.expand_bn, train=True,
                                         mesh=mesh))
        return temporal_conv(y, w, stride=stride, tier=tier,
                             bn=self.expand_bn, relu=True, plain=plain,
                             op="expand")

    def _conv_chain(self, y: torch.Tensor, i: int, dilation: int,
                    variant: str, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    mesh: Optional[Mesh] = None,
                    tiers: Optional[dict] = None,
                    plain: bool = False) -> torch.Tensor:
        """Level ``i``'s temporal conv -> BN -> ReLU -> 1x1 -> BN -> ReLU
        (-> dropout in train mode) -> + residual: dilated (at dilation 1
        and the dense width with ``dense``) with the pads' residual slice,
        or strided by fw[i] with the residual ``y[:, shift + fw//2 ::
        fw]``. The two products are plain sites at ``tiers``
        (``CHAIN_SITE_OPS``; None: ``"highest"``), in eval mode each BN and
        ReLU in its epilogue below ``"highest"``."""
        cfg = self.cfg
        conv_t, bn_t, conv_1, bn_1 = self.level_modules(i)
        fw, shift = cfg.filter_widths[i], cfg.causal_shifts(variant)[i]
        if variant == "strided":
            res = y[:, shift + fw // 2::fw]
            conv = dict(stride=fw)
        else:
            pad = cfg.pads()[i]
            res = y[:, pad + shift: y.shape[1] - pad + shift]
            conv = dict(dilation=1 if cfg.dense else dilation)
        tiers = tiers or dict.fromkeys(CHAIN_SITE_OPS, "highest")
        if train:
            z = temporal_conv(y, tconv_weight(conv_t), **conv,
                              tier=tiers["temporal"], plain=plain)
            z = torch.relu(batch_norm(z, bn_t, train=True, mesh=mesh))
            z = pointwise(z, pconv_weight(conv_1), tier=tiers["mid1x1"],
                          plain=plain)
            z = torch.relu(batch_norm(z, bn_1, train=True, mesh=mesh))
            if cfg.dropout > 0.0:
                z = dropout(z, cfg.dropout, generator, mesh)
            return res + z
        z = temporal_conv(y, tconv_weight(conv_t), **conv,
                          tier=tiers["temporal"], bn=bn_t, relu=True,
                          plain=plain)
        z = pointwise(z, pconv_weight(conv_1), tier=tiers["mid1x1"],
                      bn=bn_1, relu=True, plain=plain)
        return res + z

    @torch.no_grad()
    def reference_forward(self, x: torch.Tensor, variant: str = "dilated"
                          ) -> torch.Tensor:
        """The same function as the eval forward through the unfused plain
        ops, whatever the config's route; BN on the running statistics
        whatever the module's mode."""
        self._check_input(x, variant)
        return self._plain_forward(x, variant)

    def _plain_forward(self, x: torch.Tensor, variant: str, *,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       mesh: Optional[Mesh] = None,
                       plain: bool = False) -> torch.Tensor:
        """The plain ops level by level, in the weights' dtype (float32;
        float64 for a float64 copy of the model); with ``train``,
        batch-statistic BN and dropout, the masks drawn in the JAX
        package's order (a level's conv chain, then its GAB's local and
        global branch), and every site at its tier (module docstring;
        ``plain``: each tiered product through its wrappers' plain
        versions). Without ``train`` (``reference_forward``) every site
        computes ``"highest"``."""
        cfg, statics = self.cfg, self.statics
        gabs = self.layers_graph_conv

        def site(tag, ops):
            if not train:
                return None
            return resolve_site_tiers(cfg, tag, ops, x.device)

        def bare(op):
            return (site(None, (op,)) or {op: "highest"})[op]

        kw = dict(train=train, rate=cfg.dropout, generator=generator,
                  mesh=mesh, plain=plain)
        y = self._expand(x.to(self.shrink.weight.dtype), variant, train,
                         mesh, tier=bare("expand"), plain=plain)
        y = graph_attention_block(y, gabs[0], statics,
                                  tiers=site("gab0", GAB_SITE_OPS), **kw)
        dilation = cfg.filter_widths[0]
        for i in range(1, cfg.num_levels):
            y = graph_attention_block(
                self._conv_chain(y, i, dilation, variant, train, generator,
                                 mesh, tiers=site(f"lvl{i}", CHAIN_SITE_OPS),
                                 plain=plain),
                gabs[i], statics, tiers=site(f"gab{i}", GAB_SITE_OPS), **kw)
            dilation *= cfg.filter_widths[i]
        return pointwise(y, pconv_weight(self.shrink), tier=bare("shrink"),
                         plain=plain, op="shrink")
