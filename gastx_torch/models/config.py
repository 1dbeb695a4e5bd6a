"""GastNet model configuration and per-layout static graph constants.

The port's own copy of ``gastx.models.config``: the fields that fix the
architecture, the geometry derived from them, and every knob of the JAX
eval forward, with the JAX names, defaults and meanings
(``gastx_torch.models.gastnet`` has the route table):

  * ``gab_impl`` (``VALID_GAB_IMPLS``): ``"auto"`` (the level kernels on
    float32 activations, ``fused_gab`` elsewhere; narrow bf16 GABs as
    ``"pallas_pbatch"``), ``"pallas"`` (conv chains in torch, then
    ``fused_gab`` per GAB), ``"pallas_level"`` (``fused_level0`` /
    ``fused_level`` at every level they take, at any dtype),
    ``"pallas_pbatch"`` (the narrow GAB entry point at C <= 64, else as
    ``"pallas"``), ``"pallas_local"`` (the hybrid GAB) or ``"xla"`` (plain
    ops throughout). A ``_interpret`` suffix runs the same route through
    every wrapper's plain version on any device, the port's counterpart
    of interpret mode. ``gab_impl_levels`` overrides it per level (``""``
    / ``"inherit"``: ``gab_impl``), and does not combine with
    ``packed_channels``, as in JAX.
  * ``attn_impl``: ``"einsum"``, ``"batched"`` (the plain global branch
    with all heads' projections in one product) or ``"pallas_head"``
    (``head_attention`` once per head wherever the plain global branch
    runs; ``"pallas_head_interpret"`` its plain version). ``local_impl``:
    ``"einsum"`` or ``"gather"`` (the plain local branch aggregating by a
    padded-degree gather).
  * ``packed_channels``: under ``"pallas"`` and ``"auto"``, on float32
    activations, the levels whose GAB width C is at most this (from
    level 0 on; nothing when it is below ``channels``) run the GAB
    through ``fused_gab_packed`` on the (B, T, J*C) view.
  * ``gab_kernel_form`` / ``gab_kernel_form_levels``: ``"v1"`` or
    ``"fold"`` (the score-folded global branch of every kernel GAB:
    theta/phi and the rank-1 score vectors precontracted on the host).
    ``"v2"``, ``gab_apply_block=True`` and ``gab_score_block=True`` raise
    (ROADMAP queue 2 B3: forms the JAX package ships no route for).
  * ``storage_dtype`` (``"float32"``, ``"bfloat16"``, or ``"auto"``,
    which is float32 on the card as the JAX package's is off a TPU),
    ``storage_dtype_levels`` (per level) and ``gab_io_dtype`` (bf16
    only at the boundaries of the GABs that reach ``fused_gab`` on
    float32 activations): eval-only activation and weight storage; the
    kernels read and write bf16 and compute in float32.
  * Accepted and ignored: ``gab_softmax_group`` (its every value computes
    the same function bit for bit), ``gab_tile_budget`` and
    ``gab_pbatch_max_pack`` (the TPU's VMEM row budget and lane pack
    factor; the north star leaves TPU route gates out of the port).

The matmul precision tiers carry the JAX names and meanings:
``matmul_precision`` (the base tier: ``"highest"``, ``"high"`` or
``"default"``) and ``precision_overrides`` ((op_class, tier) pairs over
``OP_CLASSES``, each optionally level-qualified, ``"gab1.attn_proj"`` or
``"lvl2.temporal"``, the qualified entry winning over the bare class), with
``TPU_MIXED_PRECISION_OVERRIDES``, ``KERNEL_ONLY_TIERS`` and
``xla_precision`` copied from the JAX package. Where the port honours
them, on the card (``gastx_torch.ops.precision``):

  * the kernels' dots run at their raw tier (:meth:`GastNetConfig.tier_for`,
    the kernel-only tiers included): bf16 passes on the tensor cores in
    ``gemm_epilogue`` and in ``gab_narrow``'s tiered form, operands
    rounded in ``joint_attention``;
  * every plain site, the JAX package's XLA sites, runs at its XLA tier
    (:meth:`GastNetConfig.site_tier`: the kernel-only tiers as ``"high"``,
    ``xla_precision``): the expand conv wherever ``fused_level0`` does
    not run and the shrink (bare classes, as the JAX forward resolves
    them, ``gastx/models/gastnet.py:285, 428``), each level's conv chain
    wherever ``fused_level`` does not run (``"lvl{i}"``), and the plain
    GAB's products (``gab_impl="xla"``, the hybrid route's global branch
    and concatenations, ``_heads``' projection; ``"gab{i}"``). Their
    row-wide products launch the port's GEMM kernels; the J x J
    contractions (``local_off``, ``attn_score``, ``attn_apply``) are torch
    products of tier-rounded operands.

The train forward's plain sites take the same XLA tiers, and their
gradients too (``gastx_torch.ops.cuda.site_grad``, as JAX's transposes
carry a product's tier). Every site on the CPU computes float32, as the
JAX package's CPU path computes float32 for every tier. On bf16 operands
(bf16 storage) every tier is the same function (a bf16 value has no lo
half), so the plain sites keep their bf16 products with float32 sums.

The port's defaults differ from the JAX package's: its bare config and
``config_for_frames`` keep ``matmul_precision="highest"`` with no
overrides, where JAX's run ``"high"`` with the TPU preset, because
``ROADMAP.md`` lets a non-float32 default in only after its own 24-seed
error certificate on the card (``chip_smoke.py``); and the bare config's
``gab_impl`` is ``"auto"``, not ``"xla"``.
"""
from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

from gastx_torch.ops.precision import TIERS
from gastx_torch.skeleton import get_layout, local_adjacencies

# gab_impl values of the eval forward (the JAX package's list); inside
# gab_impl_levels, "" and "inherit" also mean "gab_impl".
VALID_GAB_IMPLS = ("xla", "auto", "pallas", "pallas_interpret",
                   "pallas_local", "pallas_local_interpret",
                   "pallas_level", "pallas_level_interpret",
                   "pallas_pbatch", "pallas_pbatch_interpret")
ATTN_IMPLS = ("einsum", "batched", "pallas_head", "pallas_head_interpret")
LOCAL_IMPLS = ("einsum", "gather")
KERNEL_FORMS = ("v1", "fold")
STORAGE_DTYPES = ("float32", "bfloat16")
_INHERIT = ("", "inherit")
_QUEUE_B3 = "ROADMAP queue 2 B3: a TPU kernel form with no shipped route"
# The two forwards of one set of weights (``GastNet.forward``'s
# ``variant``): valid dilated convs over any T >= the receptive field, or
# strided convs that compute only the frames the output needs.
VARIANTS = ("dilated", "strided")

# The op classes of precision_overrides (the JAX GastNetConfig's list).
OP_CLASSES = ("expand", "temporal", "mid1x1", "shrink", "gab_cat",
              "local_sem", "local_off", "local_cat", "attn_proj",
              "attn_score", "attn_apply", "attn_cat")
# The tiers a base matmul_precision takes (an override takes any of TIERS).
BASE_TIERS = ("default", "high", "highest")
_QUALIFIED = re.compile(r"^(?:(?:gab|lvl)\d+\.)?(\w+)$")


@dataclass(frozen=True)
class GastNetConfig:
    """Static configuration of a GastNet model.

    Shipped configs (reference reconstruction.py:220-228): 27-frame = fw
    (3,3,3) ch 128; 81-frame = (3,3,3,3) ch 64; 243-frame = (3,3,3,3,3)
    ch 32.

    ``gab_impl`` defaults to ``"auto"`` here and in ``config_for_frames``:
    the route the JAX package's ``"auto"`` takes on an f32 TPU path. The
    bare JAX config's ``"xla"`` default is deliberately not mirrored, so
    that a model runs on the kernels unless its caller asks otherwise.
    """

    num_joints_in: int = 17
    in_features: int = 2
    num_joints_out: int = 17
    filter_widths: Tuple[int, ...] = (3, 3, 3)
    channels: int = 128
    dropout: float = 0.25
    causal: bool = False
    dense: bool = False
    layout: str = "h36m17"
    gab_impl: str = "auto"
    attn_impl: str = "einsum"
    local_impl: str = "einsum"
    packed_channels: int = 0
    gab_impl_levels: Tuple[str, ...] = ()
    gab_kernel_form: str = "v1"
    gab_kernel_form_levels: Tuple[str, ...] = ()
    # Eval-only storage: "float32", "bfloat16" or "auto" (float32 here).
    storage_dtype: str = "float32"
    storage_dtype_levels: Tuple[str, ...] = ()
    gab_io_dtype: str = "float32"
    # Accepted and ignored (module docstring): the same function at every
    # value, and the TPU's VMEM budget and pack factor.
    gab_softmax_group: int = 8
    gab_tile_budget: int = 4096
    gab_pbatch_max_pack: int = 0
    # Raise when set (ROADMAP queue 2 B3).
    gab_apply_block: bool = False
    gab_score_block: bool = False
    # The base tier of every kernel dot, and (op_class, tier) overrides
    # (module docstring). The JAX default is "high"; the port's stays
    # float32 until its own cert clears another.
    matmul_precision: str = "highest"
    precision_overrides: Tuple[Tuple[str, str], ...] = ()

    def gab_impl_for(self, i: int) -> str:
        """gab_impl of level ``i``: its ``gab_impl_levels`` entry when
        set."""
        return _level_value(self.gab_impl_levels, i, self.gab_impl)

    def gab_form_for(self, i: int) -> str:
        """gab_kernel_form of level ``i``: its ``gab_kernel_form_levels``
        entry when set."""
        return _level_value(self.gab_kernel_form_levels, i,
                            self.gab_kernel_form)

    def storage_dtype_for(self, i: int, resolved: str) -> str:
        """Storage dtype of level ``i``: its ``storage_dtype_levels``
        entry when set, else ``resolved`` (``storage_dtype`` with
        ``"auto"`` already resolved)."""
        return _level_value(self.storage_dtype_levels, i, resolved)

    def level_storage(self) -> Tuple[str, ...]:
        """Each level's eval storage dtype, ``"auto"`` resolved to
        float32 (the JAX package's resolution off a TPU)."""
        sd = "float32" if self.storage_dtype == "auto" else \
            self.storage_dtype
        return tuple(self.storage_dtype_for(i, sd)
                     for i in range(self.num_levels))

    def precision_for(self, op_class: str) -> Optional[str]:
        """Override tier of an op class (bare or level-qualified, matched
        as written), or None to inherit ``matmul_precision``."""
        for name, prec in self.precision_overrides:
            if name == op_class:
                return prec
        return None

    def tier_for(self, op_class: str, tag: str) -> str:
        """The tier of ``op_class`` at the call site ``tag`` (``"gab1"``,
        ``"lvl2"``): the qualified override, else the bare class's, else
        ``matmul_precision`` (the JAX ``level_prec(tag).kernel_raw(op) or
        base``)."""
        v = self.precision_for(f"{tag}.{op_class}")
        if v is None:
            v = self.precision_for(op_class)
        return self.matmul_precision if v is None else v

    def site_tier(self, op_class: str, tag: Optional[str] = None) -> str:
        """The tier of ``op_class`` at a plain (JAX: XLA) site: the
        ``tag``-qualified override (``"gab1"``, ``"lvl2"``; none for a
        bare site), else the bare class's, mapped by
        :func:`xla_precision`, else ``matmul_precision`` (the JAX
        ``level_prec(tag)(op)`` or ``prec(op)`` under the ambient
        ``jax.default_matmul_precision``)."""
        v = None if tag is None else self.precision_for(f"{tag}.{op_class}")
        if v is None:
            v = self.precision_for(op_class)
        return self.matmul_precision if v is None else xla_precision(v)

    def __post_init__(self):
        for fw in self.filter_widths:
            if fw % 2 == 0:
                raise ValueError("Only odd filter widths are supported")
        if get_layout(self.layout).num_joints != self.num_joints_in:
            raise ValueError(
                f"layout {self.layout} has "
                f"{get_layout(self.layout).num_joints} joints, expected "
                f"{self.num_joints_in}")
        for name, value, valid in (
                ("gab_impl", self.gab_impl, VALID_GAB_IMPLS),
                ("attn_impl", self.attn_impl, ATTN_IMPLS),
                ("local_impl", self.local_impl, LOCAL_IMPLS),
                ("storage_dtype", self.storage_dtype,
                 STORAGE_DTYPES + ("auto",)),
                ("gab_io_dtype", self.gab_io_dtype, STORAGE_DTYPES)):
            if value not in valid:
                raise ValueError(f"unknown {name} {value!r}; valid: {valid}")
        if self.gab_kernel_form == "v2" or "v2" in self.gab_kernel_form_levels:
            raise ValueError(f"gab_kernel_form 'v2' is not carried "
                             f"({_QUEUE_B3})")
        if self.gab_kernel_form not in KERNEL_FORMS:
            raise ValueError(f"unknown gab_kernel_form "
                             f"{self.gab_kernel_form!r}; valid: "
                             f"{KERNEL_FORMS}")
        for name in ("gab_apply_block", "gab_score_block"):
            if getattr(self, name):
                raise ValueError(f"{name} is not carried ({_QUEUE_B3})")
        for name, levels, valid in (
                ("gab_impl_levels", self.gab_impl_levels, VALID_GAB_IMPLS),
                ("gab_kernel_form_levels", self.gab_kernel_form_levels,
                 KERNEL_FORMS),
                ("storage_dtype_levels", self.storage_dtype_levels,
                 STORAGE_DTYPES)):
            if not isinstance(levels, tuple) or len(levels) > \
                    self.num_levels:
                raise ValueError(f"{name} must be a tuple of at most "
                                 f"{self.num_levels} entries, got "
                                 f"{levels!r}")
            for v in levels:
                if v not in valid + _INHERIT:
                    raise ValueError(f"unknown {name} entry {v!r}; valid: "
                                     f"{valid + _INHERIT}")
        for name in ("packed_channels", "gab_softmax_group",
                     "gab_tile_budget", "gab_pbatch_max_pack"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(f"{name} must be an int >= 0, got {v!r}")
        if self.packed_channels and any(
                v not in _INHERIT for v in self.storage_dtype_levels):
            raise ValueError(
                "storage_dtype_levels is not supported with packed_channels")
        if self.packed_channels and any(
                v not in _INHERIT for v in self.gab_impl_levels):
            raise ValueError(
                "gab_impl_levels is not supported with packed_channels")
        if self.matmul_precision not in BASE_TIERS:
            hint = (" (a kernel-only tier: valid in precision_overrides, "
                    "not as the base)"
                    if self.matmul_precision in KERNEL_ONLY_TIERS else "")
            raise ValueError(f"unknown matmul_precision "
                             f"{self.matmul_precision!r}{hint}; valid: "
                             f"{BASE_TIERS}")
        for entry in self.precision_overrides:
            if len(entry) != 2:
                raise ValueError(f"precision_overrides entry {entry!r} is "
                                 f"not an (op_class, tier) pair")
            name, tier = entry
            match = _QUALIFIED.match(name)
            if match is None or match.group(1) not in OP_CLASSES:
                raise ValueError(f"unknown op class {name!r} in "
                                 f"precision_overrides; valid: {OP_CLASSES}"
                                 f", optionally as 'gab<i>.' or 'lvl<i>.'"
                                 f"<class>")
            if tier not in TIERS:
                raise ValueError(f"unknown precision tier {tier!r} for "
                                 f"{name!r}; valid: {TIERS}")

    def pads(self) -> Tuple[int, ...]:
        pads = [self.filter_widths[0] // 2]
        next_dilation = self.filter_widths[0]
        for fw in self.filter_widths[1:]:
            pads.append((fw - 1) * next_dilation // 2)
            next_dilation *= fw
        return tuple(pads)

    def causal_shifts(self, variant: str = "dilated") -> Tuple[int, ...]:
        """Per-level asymmetric shifts used for residual slicing.

        The dilated variant scales shifts by the running dilation; the
        strided variant works on the downsampled time axis, so its shifts
        stay unscaled.
        """
        if not self.causal:
            return tuple(0 for _ in self.filter_widths)
        shifts = [self.filter_widths[0] // 2]
        next_dilation = self.filter_widths[0]
        for fw in self.filter_widths[1:]:
            if variant == "strided":
                shifts.append(fw // 2)
            else:
                shifts.append(fw // 2 * next_dilation)
            next_dilation *= fw
        return tuple(shifts)

    def receptive_field(self) -> int:
        """Total receptive field in frames."""
        return 1 + 2 * sum(self.pads())

    def conv_width(self, i: int) -> int:
        """Taps of level ``i``'s temporal conv (i >= 1): ``fw[i]``, or
        with ``dense`` the whole span ``2*pads[i] + 1`` at dilation 1."""
        if self.dense:
            return 2 * self.pads()[i] + 1
        return self.filter_widths[i]

    def output_frames(self, frames: int, variant: str = "dilated") -> int:
        """Output frames of a ``variant`` forward over ``frames`` input
        frames; ValueError for a T that forward cannot take.

        Dilated: any T >= the receptive field, T - rf + 1 frames out.
        Strided: T >= rf and, at each level, a residual slice
        ``y[:, shift + fw//2 :: fw]`` as long as the strided conv's output
        or broadcast against a one-frame output, as the JAX package's
        residual add has it (T = n * rf always qualifies: n frames out).
        The strided variant has no dense form."""
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; the port takes "
                             f"{VARIANTS}")
        rf = self.receptive_field()
        if frames < rf:
            raise ValueError(f"{frames} frames are fewer than the "
                             f"receptive field {rf}")
        if variant == "dilated":
            return frames - rf + 1
        if self.dense:
            raise ValueError("the strided variant has no dense form")
        fw, shifts = self.filter_widths, self.causal_shifts("strided")
        t = (frames - fw[0]) // fw[0] + 1
        for i in range(1, self.num_levels):
            conv = (t - fw[i]) // fw[i] + 1
            res = len(range(shifts[i] + fw[i] // 2, t, fw[i]))
            if conv != res and conv != 1:
                raise ValueError(
                    f"{frames} frames do not stride evenly: level {i} has a "
                    f"{res}-frame residual for a {conv}-frame conv")
            t = res
        return t

    @property
    def num_levels(self) -> int:
        return len(self.filter_widths)

    def block_channels(self, i: int) -> int:
        """Channels entering graph-attention block ``i`` (2^i * channels)."""
        return (2 ** i) * self.channels

    @property
    def out_channels(self) -> int:
        return (2 ** self.num_levels) * self.channels


def _level_value(levels: Tuple[str, ...], i: int, default: str) -> str:
    v = levels[i] if i < len(levels) else ""
    return default if v in _INHERIT else v


class GraphStatics(NamedTuple):
    """Static per-layout constants consumed by the graph ops."""

    num_joints: int
    sym_idx: np.ndarray  # flat row-major nonzero indices of adj_sym
    con_idx: np.ndarray  # flat row-major nonzero indices of adj_con


@functools.lru_cache(maxsize=None)
def graph_statics(layout_name: str) -> GraphStatics:
    layout = get_layout(layout_name)
    adj_sym, adj_con = local_adjacencies(layout)
    return GraphStatics(
        num_joints=layout.num_joints,
        sym_idx=np.flatnonzero(adj_sym > 0),
        con_idx=np.flatnonzero(adj_con > 0),
    )


# Measured per-op-class mixed-precision preset of the JAX package (its
# TPU cert: 0.0577 mm worst of 24 seeds at 27f, gastx/models/config.py:
# 350-399); the port's own cert is chip_smoke.py's.
TPU_MIXED_PRECISION_OVERRIDES: Tuple[Tuple[str, str], ...] = (
    ("local_sem", "default"), ("local_off", "default"),
    ("local_cat", "default"), ("attn_score", "default"),
    ("attn_apply", "default"),
    ("temporal", "high_rhs"), ("mid1x1", "high_rhs"),
)
# The JAX package's historical name of the same preset.
TPU_MIXED_SAFE_OVERRIDES: Tuple[Tuple[str, str], ...] = \
    TPU_MIXED_PRECISION_OVERRIDES

# Tiers that exist only inside the kernels: the 2-pass pair and the
# kernel-only 1-pass tier. Valid in precision_overrides, not as the base.
KERNEL_ONLY_TIERS: Tuple[str, ...] = ("high_lhs", "high_rhs", "kdefault")


def xla_precision(tier):
    """The tier the JAX package's XLA sites take for a possibly
    kernel-only tier, and the port's plain sites with them
    (:meth:`GastNetConfig.site_tier`)."""
    return "high" if tier in KERNEL_ONLY_TIERS else tier


def config_for_frames(frames: int, num_joints: int = 17, *,
                      causal: bool = False, dropout: float = 0.05,
                      precision_overrides: Tuple[Tuple[str, str], ...] = (),
                      matmul_precision: str = "highest",
                      gab_impl: str = "auto") -> GastNetConfig:
    """The shipped receptive-field -> architecture table, with the JAX
    function's route fields.

    The tiers default to float32 (module docstring); pass
    ``matmul_precision="high", precision_overrides=
    TPU_MIXED_PRECISION_OVERRIDES`` for the JAX package's inference
    default. As in JAX: 81f and 243f store ``"auto"`` (float32 here) and
    81f keeps its C=512 tail level float32 (``storage_dtype_levels``);
    under JAX's gate (that preset exactly, and ``gab_impl == "auto"``) a
    243f model also prepends the 1-pass ``"kdefault"`` loosening of the
    three remaining 3-pass kernel classes and folds GAB 0's scores
    (``gab_kernel_form_levels=("fold",)``)."""
    if frames == 27:
        fw, ch = (3, 3, 3), 128
    elif frames == 81:
        fw, ch = (3, 3, 3, 3), 64
    elif frames == 243:
        fw, ch = (3, 3, 3, 3, 3), 32
    else:
        raise ValueError(f"No shipped config for receptive field {frames}")
    layout = {17: "h36m17", 19: "h36m19", 16: "sh16",
              15: "humaneva15"}[num_joints]
    overrides = tuple(tuple(p) for p in precision_overrides)
    form_levels: Tuple[str, ...] = ()
    if (frames == 243 and gab_impl == "auto"
            and overrides == TPU_MIXED_PRECISION_OVERRIDES):
        overrides = (("attn_proj", "kdefault"), ("attn_cat", "kdefault"),
                     ("gab_cat", "kdefault")) + overrides
        form_levels = ("fold",)
    return GastNetConfig(num_joints_in=num_joints, num_joints_out=num_joints,
                         filter_widths=fw, channels=ch, causal=causal,
                         dropout=dropout, layout=layout, gab_impl=gab_impl,
                         matmul_precision=matmul_precision,
                         precision_overrides=overrides,
                         storage_dtype=("auto" if frames in (81, 243)
                                        else "float32"),
                         storage_dtype_levels=(("", "", "", "float32")
                                               if frames == 81 else ()),
                         gab_kernel_form_levels=form_levels)
