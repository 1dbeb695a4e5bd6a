"""GastNet model configuration and per-layout static graph constants.

The port's own copy of ``gastx.models.config``: the fields that fix the
architecture, the geometry derived from them, and the three route knobs
of the eval forward that the port carries, with the JAX names and
meanings (``gastx_torch.models.gastnet`` has the route table):

  * ``gab_impl``: ``"auto"`` (the level kernels, then ``fused_gab`` at
    C=512), ``"pallas"`` (torch conv chains, then ``fused_gab`` per GAB),
    ``"pallas_local"`` (the hybrid GAB: ``fused_local_branch``, the global
    branch and the block concat in plain torch) or ``"xla"`` (plain ops
    throughout). The kernel or its plain version follows the tensor's
    device, so the JAX ``_interpret`` suffixes have no counterpart.
  * ``attn_impl``: ``"einsum"`` or ``"pallas_head"`` (``head_attention``
    once per head wherever the plain global branch runs).
  * ``packed_channels``: under ``"pallas"`` only, levels whose GAB width
    C is at most this run the GAB through ``fused_gab_packed`` on the
    (B, T, J*C) view. The JAX package also packs under ``"auto"`` on a
    TPU; on Hopper the packed GAB is ``fused_gab`` on a view, so that
    combination would only take levels off the level kernels, and any
    ``packed_channels`` > 0 with another ``gab_impl`` raises.

Not carried yet (ROADMAP queue 1): ``gab_impl="pallas_level"`` and
``"pallas_pbatch"``, ``attn_impl="batched"``, ``local_impl``,
``gab_impl_levels``, tile budgets, kernel forms, precision tiers and
storage dtypes. The port computes in float32.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np

from gastx_torch.skeleton import get_layout, local_adjacencies

GAB_IMPLS = ("auto", "pallas", "pallas_local", "xla")
ATTN_IMPLS = ("einsum", "pallas_head")
# The two forwards of one set of weights (``GastNet.forward``'s
# ``variant``): valid dilated convs over any T >= the receptive field, or
# strided convs that compute only the frames the output needs.
VARIANTS = ("dilated", "strided")


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
    packed_channels: int = 0

    def __post_init__(self):
        for fw in self.filter_widths:
            if fw % 2 == 0:
                raise ValueError("Only odd filter widths are supported")
        if get_layout(self.layout).num_joints != self.num_joints_in:
            raise ValueError(
                f"layout {self.layout} has "
                f"{get_layout(self.layout).num_joints} joints, expected "
                f"{self.num_joints_in}")
        if self.gab_impl not in GAB_IMPLS:
            raise ValueError(f"unknown gab_impl {self.gab_impl!r}; the port "
                             f"takes {GAB_IMPLS}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}; the "
                             f"port takes {ATTN_IMPLS}")
        if (not isinstance(self.packed_channels, int)
                or isinstance(self.packed_channels, bool)
                or self.packed_channels < 0):
            raise ValueError(f"packed_channels must be an int >= 0, got "
                             f"{self.packed_channels!r}")
        if self.packed_channels and self.gab_impl != "pallas":
            raise ValueError(f"packed_channels > 0 needs gab_impl='pallas', "
                             f"got {self.gab_impl!r}")

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


def config_for_frames(frames: int, num_joints: int = 17, *,
                      causal: bool = False,
                      dropout: float = 0.05) -> GastNetConfig:
    """The shipped receptive-field -> architecture table."""
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
    return GastNetConfig(num_joints_in=num_joints, num_joints_out=num_joints,
                         filter_widths=fw, channels=ch, causal=causal,
                         dropout=dropout, layout=layout)
