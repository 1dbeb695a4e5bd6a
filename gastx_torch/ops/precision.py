"""Matmul precision tiers of the kernels' dots.

The port of ``gastx/ops/pallas/precision.py``: every dot inside a TPU
kernel carries a tier (``kdot`` / ``kdot_general``), and the port's
kernels compute the same arithmetic on the card. With ``a = ah + al``
(``ah = bf16(a)``, ``al = bf16(a - ah)``, :func:`split_bf16`):

  ==============  ==================================================
  tier            product
  ==============  ==================================================
  ``default``     ``ah @ bh``: one bf16 pass, f32 accumulation
  ``kdefault``    the same inside a kernel (the model's kernel-only
                  1-pass tier, ``gastx_torch.models.config``)
  ``high_lhs``    ``ah @ bh + al @ bh``: the lhs (activations) kept
                  to 16 bits, the rhs (weights) rounded to bf16
  ``high_rhs``    ``ah @ bh + ah @ bl``: the reverse
  ``high``        ``ah @ bh + ah @ bl + al @ bh``: three passes
  ``highest``     full float32
  ==============  ==================================================

Where the tiers apply: on the card, in the tensor-core ``gemm_epilogue``
instantiations, ``gab_narrow``'s tiered form and ``joint_attention``'s
rounded operands (``gastx_torch/csrc``) at each kernel site's raw tier
(:func:`resolve_tiers`), and at the plain sites, the JAX package's XLA
sites, at their XLA tier (:func:`resolve_site_tiers`; their row-wide
products on the GEMM kernels, their J x J contractions by :func:`tiered`).
On the CPU the model runs every tier in float32, as the JAX package's CPU
path does: its interpret-mode kernels skip the emulation
(``gastx/ops/pallas/precision.py:30-33``, "interpret mode runs f32 on CPU
where XLA's tiers are all exact anyway") and XLA's CPU tiers are float32,
so both resolvers give ``"highest"`` for every class on a CPU tensor. :func:`tiered_mm` is
the plain version of a tiered dot on any device: f32 matmuls of
bf16-valued f32 tensors, under ``check_f32_matmul`` so that no TF32
enters.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

from gastx_torch.device import check_f32_matmul

# Every tier a kernel's dot takes; anything else is a config typo.
TIERS = ("default", "kdefault", "high_lhs", "high_rhs", "high", "highest")


def check_tier(tier: str) -> None:
    if tier not in TIERS:
        raise ValueError(f"unknown kernel precision tier {tier!r}; valid: "
                         f"{TIERS}")


def split_bf16(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bfloat16 halves of a float32 tensor: ``hi = bf16(a)`` and
    ``lo = bf16(a - hi)``, both rounded to nearest even (``astype``)."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.to(a.dtype)).to(torch.bfloat16)
    return hi, lo


def tiers_from_pairs(precs: Iterable[Tuple[str, str]], ops: Iterable[str],
                     base: str) -> Dict[str, str]:
    """((op, tier), ...) pairs -> a complete {op: tier} dict; ops missing
    from ``precs`` take ``base`` (the JAX function takes the ambient
    ``jax.default_matmul_precision``)."""
    tiers = {op: base for op in ops}
    tiers.update(dict(precs))
    for tier in tiers.values():
        check_tier(tier)
    return tiers


def tiered(fn: Callable, a: torch.Tensor, b: torch.Tensor,
           tier: str) -> torch.Tensor:
    """The bilinear ``fn(a, b)`` (a matmul, a dot over the last axis) at
    ``tier``: ``kdot``'s non-interpret arithmetic, each pass an f32
    ``fn`` of bf16-valued float32 operands."""
    check_tier(tier)
    check_f32_matmul(a)
    if tier == "highest":
        return fn(a, b)
    ah, al = (t.to(a.dtype) for t in split_bf16(a))
    bh, bl = (t.to(b.dtype) for t in split_bf16(b))
    if tier == "high_lhs":
        return fn(ah, bh) + fn(al, bh)
    if tier == "high_rhs":
        return fn(ah, bh) + fn(ah, bl)
    if tier == "high":
        return fn(ah, bh) + fn(ah, bl) + fn(al, bh)
    return fn(ah, bh)


def tiered_mm(a: torch.Tensor, b: torch.Tensor, tier: str) -> torch.Tensor:
    """``a @ b`` at ``tier`` (see :func:`tiered`)."""
    return tiered(torch.matmul, a, b, tier)


class TieredContraction(torch.autograd.Function):
    """The bilinear ``fn(a, b)`` at ``tier`` with its gradients at the same
    tier: a plain site's J x J contraction in the train step (``ops.graph``'s
    ``local_off``, ``attn_score``, ``attn_apply``).

    JAX's transpose rules carry a dot's precision to both transposed
    products (``jax/_src/lax/lax.py``, ``_dot_general_transpose_lhs`` /
    ``_rhs``), so the TPU computes ``da`` and ``db`` at the forward's tier.
    Autograd through :func:`tiered` cannot: the lo halves' rounding has no
    gradient, and the cotangent would never be split. The backward here
    runs ``fn``'s two vjp maps ``vjps = (vjp_a, vjp_b)``, ``vjp_a(g, b)``
    the gradient with respect to ``a`` and ``vjp_b(a, g)`` with respect to
    ``b``, each bilinear, by :func:`tiered` on tier-rounded operands, the
    cotangent split too: ``da = tiered(vjp_a, g, b)``, ``db =
    tiered(vjp_b, a, g)``. ``hook(which, tier, t)``, if given, is called
    for each (``"da"``, ``"db"``) that is computed."""

    @staticmethod
    def forward(ctx, fn, vjps, a, b, tier, hook=None):
        ctx.vjps, ctx.tier, ctx.hook = vjps, tier, hook
        ctx.save_for_backward(a, b)
        return tiered(fn, a, b, tier)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        (vjp_a, vjp_b), tier = ctx.vjps, ctx.tier
        da = db = None
        if ctx.needs_input_grad[2]:
            da = tiered(vjp_a, g, b, tier)
            if ctx.hook is not None:
                ctx.hook("da", tier, g)
        if ctx.needs_input_grad[3]:
            db = tiered(vjp_b, a, g, tier)
            if ctx.hook is not None:
                ctx.hook("db", tier, g)
        return None, None, da, db, None, None


def resolve_tiers(cfg, tag: str, ops: Iterable[str],
                  device: torch.device) -> Dict[str, str]:
    """The {op_class: tier} dict of one kernel call site: ``cfg.tier_for
    (op, tag)`` on a CUDA tensor (the level-qualified override, the bare
    class's, else ``matmul_precision``), ``"highest"`` for every class on
    a CPU one (module docstring)."""
    if device.type != "cuda":
        return {op: "highest" for op in ops}
    return {op: cfg.tier_for(op, tag) for op in ops}


def resolve_site_tiers(cfg, tag, ops: Iterable[str],
                       device: torch.device) -> Dict[str, str]:
    """The {op_class: tier} dict of one plain site: ``cfg.site_tier(op,
    tag)`` on a CUDA tensor (the XLA tier: ``tag`` qualified, or bare with
    ``tag`` None), ``"highest"`` for every class on a CPU one, as
    :func:`resolve_tiers`."""
    if device.type != "cuda":
        return {op: "highest" for op in ops}
    return {op: cfg.site_tier(op, tag) for op in ops}
