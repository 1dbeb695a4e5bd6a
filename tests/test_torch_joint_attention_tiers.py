"""CPU tests of ``joint_attention``'s tiered forms: the arithmetic its
kernel's header says each tier runs, held in float64 to
``precision.tiered``'s passes exactly; the apply passes (``APPLY_PASSES``)
against the kernel source's own rule; the
instantiation each tier pair launches (``kernels.attn_instantiation``);
and the cut builds of ``scripts/torch_graph_kernels.py`` against the
source. No JAX and no card: the kernel itself is held to
``joint_attention_plain`` by the card tests (``tests/test_torch_cuda.py``)
and ``chip_smoke.py`` phase 10 (a)."""
from __future__ import annotations

import re
import sys
from pathlib import Path

import pytest
import torch

from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.precision import TIERS, split_bf16, tiered

SOURCE = (Path(K.__file__).resolve().parents[2] / "csrc"
          / "joint_attention.cu")
SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
TIERED = ("default", "high_lhs", "high_rhs", "high")
# The apply's bf16 passes a tier, as the kernel's header lists them: (half
# of the attention weights, half of g), each an mma.sync pass summing in
# float32.
APPLY_PASSES = {"default": (("hi", "hi"),),
                "high_lhs": (("hi", "hi"), ("lo", "hi")),
                "high_rhs": (("hi", "hi"), ("hi", "lo")),
                "high": (("hi", "hi"), ("lo", "hi"), ("hi", "lo"))}


def _mm64(a, b):
    return a.double() @ b.double()


def _dot64(a, b):
    return (a.double() * b.double()).sum(-1)


def _halves(a):
    """{"hi": bf16(a), "lo": bf16(a - hi)} as float64."""
    hi, lo = split_bf16(a)
    return {"hi": hi.double(), "lo": lo.double()}


def _operands(seed):
    gen = torch.Generator().manual_seed(seed)
    # attention weights (softmax + C_k, rows of J = 17 keys) and g
    w = torch.rand(6, 17, 17, generator=gen) / 17 + 0.1 * torch.randn(
        6, 17, 17, generator=gen)
    g = torch.randn(6, 17, 64, generator=gen)
    return w, g


@pytest.mark.parametrize("tier", TIERED)
def test_apply_passes_equal_tiered_passes(tier):
    """The apply's bf16 passes (``APPLY_PASSES``: the mma.sync passes of
    the kernel's header), each product exact and summed in float64,
    equal ``precision.tiered``'s passes summed in float64, exactly."""
    w, g = _operands(len(tier))
    wh, gh = _halves(w), _halves(g)
    got = sum(_mm64(wh[lhs], gh[rhs]) for lhs, rhs in APPLY_PASSES[tier])
    assert torch.equal(got, tiered(_mm64, w, g, tier))
    if tier != "default":  # a pass more than one bf16 product
        assert not torch.equal(got, _mm64(wh["hi"], gh["hi"]))


@pytest.mark.parametrize("tier", TIERED)
def test_score_terms_equal_tiered_passes(tier):
    """The score dots as the kernel's header writes them, float32 FMAs of
    rounded operands: default q1(a) q1(b), high_lhs q2(a) q1(b), high_rhs
    q1(a) q2(b), high q2(a) q1(b) + q1(a) lo(b), with q2 = q1 + lo; each
    term exact, summed in float64, equals ``tiered``'s passes of the
    score dot (theta rows by p_theta) summed in float64, exactly."""
    gen = torch.Generator().manual_seed(7 + len(tier))
    a = torch.randn(5, 17, 64, generator=gen)  # theta rows
    b = torch.randn(64, generator=gen)         # p_theta of one head
    ah, bh = _halves(a), _halves(b)
    q2a, q2b = ah["hi"] + ah["lo"], bh["hi"] + bh["lo"]
    got = {"default": lambda: _dot64(ah["hi"], bh["hi"]),
           "high_lhs": lambda: _dot64(q2a, bh["hi"]),
           "high_rhs": lambda: _dot64(ah["hi"], q2b),
           "high": lambda: _dot64(q2a, bh["hi"]) + _dot64(ah["hi"], bh["lo"]),
           }[tier]()
    assert torch.equal(got, tiered(_dot64, a, b, tier))


def test_apply_passes_follow_the_kernel_source():
    """``APPLY_PASSES`` is the kernel's rule: a lo(w) pass at the
    tiers of ``apply_lo_w`` and a lo(g) pass at those of ``apply_lo_g``
    (``joint_attention.cu``), after the hi(w) hi(g) one."""
    src = SOURCE.read_text()
    codes = dict(zip(("HIGH_LHS", "HIGH_RHS", "HIGH"),
                     ("high_lhs", "high_rhs", "high")))

    def tiers_of(fn):
        body = re.search(rf"bool {fn}\(int tier\) \{{\s*return ([^;]*);",
                         src).group(1)
        return {codes[c] for c in re.findall(r"tier == (\w+)", body)}

    for tier, passes in APPLY_PASSES.items():
        assert passes[0] == ("hi", "hi")
        assert (("lo", "hi") in passes) == (tier in tiers_of("apply_lo_w"))
        assert (("hi", "lo") in passes) == (tier in tiers_of("apply_lo_g"))
        assert len(passes) == 1 + (tier in tiers_of("apply_lo_w")) + (
            tier in tiers_of("apply_lo_g"))


ALL_TIERS = tuple(t for t in TIERS)


@pytest.mark.parametrize("apply_tier", ALL_TIERS)
@pytest.mark.parametrize("score_tier", ALL_TIERS)
def test_attn_instantiation(score_tier, apply_tier):
    """Every tier pair's instantiation: the float32 kernel at "highest" /
    "highest"; a tiered score with the float32 apply; the shipped pairs'
    own ("kdefault" is "default": one bf16 pass in a kernel); the runtime
    codes for every other pair below "highest"."""
    s = "default" if score_tier == "kdefault" else score_tier
    a = "default" if apply_tier == "kdefault" else apply_tier
    got = K.attn_instantiation(score_tier, apply_tier)
    if a == "highest":
        assert got == ("float32" if s == "highest" else "tiered score")
    elif (s, a) in K.ATTN_OWN_PAIRS:
        assert got == f"{s}/{a}"
    else:
        assert got == "runtime tiers"


def test_attn_instantiation_refuses_an_unknown_tier():
    with pytest.raises(ValueError, match="tier"):
        K.attn_instantiation("bf16", "default")


def test_own_pairs_have_their_own_instantiation_in_the_source():
    """The C picker launches an instantiation of its own for each pair of
    ``ATTN_OWN_PAIRS``, by tier codes as template arguments."""
    src = SOURCE.read_text()
    for s, a in K.ATTN_OWN_PAIRS:
        codes = [K.ATTN_TIERS.index(t) for t in (s, a)]
        names = {1: "DEFAULT", 4: "HIGH"}
        assert (f"launch<VEC, {names[codes[0]]}, {names[codes[1]]}>"
                in src)


def test_cut_builds_find_their_text():
    """Every substitution of the timing script's cut builds and variants
    (``CUTS``, ``VARIANTS``) finds its text in the source exactly once."""
    sys.path.insert(0, str(SCRIPTS))
    try:
        import torch_graph_kernels as tg
    finally:
        sys.path.remove(str(SCRIPTS))
    src = SOURCE.read_text()
    for name, subs in {**tg.CUTS, **tg.VARIANTS}.items():
        for old, _ in subs:
            assert src.count(old) == 1, (name, old)
