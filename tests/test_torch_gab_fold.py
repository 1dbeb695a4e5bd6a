"""``gab_narrow``'s fold form on the CPU: the tables of
``gab_tables(..., "fold")`` (the score dots folded into the projection, as
the JAX package's ``fused_gab_pbatch(form="fold")`` folds them), the score
arithmetic of the fold kernels at every tier, the routes and the shape
rule. On the CPU ``gab_narrow`` runs its plain version, the chain of the
kernels' plain versions; ``tests/test_torch_cuda.py`` holds the fold
kernels to it on the card.

Tolerances: the block against the JAX kernel at atol 2e-5 / rtol 1e-4
(both float32; only the order of the sums differs); the score columns
against ``kdot`` within 1e-5 of the largest reference value (both sides
multiply bf16-valued operands exactly and sum in float32, in another
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models as jm
from gastx.ops.pallas.fused_gab import fused_gab_pbatch as j_fused_gab_pbatch
from gastx.ops.pallas.precision import kdot
import gastx_torch.models as tm
from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES as PRESET
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.fused_gab import (KERNEL_OPS, fused_gab, gab_route,
                                            gab_tables)
from test_torch_common import assert_close, inputs, port_model, \
    random_jax_tree

# The 243-frame model's widths: GAB 0 at C = 32, K = 4 heads, J = 17.
NARROW_CFG = jm.GastNetConfig(filter_widths=(3, 3, 3, 3, 3), channels=32,
                              dropout=0.0)
SCORE_TIERS = ("highest", "default", "kdefault", "high_lhs", "high_rhs",
               "high")
# The rounding of a score tier's lhs (x) and rhs (the folded column) in
# its first term: 0 exact, 1 bf16, 2 bf16 plus the bf16 of the rest
# (gab_narrow.cu lhs_mode / rhs_mode); "high" adds bf16(x) * lo(w).
LHS_MODE = {"highest": 0, "default": 1, "kdefault": 1, "high_lhs": 2,
            "high_rhs": 1, "high": 2}
RHS_MODE = {"highest": 0, "default": 1, "kdefault": 1, "high_lhs": 1,
            "high_rhs": 2, "high": 1}


@pytest.fixture(scope="module")
def narrow():
    params, state = random_jax_tree(NARROW_CFG, seed=31)
    return params, state, port_model(NARROW_CFG, params, state)


def _idx(cfg):
    s = jm.graph_statics(cfg.layout)
    return tuple(int(i) for i in s.sym_idx), tuple(int(i) for i in s.con_idx)


def test_fold_gab_matches_jax_pbatch_fold(narrow):
    """``gab_narrow`` (its plain version here) and ``fused_gab`` on the fold
    tables of GAB 0 against the frame-packed TPU kernel's fold form; 15
    frames, not a multiple of the pack."""
    params, state, model = narrow
    x = inputs((3, 5, 17, 32), 32)
    want = j_fused_gab_pbatch(jnp.asarray(x), params["gabs"][0],
                              state["gabs"][0], *_idx(NARROW_CFG), pack=4,
                              interpret=True, form="fold")
    t = gab_tables(model.layers_graph_conv[0], model.statics, "fold")
    assert t.form == "fold" and K.gab_shape(t) == (32, 4, 1, 8, 17,
                                                   t.col.shape[2])
    xt = torch.from_numpy(x)
    assert_close(K.gab_narrow_plain(xt.reshape(-1, 32), t),
                 np.asarray(want).reshape(-1, 64))
    assert_close(K.gab_narrow(xt.reshape(-1, 32), t),
                 np.asarray(want).reshape(-1, 64))
    assert_close(fused_gab(xt, t), want)


def _q1(v):
    return v.to(torch.bfloat16).float()


def _rnd(v, mode):
    if mode == 0:
        return v
    h = _q1(v)
    return h if mode == 1 else h + _q1(v - h)


def _fold_scores_emulated(x, t, tier):
    """The fold kernels' score arithmetic (gab_narrow.cu ``attention`` and
    ``attention_tiered``): for each row and column kk of [sa | sb], the sum
    over c of rnd(x_c) rnd(w_c), plus q1(x_c) lo(w_c) at "high", each
    product exact, then * scale + shift."""
    c, k = x.shape[1], t.proj_t.shape[0]
    w = t.w_proj[:, 4 * c:4 * c + 2 * k]
    terms = (_rnd(x, LHS_MODE[tier]).double()
             @ _rnd(w, RHS_MODE[tier]).double())
    if tier == "high":
        terms += _q1(x).double() @ _q1(w - _q1(w)).double()
    cols = slice(4 * c, 4 * c + 2 * k)
    return terms.float() * t.proj_scale[cols] + t.proj_shift[cols]


def _ref_dot(a, b, tier):
    """JAX's arithmetic of a product at ``tier`` (the one-pass tiers as a
    bf16 matmul into float32: on the CPU ``kdot(..., "default")`` is a
    float32 product)."""
    a, b = jnp.asarray(a), jnp.asarray(b)
    if tier in ("default", "kdefault"):
        return np.asarray(jnp.matmul(a.astype(jnp.bfloat16),
                                     b.astype(jnp.bfloat16),
                                     preferred_element_type=jnp.float32))
    return np.asarray(kdot(a, b, tier))


@pytest.mark.parametrize("tier", SCORE_TIERS)
def test_fold_scores_match_kdot(narrow, tier):
    """The fold form's score columns sa | sb at each tier, against JAX's
    ``kdot`` of x and its own folded weights (``_global_ins_fold``: wsa =
    W_theta_k @ p_theta_k, at HIGHEST) plus their biases: as the chain
    computes them (``gemm_epilogue`` at ``attn_score``'s tier, the
    ``"kdefault"`` tier as ``"default"``) and as the fold kernels do
    (``_fold_scores_emulated``). Below "highest" the tier shows: both lie
    nearer the tier's reference than the float32 scores."""
    params, _, model = narrow
    gp = params["gabs"][0]["global"]
    t = gab_tables(model.layers_graph_conv[0], model.statics, "fold")
    x = inputs((6 * 17, 32), 33)
    hi = "highest"
    w = np.concatenate([
        np.asarray(jnp.einsum("kci,ki->ck", gp["theta_w"], gp["proj_theta"],
                              precision=hi)),
        np.asarray(jnp.einsum("kci,ki->ck", gp["phi_w"], gp["proj_phi"],
                              precision=hi))], axis=1)
    b = np.concatenate([
        np.asarray(jnp.einsum("ki,ki->k", gp["theta_b"], gp["proj_theta"],
                              precision=hi)),
        np.asarray(jnp.einsum("ki,ki->k", gp["phi_b"], gp["proj_phi"],
                              precision=hi))])
    want = _ref_dot(x, w, tier) + b
    scale = float(np.abs(want).max())
    cols = slice(4 * 32, 4 * 32 + 8)
    xt = torch.from_numpy(x)
    (lo, hi_, kw), = [g for g in K._proj_launches(
        t, 32, dict.fromkeys(KERNEL_OPS, "highest") | {"attn_score": tier})
        if g[0] <= cols.start < g[1]]
    assert (lo, hi_) == (cols.start, cols.stop) or tier == "highest"
    chain = K.gemm_epilogue_plain(
        [(xt, t.w_proj[:, cols].contiguous(), 0)], xt.shape[0],
        scale=t.proj_scale[cols], shift=t.proj_shift[cols],
        tier="default" if tier == "kdefault" else tier)
    emulated = _fold_scores_emulated(xt, t, tier)
    f32 = (xt @ t.w_proj[:, cols] + t.proj_shift[cols]).numpy()
    for got in (chain.numpy(), emulated.numpy()):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
        if tier != "highest":
            assert np.abs(got - want).max() < np.abs(got - f32).max()


WIDTHS = (16, 32, 48, 64, 80, 96)


@pytest.mark.parametrize("c", WIDTHS)
def test_fold_route_widths(c):
    """``fused_gab.gab_route`` and ``kernels.gab_route`` on fold tables: the
    fold form where its shape rule holds and the width is one of
    ``NARROW_ROUTE_WIDTHS_FOLD`` (float32) or ``_FOLD_TIERED`` (every GEMM
    class below "highest": the JAX preset's 243f tiers); the fold chain
    elsewhere, and where the GEMM classes mix "highest" with a lower
    tier. The v1 tables of the same GAB keep the v1 rule."""
    torch.manual_seed(c)
    model = tm.GastNet(tm.GastNetConfig(filter_widths=(3,), channels=c))
    gab = model.layers_graph_conv[0].eval()
    t = gab_tables(gab, model.statics, "fold")
    v1 = gab_tables(gab, model.statics)
    shape = K.gab_shape(t)
    assert shape[:4] == (c, 4, 1, c // 4)
    preset = tm.config_for_frames(243, matmul_precision="high",
                                  precision_overrides=PRESET)
    tiered = {op: preset.tier_for(op, "gab0") for op in KERNEL_OPS}
    mixed = dict(tiered, gab_cat="highest")
    ok = K.narrow_shape_ok(*shape, "fold")
    ok_v1 = K.narrow_shape_ok(*K.gab_shape(v1))
    assert ok == (c in K.NARROW_FOLD_WIDTHS)
    for tiers, widths, widths_v1 in (
            (None, K.NARROW_ROUTE_WIDTHS_FOLD, K.NARROW_ROUTE_WIDTHS),
            (tiered, K.NARROW_ROUTE_WIDTHS_FOLD_TIERED,
             K.NARROW_ROUTE_WIDTHS_TIERED),
            (mixed, (), ())):
        want = "gab_narrow" if ok and c in widths else "chain"
        assert K.gab_route(*shape, tiers, "fold") == want
        assert gab_route(t, tiers) == want
        assert gab_route(v1, tiers) == (
            "gab_narrow" if ok_v1 and c in widths_v1 else "chain")
    assert set(K.NARROW_ROUTE_WIDTHS_FOLD) <= set(K.NARROW_FOLD_WIDTHS)
    assert set(K.NARROW_ROUTE_WIDTHS_FOLD_TIERED) <= set(
        K.NARROW_FOLD_WIDTHS) <= set(K.NARROW_TIERED_WIDTHS)


FOLD_SHAPES = {
    "C=32, K=4": ((32, 4, 1, 8, 17, 4), True),
    "C=16, K=2": ((16, 2, 1, 8, 17, 4), True),
    "C=64, K=4, J=32, D=8": ((64, 4, 1, 16, 32, 8), True),
    "K=1 (odd)": ((32, 1, 1, 32, 17, 4), False),
    "K=3 (odd)": ((48, 3, 1, 16, 17, 4), False),
    "I=8 (v1 tables)": ((32, 4, 8, 8, 17, 4), False),
    "C=80": ((80, 4, 1, 20, 17, 4), False),
    "C=24": ((24, 4, 1, 6, 17, 4), False),
    "K*G != C": ((32, 4, 1, 4, 17, 4), False),
    "J=33": ((32, 4, 1, 8, 33, 4), False),
    "D=9": ((32, 4, 1, 8, 17, 9), False),
}


@pytest.mark.parametrize("case", list(FOLD_SHAPES))
def test_fold_shape_rule(case):
    """The fold form's shape rule (the C entry point's ``refused``): C in
    ``NARROW_FOLD_WIDTHS``, I = 1, K = 2 or 4 with K*G = C, J <= 32, D <=
    8. An odd K is refused: the folded projection's rows, 5C + 2K floats,
    would not start on 16 bytes; such a GAB takes the chain. The v1 rule
    is unchanged."""
    shape, ok = FOLD_SHAPES[case]
    assert K.narrow_shape_ok(*shape, "fold") == ok
    assert (K.gab_route(*shape, None, "fold") == "gab_narrow") == (
        ok and shape[0] in K.NARROW_ROUTE_WIDTHS_FOLD)
    if case.startswith("I=8"):
        assert K.narrow_shape_ok(*shape) and K.narrow_shape_ok(*shape, "v1")


def test_fold_odd_heads_take_the_chain(narrow):
    """Fold tables of three heads (G = 16 at C = 48, built from a K = 4
    GAB's by dropping a head's score columns): ``gab_narrow`` and its
    plain version refuse them, ``fused_gab`` runs them on the chain and
    agrees with the chain of plain versions."""
    torch.manual_seed(48)
    model = tm.GastNet(tm.GastNetConfig(filter_widths=(3,), channels=48))
    t4 = gab_tables(model.layers_graph_conv[0].eval(), model.statics, "fold")
    c = 48
    keep = torch.cat([torch.arange(4 * c), 4 * c + torch.arange(3),
                      4 * c + 4 + torch.arange(3),
                      4 * c + 8 + torch.arange(c)])
    t3 = t4._replace(
        w_proj=t4.w_proj[:, keep].contiguous(),
        proj_scale=t4.proj_scale[keep].contiguous(),
        proj_shift=t4.proj_shift[keep].contiguous(),
        proj_t=t4.proj_t[:3].contiguous(), proj_p=t4.proj_p[:3].contiguous(),
        c_k=t4.c_k[:3].contiguous())
    assert K.gab_shape(t3)[:4] == (48, 3, 1, 16)
    assert gab_route(t3, None) == "chain"
    x = torch.from_numpy(inputs((2, 3, 17, c), 34))
    for fn in (K.gab_narrow, K.gab_narrow_plain):
        with pytest.raises(ValueError, match="fold form takes C"):
            fn(x.reshape(-1, c), t3)
    want = K.gab_chain(x.reshape(-1, c), t3, K.gemm_epilogue_plain,
                       K.sem_graph_plain, K.joint_attention_plain)
    assert torch.equal(fused_gab(x, t3).reshape(-1, 2 * c), want)


@pytest.mark.parametrize("tiered", [False, True], ids=["float32", "tiered"])
def test_fold_launch_arguments(monkeypatch, narrow, tiered):
    """A fold ``gab_narrow`` call on the card launches the v1 call's C
    function with the fold flag set (float32 and tiered libraries alike),
    counted under ``VARIANT_LAUNCHES["gab_narrow"]["fold"]`` and, tiered,
    under its tiers with "fold " before them. The launch is recorded with
    ``_lib`` patched."""
    calls = []

    class Lib:
        def __getattr__(self, symbol):
            return lambda *args: calls.append((symbol, args)) or 0

    monkeypatch.setattr(K, "_lib", lambda lib: calls.append(lib) or Lib())
    monkeypatch.setattr(K, "use_kernel", lambda device: True)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    _, _, model = narrow
    gab = model.layers_graph_conv[0]
    fold = gab_tables(gab, model.statics, "fold")
    v1 = gab_tables(gab, model.statics)
    tiers = dict.fromkeys(KERNEL_OPS, "high") if tiered else None
    x = torch.zeros(3 * 17, 32)
    K.reset_launches()
    K.gab_narrow(x, fold, tiers=tiers)
    K.gab_narrow(x, v1, tiers=tiers)
    (lib, (symbol, args)), (lib1, (symbol1, args1)) = calls[:2], calls[2:]
    assert lib == lib1 == symbol == symbol1 == (
        "gab_narrow_tiered" if tiered else "gab_narrow")
    assert len(args) == len(K._ARGTYPES[symbol])
    assert (args[6:9], args1[6:9]) == ((4, 1, 8), (4, 8, 8))
    assert (args[32], args1[32]) == (1, 0)
    assert args[33:] == args1[33:]
    assert K.VARIANT_LAUNCHES["gab_narrow"] == {"v1": 1, "fold": 1}
    label = "/".join(["high"] * len(K.NARROW_TIER_CLASSES))
    assert K.TIER_LAUNCHES["gab_narrow"] == (
        {f"fold {label}": 1, label: 1} if tiered else {})
    K.reset_launches()
