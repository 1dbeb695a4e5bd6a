"""The train step at the JAX package's matmul tiers, on the CPU.

(a) The backward's tier contract, from JAX itself: the ``jax.make_jaxpr``
of ``jax.vjp`` of the JAX package's ``temporal_conv`` (dilated, strided),
``pointwise`` and a graph conv (its ``jnp.matmul`` and einsum) at
``precision=p`` shows every product, the transposed ones included,
carrying ``p`` (``jax/_src/lax/lax.py``'s transpose rules pass it on).

(b) ``site_grad.SiteGemm`` through ``temporal_conv`` and ``pointwise``
with autograd on (the wrappers' plain versions on the CPU): the output,
the input gradient and the weight gradient of each conv form and the 1x1
against the JAX package's tier arithmetic on the same operands,
``kdot``/``kdot_general`` in their non-interpret branch, of ``(x, w)``,
``(g, w^T)`` and ``(x^T, g)``: rtol 1e-5 of the largest reference value,
as ``tests/test_torch_site_tiers.py`` holds the eval products (both sides
multiply bf16-valued operands exactly and sum in float32; only the order
of the sums differs).

(c) ``precision.TieredContraction`` the same way for the three J x J
classes and both gradients.

(d) A train step "as on the card" (the model's resolvers patched to the
card's resolution, every wrapper's plain version): each train site's
products by class and tier against JAX's resolution, every tiered
product of the forward and the backward recorded and replayed through
``kdot``; the loss and gradients move off the float32 step's, within a
stated bound of it.

(e) ``gemm_wgrad``'s plain version against ``kdot`` at ragged rows, K = 2
pieces and N = 51; its refusals, its split rule and its launch arguments.

No JAX model is compiled here.
"""
import collections
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models.config as jc
import gastx.ops.graph as jg
from gastx.ops.temporal import pointwise as j_pointwise
from gastx.ops.temporal import temporal_conv as j_temporal_conv
import gastx_torch.models.config as tc
from gastx_torch.models import GastNet, init_gastnet
from gastx_torch.models import gastnet as GN
from gastx_torch.ops import graph as G
from gastx_torch.ops import precision as P
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda import site_grad as S
from gastx_torch.ops.temporal import pointwise, temporal_conv
from gastx_torch.train import make_optimizer, train_step
from test_torch_common import inputs
from test_torch_site_tiers import (PRESET, _as_on_card, _close, _jax_site,
                                   _jj_ref, _ref_dot, _ref_general)

TIERS = ("default", "high")


# ---------------------------------------------------------------------------
# (a) the backward's tier in JAX
# ---------------------------------------------------------------------------

def _eqns(jaxpr):
    """Every equation of ``jaxpr`` and of the jaxprs inside it."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _eqns(inner)


def _jax_case(case, p):
    """(function of (x, w), x, w) of the JAX package at precision ``p``."""
    if case == "dilated":
        return (lambda x, w: j_temporal_conv(x, w, dilation=3, precision=p),
                jnp.ones((2, 11, 5, 4)), jnp.ones((3, 4, 6)))
    if case == "strided":
        return (lambda x, w: j_temporal_conv(x, w, stride=3, precision=p),
                jnp.ones((2, 9, 5, 4)), jnp.ones((3, 4, 6)))
    if case == "pointwise":
        return (lambda x, w: j_pointwise(x, w, precision=p),
                jnp.ones((2, 3, 5, 4)), jnp.ones((4, 6)))
    idx = np.array([0, 1, 5, 6, 7, 10, 11, 12, 17, 18, 23, 24], np.int64)

    def graph(x, w):
        params = {"W0": w[0], "W1": w[1], "e": jnp.ones((6, len(idx)))}
        return jg.sem_ch_graph_conv(x, params, idx, 5, impl="einsum",
                                    prec=lambda op: p)
    return graph, jnp.ones((2, 3, 5, 4)), jnp.ones((2, 4, 6))


@pytest.mark.parametrize("p", TIERS)
@pytest.mark.parametrize("case", ("dilated", "strided", "pointwise",
                                  "graph"))
def test_jax_vjp_carries_the_tier(case, p):
    """Every dot_general and conv of the forward and of its vjp at
    precision ``p`` carries ``p`` for both operands: the transposed
    products (``dA = G W^T``, ``dW = A^T G``) run at the forward's tier on
    the TPU, which ``SiteGemm`` and ``TieredContraction`` follow."""
    fn, x, w = _jax_case(case, p)
    y = fn(x, w)
    jaxpr = jax.make_jaxpr(lambda x, w, g: (fn(x, w),
                                            jax.vjp(fn, x, w)[1](g)))(
        x, w, y).jaxpr
    precs = [e.params["precision"] for e in _eqns(jaxpr)
             if e.primitive.name in ("dot_general", "conv_general_dilated")]
    want = (jax.lax.Precision(p),) * 2
    # the forward's products and their transposes: the graph conv's two
    # matmuls and its einsum (whose adjacency is a constant here)
    assert len(precs) >= (8 if case == "graph" else 3)
    assert all(tuple(q) == want for q in precs), precs


# ---------------------------------------------------------------------------
# (b) SiteGemm against kdot
# ---------------------------------------------------------------------------

# (B, T, C_in, C_out, fw, dilation, stride, op, shift): the dilated tap at
# d = 1 and 3, a causal level's conv on a shifted view of its input, the
# strided one on a T that is a multiple of the stride and on one that is
# not, a strided one whose taps lie within a wider stride, the dense 7-tap
# conv (launches of three), the expand conv (C_in = 2) dilated and strided.
CONV_CASES = {
    "dilated_d1": (2, 9, 8, 12, 3, 1, 1, "temporal", 0),
    "dilated_d3": (2, 11, 8, 12, 3, 3, 1, "temporal", 0),
    "causal_shifted": (2, 12, 8, 12, 3, 3, 1, "temporal", 1),
    "strided": (2, 9, 8, 12, 3, 1, 3, "temporal", 0),
    "strided_ragged": (2, 10, 8, 12, 3, 1, 3, "temporal", 0),
    "strided_gap": (2, 10, 8, 12, 2, 2, 5, "temporal", 0),
    "dense": (2, 12, 8, 12, 7, 1, 1, "temporal", 0),
    "expand": (3, 9, 2, 16, 3, 1, 1, "expand", 0),
    "expand_strided": (3, 9, 2, 16, 3, 1, 3, "expand", 0),
}


def _leaf(a):
    return torch.from_numpy(a).requires_grad_(True)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_site_conv_and_grads_match_kdot(case, tier):
    """``temporal_conv`` with autograd at a tier: output frame t sums
    kdot(frame t*stride + k*d, W_k); dX scatters kdot(G, W_k^T) back onto
    those frames (zero on frames no tap read); dW_k = kdot(frames_k^T,
    G)."""
    b, t, ci, co, fw, dil, stride, op, shift = CONV_CASES[case]
    j = 5
    x_full = inputs((b, t + shift, j, ci), 1)
    w = inputs((fw, ci, co), 2) / np.sqrt(fw * ci)
    xt, wt = _leaf(x_full), _leaf(w)
    y = temporal_conv(xt[:, shift:], wt, dilation=dil, stride=stride,
                      tier=tier, op=op)
    x = x_full[:, shift:]
    t_out = (t - (fw - 1) * dil - 1) // stride + 1
    assert y.shape == (b, t_out, j, co)
    g = inputs(tuple(y.shape), 3)
    y.backward(torch.from_numpy(g))
    g2 = g.reshape(-1, co)
    frames = [x[:, k * dil:k * dil + (t_out - 1) * stride + 1:stride]
              for k in range(fw)]
    want_y = sum(_ref_dot(f.reshape(-1, ci), w[k], tier)
                 for k, f in enumerate(frames))
    _close(y, want_y.reshape(b, t_out, j, co))
    want_dx = np.zeros_like(x_full)
    for k in range(fw):
        s = shift + k * dil
        want_dx[:, s:s + (t_out - 1) * stride + 1:stride] += _ref_dot(
            g2, w[k].T, tier).reshape(b, t_out, j, ci)
    _close(xt.grad, want_dx)
    want_dw = np.stack([_ref_dot(f.reshape(-1, ci).T, g2, tier)
                        for f in frames])
    _close(wt.grad, want_dw)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("n", (16, 3))
def test_site_pointwise_and_grads_match_kdot(n, tier):
    """The 1x1 (N = 16, and the shrink's N = 3) with its bias: y =
    kdot(x, W) + shift, dX = kdot(G, W^T), dW = kdot(x^T, G), and the
    bias' gradient the sum of G."""
    x = inputs((2, 3, 5, 24), 4)
    w = inputs((24, n), 5) / 5.0
    shift = inputs((n,), 6)
    xt, wt, st = _leaf(x), _leaf(w), _leaf(shift)
    y = pointwise(xt, wt, tier=tier, shift=st, op="mid1x1")
    g = inputs(tuple(y.shape), 7)
    y.backward(torch.from_numpy(g))
    x2, g2 = x.reshape(-1, 24), g.reshape(-1, n)
    _close(y, (_ref_dot(x2, w, tier) + shift).reshape(2, 3, 5, n))
    _close(xt.grad, _ref_dot(g2, w.T, tier).reshape(x.shape))
    _close(wt.grad, _ref_dot(x2.T, g2, tier))
    np.testing.assert_allclose(st.grad.numpy(), g2.sum(0), rtol=1e-5)


@pytest.mark.parametrize("tier", TIERS)
def test_site_product_of_pieces_matches_kdot(tier):
    """A concatenation's product (the block concat's three pieces): each
    piece's gradient a column block of kdot(G, W^T), W's gradient the
    stacked kdot(piece^T, G)."""
    xs = [inputs((2, 3, 5, 8), 10 + i) for i in range(3)]
    w = inputs((24, 12), 13) / 5.0
    leaves = [_leaf(x) for x in xs]
    wt = _leaf(w)
    y = S.site_product("gab_cat", leaves, wt, tier)
    g = inputs(tuple(y.shape), 14)
    y.backward(torch.from_numpy(g))
    cat, g2 = np.concatenate(xs, -1).reshape(-1, 24), g.reshape(-1, 12)
    _close(y, _ref_dot(cat, w, tier).reshape(2, 3, 5, 12))
    dcat = _ref_dot(g2, w.T, tier)
    for i, leaf in enumerate(leaves):
        _close(leaf.grad, dcat[:, 8 * i:8 * (i + 1)].reshape(2, 3, 5, 8))
    _close(wt.grad, _ref_dot(cat.T, g2, tier))


def test_site_products_off_the_train_step_are_unchanged():
    """Without a gradient to record (the eval forward) and at "highest"
    the sites compute what they computed before: the fused eval epilogue
    below "highest", and the torch product with autograd at it."""
    x = torch.from_numpy(inputs((2, 9, 5, 8), 15))
    w = torch.from_numpy(inputs((3, 8, 12), 16))
    with torch.no_grad():
        eval_y = temporal_conv(x, w, dilation=3, tier="high")
    wt = w.clone().requires_grad_(True)
    train_y = temporal_conv(x, wt, dilation=3, tier="high")
    assert torch.equal(train_y.detach(), eval_y)
    assert "SiteGemmBackward" in _graph_names(train_y)
    top = temporal_conv(x, wt, dilation=3)
    assert "SiteGemmBackward" not in _graph_names(top)


def _graph_names(t):
    """The names of the autograd nodes behind ``t``."""
    names, stack = set(), [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and type(node).__name__ not in names:
            names.add(type(node).__name__)
            stack.extend(f for f, _ in node.next_functions)
    return names


# ---------------------------------------------------------------------------
# (c) TieredContraction against kdot
# ---------------------------------------------------------------------------

def _jj_operands(op):
    if op == "local_off":
        return inputs((6, 5, 5), 20), inputs((2, 3, 5, 6), 21), G._aggregate
    if op == "attn_score":
        return inputs((2, 3, 5, 4), 22), inputs((4,), 23), torch.matmul
    return inputs((2, 3, 5, 5), 24), inputs((2, 3, 5, 4), 25), torch.matmul


def _jj_grads(op, a, b, g, tier):
    """The JAX arithmetic of the contraction's two transposed products."""
    if op == "local_off":
        c, j, kk = a.shape
        gc = np.transpose(g.reshape(-1, j, c), (2, 1, 0))     # (C, J, M)
        hc = np.transpose(b.reshape(-1, kk, c), (2, 0, 1))    # (C, M, K)
        da = _ref_general(gc, hc, (((2,), (1,)), ((0,), (0,))), tier)
        db = _ref_general(a, gc, (((1,), (1,)), ((0,), (0,))), tier)
        return da, np.transpose(db, (2, 1, 0)).reshape(b.shape)
    if op == "attn_score":
        g2 = g.reshape(-1, 1)
        da = _ref_dot(g2, b[None, :], tier).reshape(a.shape)
        db = _ref_dot(g.reshape(1, -1), a.reshape(-1, a.shape[-1]),
                      tier).reshape(b.shape)
        return da, db
    j, gg = b.shape[-2], b.shape[-1]
    a3, b3, g3 = a.reshape(-1, j, j), b.reshape(-1, j, gg), \
        g.reshape(-1, j, gg)
    da = _ref_general(g3, b3, (((2,), (2,)), ((0,), (0,))), tier)
    db = _ref_general(a3, g3, (((1,), (1,)), ((0,), (0,))), tier)
    return da.reshape(a.shape), db.reshape(b.shape)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("op", ("local_off", "attn_score", "attn_apply"))
def test_tiered_contraction_and_grads_match_kdot(op, tier):
    """Each J x J class's forward and both gradients at the tier: the
    cotangent split as the operands are, each transposed product on
    tier-rounded operands; each gradient counted by the hook."""
    a, b, fn = _jj_operands(op)
    at, bt = _leaf(a), _leaf(b)
    seen = []
    y = P.TieredContraction.apply(fn, G.JJ_VJPS[op], at, bt, tier,
                                  lambda which, t, g: seen.append((which,
                                                                   t)))
    g = inputs(tuple(y.shape), 26)
    y.backward(torch.from_numpy(g))
    _close(y, _jj_ref(op, torch.from_numpy(a), torch.from_numpy(b), tier))
    da, db = _jj_grads(op, a, b, g, tier)
    _close(at.grad, da)
    _close(bt.grad, db)
    assert seen == [("da", tier), ("db", tier)]
    # Autograd through the forward's own arithmetic is not the tier's.
    a2, b2 = _leaf(a), _leaf(b)
    P.tiered(fn, a2, b2, tier).backward(torch.from_numpy(g))
    assert not torch.equal(a2.grad, at.grad)


# ---------------------------------------------------------------------------
# (d) the train step as on the card
# ---------------------------------------------------------------------------

# name: (matmul_precision, precision_overrides)
STEP_TIERS = {"high": ("high", ()), "preset": ("high", PRESET)}


def _step_model(over, base):
    cfg = tc.GastNetConfig(filter_widths=(3, 3), channels=16, dropout=0.0,
                           matmul_precision=base, precision_overrides=over)
    model = init_gastnet(GastNet(cfg), torch.Generator().manual_seed(31))
    return model.train()


def _rows(m, s_out, a_s_in, off):
    r = np.arange(m)
    return (r // s_out) * a_s_in + r % s_out + off


def _record_step(monkeypatch):
    """Record every tiered product of the step: the forward's (site_gemm,
    _jj), the input and weight gradients' (site_grad's ``_gemm`` and
    ``_wgrad``) and every backward product's class (count_site_grad). The
    operands are copied as they are met: the step's optimizer moves the
    parameters in place afterwards (a score vector is a view of one)."""
    calls, grads = [], []
    site_gemm, jj, gemm, wgrad = K.site_gemm, G._jj, S._gemm, S._wgrad

    def copy(t):
        return t if t is None or isinstance(t, int) else t.detach().clone()

    def copies(pieces):
        return [tuple(copy(t) for t in p) for p in pieces]

    def rec_site(op, pieces, m, tier, plain=False, **kw):
        out = site_gemm(op, pieces, m, tier, plain, **kw)
        calls.append(("gemm", op, tier, copies(pieces), m,
                      {k: copy(v) for k, v in kw.items()}, copy(out)))
        return out

    def rec_jj(op, tiers, fn, a, b):
        out = jj(op, tiers, fn, a, b)
        calls.append(("jj", op, tiers[op], (copy(a), copy(b)), None, {},
                      copy(out)))
        return out

    def rec_gemm(site, pieces, m, **kw):
        out = gemm(site, pieces, m, **kw)
        calls.append(("dA", site.op, site.tier, copies(pieces), m,
                      {k: copy(v) for k, v in kw.items()}, copy(out)))
        return out

    def rec_wgrad(site, pieces, g, m, **kw):
        out = wgrad(site, pieces, g, m, **kw)
        calls.append(("dW", site.op, site.tier, (copies(pieces), copy(g)),
                      m, dict(kw), copy(out)))
        return out

    monkeypatch.setattr(K, "site_gemm", rec_site)
    monkeypatch.setattr(G, "_jj", rec_jj)
    monkeypatch.setattr(S, "_gemm", rec_gemm)
    monkeypatch.setattr(S, "_wgrad", rec_wgrad)
    monkeypatch.setattr(K, "count_site_grad",
                        lambda op, key, t: grads.append((op, key)))
    return calls, grads


def _np(t):
    return t.detach().numpy()


def _replay(call):
    """A recorded product against JAX's arithmetic on its operands."""
    kind, op, tier, operands, m, kw, out = call
    if kind == "jj":
        if tier != "highest":
            _close(out, _jj_ref(op, *operands, tier))
        return
    if kind == "dW":
        pieces, g = operands
        s_out = kw.get("s_out") or m
        a_s_in = kw.get("a_s_in") or s_out
        want = np.concatenate([
            _ref_dot(_np(a)[_rows(m, s_out, a_s_in, off)].T, _np(g), tier)
            for a, off in pieces])
        _close(out, want)
        return
    s_out = kw.get("s_out") or m
    a_s_in = kw.get("a_s_in") or s_out
    acc = sum(_ref_dot(_np(a)[_rows(m, s_out, a_s_in, off)], _np(w), tier)
              for a, w, off in operands)
    assert kw.get("scale") is None and not kw.get("relu")
    if kw.get("res") is not None:
        acc = acc + _np(kw["res"])
    _close(out, acc)


def _batch(variant, seed):
    t, frames = (27, 3) if variant == "strided" else (33, 25)
    x2 = inputs((4, t, 17, 2), seed)
    return (torch.from_numpy(x2),
            torch.from_numpy(0.3 * inputs((4, frames, 17, 3), seed + 1)),
            torch.ones(4))


def _one_step(model, batch, variant):
    opt = make_optimizer(model.parameters())
    loss = train_step(model, opt, *batch, 1e-3, None, variant)
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("variant", ("strided", "dilated"))
@pytest.mark.parametrize("name", sorted(STEP_TIERS))
def test_train_step_as_on_the_card(monkeypatch, name, variant):
    """One train step at ``-arc 3,3 -ch 16``, the sites resolved as on the
    card: every site's forward products by class and tier are JAX's
    resolution (``_jax_site``), every product has its input and weight
    gradients at its tier, every recorded product agrees with ``kdot``,
    and the prediction and gradients move off the float32 step's by a
    tier's rounding: the loss within 2e-3 of the float32 loss, every
    gradient within 0.1 of the float32 step's largest gradient (the
    preset's one-pass attention moves the small gradients of the
    projections' biases most: 0.065 of it at this size)."""
    base, over = STEP_TIERS[name]
    f32_model = _step_model(over, base)
    tiered = copy.deepcopy(f32_model)
    batch = _batch(variant, 40)
    with torch.no_grad():
        f32_pred = copy.deepcopy(f32_model)(batch[0], variant)
    f32_loss, f32_grads = _one_step(f32_model, batch, variant)
    _as_on_card(monkeypatch)
    with torch.no_grad():
        pred = copy.deepcopy(tiered)(batch[0], variant)
    calls, grads = _record_step(monkeypatch)
    loss, got = _one_step(tiered, batch, variant)
    cfg = tiered.cfg
    jcfg = dataclasses.replace(
        jc.GastNetConfig(filter_widths=(3, 3), channels=16,
                         precision_overrides=over), matmul_precision=base)
    want = collections.Counter({("expand", _jax_site(jcfg, None, "expand")):
                                1,
                                ("shrink", _jax_site(jcfg, None, "shrink")):
                                1})
    for i in range(cfg.num_levels):
        k = 4
        for op, n in dict(local_sem=2, local_off=2, local_cat=1, attn_proj=1,
                          attn_score=2 * k, attn_apply=k, attn_cat=1,
                          gab_cat=1).items():
            want[(op, _jax_site(jcfg, f"gab{i}", op))] += n
        if i:
            for op in ("temporal", "mid1x1"):
                want[(op, _jax_site(jcfg, f"lvl{i}", op))] += 1
    fwd = [c for c in calls if c[0] in ("gemm", "jj")]
    assert collections.Counter((c[1], c[2]) for c in fwd) == want
    assert "highest" not in {c[2] for c in calls}
    # every row-wide product has its two gradients, every J x J one its
    # two (a contraction with a weight-free operand: the aggregation's
    # adjacency, the scores' vector and the attention all need theirs)
    rows = sum(n for (op, _), n in want.items()
               if op not in ("local_off", "attn_score", "attn_apply"))
    counts = collections.Counter(key.split()[0] for _, key in grads)
    assert counts["dA"] == counts["dW"] == rows
    jjs = sum(n for (op, _), n in want.items()
              if op in ("local_off", "attn_score", "attn_apply"))
    assert counts["da"] == counts["db"] == jjs
    assert sum(c[0] == "dW" for c in calls) == rows
    for call in calls:
        _replay(call)
    assert not torch.equal(pred, f32_pred)
    assert abs(float(loss) - float(f32_loss)) <= 2e-3 * abs(float(f32_loss))
    assert any(not torch.equal(got[n], f32_grads[n]) for n in got)
    top = max(float(g.abs().max()) for g in f32_grads.values())
    for n, g in got.items():
        assert float((g - f32_grads[n]).abs().max()) <= 0.1 * top, n


def test_train_step_at_highest_is_unchanged(monkeypatch):
    """At "highest" (the port's default) the step resolved as on the card
    runs no tiered product and equals the CPU's step bit for bit."""
    model = _step_model((), "highest")
    other = copy.deepcopy(model)
    batch = _batch("strided", 41)
    loss, grads = _one_step(model, batch, "strided")
    _as_on_card(monkeypatch)
    calls, _ = _record_step(monkeypatch)
    loss2, grads2 = _one_step(other, batch, "strided")
    assert not [c for c in calls if c[0] != "jj"]
    assert torch.equal(loss, loss2)
    assert all(torch.equal(grads[n], grads2[n]) for n in grads)


# ---------------------------------------------------------------------------
# (e) gemm_wgrad's plain version
# ---------------------------------------------------------------------------

# (rows of A, K_p of each piece, offsets, M, s_out, a_s_in, N): ragged M
# over a conv's row map, the expand conv's three K = 2 taps, the shrink's
# N = 3 and an N = 51 on pieces of different K.
WGRAD_CASES = {
    "ragged_rows": (2 * 11 * 5, (8, 8, 8), (0, 15, 30), 2 * 5 * 5, 25, 55,
                    12),
    "k2_taps": (3 * 9 * 5, (2, 2, 2), (0, 5, 10), 3 * 7 * 5, 35, 45, 16),
    "n51": (77, (5, 13, 2), (0, 0, 0), 77, 77, 77, 51),
    "shrink": (45, (16,), (0,), 45, 45, 45, 3),
}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("case", sorted(WGRAD_CASES))
def test_gemm_wgrad_plain_matches_kdot(case, tier):
    rows, ks, offs, m, s_out, a_s_in, n = WGRAD_CASES[case]
    aa = [inputs((rows, k), 50 + i) for i, k in enumerate(ks)]
    g = inputs((m, n), 60)
    pieces = [(torch.from_numpy(a), off) for a, off in zip(aa, offs)]
    kw = dict(s_out=s_out, a_s_in=a_s_in, tier=tier)
    got = K.gemm_wgrad_plain(pieces, torch.from_numpy(g), m, **kw)
    want = np.concatenate([_ref_dot(a[_rows(m, s_out, a_s_in, off)].T, g,
                                    tier) for a, off in zip(aa, offs)])
    assert got.shape == (sum(ks), n)
    _close(got, want)
    # On a CPU tensor the wrapper is its plain version.
    assert torch.equal(K.gemm_wgrad(pieces, torch.from_numpy(g), m, **kw),
                       got)


def test_gemm_wgrad_refusals():
    a = torch.zeros(20, 4)
    g = torch.zeros(10, 8)
    for tier in ("highest", "high_lhs", "kdefault"):
        with pytest.raises(ValueError, match="tiers"):
            K.gemm_wgrad([(a, 0)], g, 10, tier=tier)
    with pytest.raises(ValueError, match="row map"):
        K.gemm_wgrad([(a, 11)], g, 10, tier="high")
    with pytest.raises(ValueError, match="1 to 3 pieces"):
        K.gemm_wgrad([(a, 0)] * 4, g, 10, tier="high")
    with pytest.raises(RuntimeError, match="no backward"):
        K.gemm_wgrad([(a.requires_grad_(), 0)], g, 10, tier="high")


# (m, tiles, instantiation): the general kernel's cases keep their ids.
SPLIT_CASES = [pytest.param(m, t, "general", id=f"{m}-{t}")
               for m, t in ((32, 1), (156_672, 24), (17_408, 384), (1000, 3),
                            (513, 2))]
SPLIT_CASES += [pytest.param(m, t, v, id=f"{v}-{m}-{t}") for v, m, t in (
    ("wgmma", 156_672, 3), ("wgmma", 17_408, 48), ("wgmma", 352_512, 1),
    ("wgmma", 4_352, 240), ("wgmma", 100, 1), ("wgmma", 1000, 2),
    ("smallk", 156_672, 1), ("smallk", 352_512, 1), ("smallk", 100, 1),
    ("smallk", 1100, 1))]


@pytest.mark.parametrize("m,tiles,variant", SPLIT_CASES)
def test_wgrad_splits_cover_the_rows(m, tiles, variant):
    """Every split a multiple of the slab's rows, none empty, together
    covering the rows; the blocks within the instantiation's blocks an SM
    (one wave: the wgmma kernel one block an SM), each split at least its
    fewest rows unless there is one."""
    per_sm, min_rows = K.WGRAD_SPLIT_RULES[variant]
    splits, chunk = K.wgrad_splits(m, tiles, 132, variant)
    assert chunk % K.WGRAD_ROWS == 0 and chunk >= K.WGRAD_ROWS
    assert splits * chunk >= m > (splits - 1) * chunk
    assert splits == 1 or chunk >= min_rows - K.WGRAD_ROWS
    assert splits * tiles <= max(tiles, per_sm * 132)
    assert K.wgrad_splits(m, tiles, 132, variant) == (splits, chunk)


def test_wgrad_splits_at_the_recorded_shapes():
    """The wgmma kernel's splits at the 27f B=1024 step's three timed
    calls: 44 slices of the GAB-0 block concat's 3 tiles (17.3 MB of
    workspace against 401 MB of operands), 2 of the C=512 block concat's
    48, 66 of the local cat's 2; the expand taps' 258 smallk blocks."""
    def plan(ks, n, m, variant):
        tiles, width = K.wgrad_tiles(ks, n, variant)
        return tiles, width, K.wgrad_splits(m, tiles, 132, variant)[0]

    assert plan((128,) * 3, 256, 156_672, "wgmma") == (3, 256, 44)
    assert plan((512,) * 3, 1024, 17_408, "wgmma") == (48, 256, 2)
    assert plan((128,) * 2, 128, 156_672, "wgmma") == (2, 128, 66)
    assert plan((32,) * 3, 64, 352_512, "wgmma") == (1, 64, 132)
    assert plan((2,) * 3, 128, 156_672, "smallk") == (1, 128, 258)
    assert plan((6, 70), 51, 2900, "general") == (3, 64, 5)


def _wpiece(rows, k, off=0, offset=0):
    """A (rows, k) float32 piece at row offset ``off``, ``offset`` floats
    past an aligned start."""
    return (torch.zeros(rows * k + offset)[offset:].view(rows, k), off)


# case: (K_p of each piece, N, the 3-tap row map (its runs' rows s_out;
# a_s_in = 3 s_out) or None, a piece's start offset in floats, want)
WGRAD_ROUTES = {
    "k8": ((8, 8, 8), 64, None, 0, "wgmma"),
    "k6": ((8, 6, 8), 64, None, 0, "general"),
    "n8": ((32,), 8, None, 0, "wgmma"),
    "n51": ((32,), 51, None, 0, "general"),
    "shrink_n3": ((1024,), 3, None, 0, "general"),
    "sum_k16": ((6, 10), 32, None, 0, "smallk"),
    "sum_k17": ((6, 11), 32, None, 0, "general"),
    "sum_k16_n1024": ((8, 8), 1024, None, 0, "smallk"),
    "sum_k16_n1032": ((8, 8), 1032, None, 0, "wgmma"),
    "sum_k24": ((16, 8), 64, None, 0, "wgmma"),
    "unaligned_a": ((64, 64), 64, None, 1, "general"),
    "unaligned_small_a": ((2, 2, 2), 128, None, 1, "smallk"),
    "taps_k64": ((64, 64, 64), 64, 17, 0, "wgmma"),
    "taps_k64_s19": ((64, 64, 64), 64, 19, 0, "wgmma"),
    "taps_k64_s25": ((64, 64, 64), 64, 25, 0, "general"),
    "taps_k64_s425": ((64, 64, 64), 64, 425, 0, "wgmma"),
    "taps_k2": ((2, 2, 2), 128, 17, 0, "smallk"),
    "gab0_block_concat": ((128, 128, 128), 256, None, 0, "wgmma"),
    "local_cat": ((128, 128), 128, None, 0, "wgmma"),
    "c512_block_concat": ((512, 512, 512), 1024, None, 0, "wgmma"),
}


@pytest.mark.parametrize("case", sorted(WGRAD_ROUTES))
def test_wgrad_route(case):
    """Which instantiation each weight gradient takes: smallk at sum K_p
    <= 16 (N a multiple of 4 up to 1024), wgmma at K_p and N multiples of
    8 with 16-byte starts (a conv's taps where a slab's runs of the row
    map fit its staging), general for the rest; a misaligned G sends both
    fast paths to general."""
    ks, n, s_out, offset, want = WGRAD_ROUTES[case]
    rows = 2 * 3 * (s_out or 17)
    kw = {}
    if s_out:
        x = _wpiece(rows, ks[0], 0, offset)[0]
        pieces = [(x, k * s_out) for k in range(3)]
        kw = dict(s_out=s_out, a_s_in=3 * s_out)
    else:
        pieces = [_wpiece(rows, k, 0, offset if i == 1 else 0)
                  for i, k in enumerate(ks)]
    assert K.wgrad_route(pieces, torch.zeros(rows, n), **kw) == want
    g_off = _wpiece(rows, n, 0, 2)[0]
    assert K.wgrad_route(pieces, g_off, **kw) == "general"


def _smallk_wgrad_emulate(pieces, g, m, s_out, a_s_in, tier, sms=132):
    """gemm_wgrad.cu's smallk instantiation's per-element float32
    arithmetic: thread (c, rl) of split s sums the rows r_begin + rl +
    j R in order, each row's exact products of the split values added as
    ah.gh, then at "high" ah.gl and al.gh; the block adds its R partial
    sums in order; a warp an element adds the slices, lane l those l, l +
    32, ... from 0, then the lanes by the xor butterfly 16, 8, 4, 2, 1."""
    n = g.shape[1]
    r = np.arange(m)
    base = (r // s_out) * a_s_in + r % s_out
    a = np.concatenate([x.numpy()[base + off] for x, off in pieces], axis=1)
    (ah, al), (gh, gl) = [
        [h.float().numpy() for h in P.split_bf16(torch.from_numpy(v))]
        for v in (a, g.numpy())]
    splits, chunk = K.wgrad_splits(m, 1, sms, "smallk")
    rows = 256 // (n // 4)
    slices = []
    for s in range(splits):
        r0, r1 = s * chunk, min(m, (s + 1) * chunk)
        acc = np.zeros((rows, a.shape[1], n), np.float32)
        for j in range(-(-(r1 - r0) // rows)):
            rr = r0 + np.arange(rows) + j * rows
            ok = rr < r1
            rr = np.where(ok, rr, 0)
            terms = [(ah, gh)] + ([(ah, gl), (al, gh)] if tier == "high"
                                  else [])
            for x, y in terms:
                prod = x[rr][:, :, None] * y[rr][:, None, :]
                acc = np.where(ok[:, None, None], acc + prod, acc)
        part = acc[0]
        for i in range(1, rows):
            part = part + acc[i]
        slices.append(part)
    if splits == 1:
        return slices[0]
    lanes = [np.zeros_like(slices[0]) for _ in range(32)]
    for j, sl in enumerate(slices):
        lanes[j % 32] = lanes[j % 32] + sl
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[l] + lanes[l ^ o] for l in range(32)]
    return lanes[0]


@pytest.mark.parametrize("tier", TIERS)
def test_wgrad_smallk_arithmetic_matches_plain(tier):
    """The smallk instantiation's arithmetic (emulated in float32 above)
    on three K = 2 taps over a strided row map, with its rows split in two
    slices, against ``gemm_wgrad_plain`` within 1e-6 of the largest value:
    both sum exact products of the split values in float32, in another
    order. The tier is visible: the float32 product lies further away."""
    j, seqs = 17, 40
    m, s_out, a_s_in = seqs * j, j, 3 * j
    x = torch.from_numpy(inputs((seqs * a_s_in, 2), 70))
    g = torch.from_numpy(inputs((m, 16), 71))
    pieces = [(x, k * j) for k in range(3)]
    assert K.wgrad_route(pieces, g) == "smallk"
    assert K.wgrad_splits(m, 1, 1, "smallk")[0] == 1
    got = _smallk_wgrad_emulate(pieces, g, m, s_out, a_s_in, tier, sms=1)
    want = K.gemm_wgrad_plain(pieces, g, m, s_out=s_out, a_s_in=a_s_in,
                              tier=tier).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    # two slices and the butterfly (1,100 rows: splits of 544 and 556)
    m2 = 1100
    x2 = torch.from_numpy(inputs((m2, 3), 72))
    g2 = torch.from_numpy(inputs((m2, 8), 73))
    assert K.wgrad_splits(m2, 1, 132, "smallk")[0] == 2
    got2 = _smallk_wgrad_emulate([(x2, 0)], g2, m2, m2, m2, tier)
    want2 = K.gemm_wgrad_plain([(x2, 0)], g2, m2, tier=tier).numpy()
    np.testing.assert_allclose(got2, want2, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(want2).max()))
    f32 = np.concatenate([x.numpy()[_rows(m, s_out, a_s_in, off)].T
                          @ g.numpy() for _, off in pieces])
    assert np.abs(got - f32).max() > 1e-6 * scale


# (instantiation, tier) of the launch-argument test: the general kernel's
# cases keep their ids.
LAUNCH_CASES = [pytest.param("general", t, id=t) for t in TIERS]
LAUNCH_CASES += [pytest.param(v, t, id=f"{v}-{t}")
                 for v in ("wgmma", "smallk") for t in TIERS]


@pytest.mark.parametrize("variant,tier", LAUNCH_CASES)
def test_gemm_wgrad_launch_arguments(monkeypatch, variant, tier):
    """A call on the card launches the C function of its instantiation
    once: each piece's (a, K_p[, rows], a_off), the row map, a workspace
    of splits x K_total x N floats (none for one split), the split rule's
    chunk, the tier's TC_TIERS code and, for wgmma, the tile's width;
    counted under its tier and instantiation. The launch is recorded with
    ``_lib`` patched."""
    calls = []

    class Lib:
        def __getattr__(self, symbol):
            return lambda *args: calls.append((symbol, args)) or 0

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(K, "_lib", lambda lib: Lib())
    monkeypatch.setattr(K, "use_kernel", lambda device: True)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props())
    ks, n, m = {"general": ((6, 70), 51, 2900),
                "wgmma": ((64, 40), 96, 2900),
                "smallk": ((6, 2), 12, 2900)}[variant]
    a, b = torch.zeros(3000, ks[0]), torch.zeros(3000, ks[1])
    g = torch.zeros(m, n)
    K.reset_launches()
    out = K.gemm_wgrad([(a, 0), (b, 100)], g, m, tier=tier)
    (symbol, args), = calls
    symbols = {"general": "gemm_wgrad", "wgmma": "gemm_wgrad_hopper",
               "smallk": "gemm_wgrad_smallk"}
    assert symbol == symbols[variant]
    assert len(args) == len(K._ARGTYPES[symbol])
    tiles, width = K.wgrad_tiles(ks, n, variant)
    splits, chunk = K.wgrad_splits(m, tiles, 132, variant)
    if variant == "wgmma":
        assert args[:12] == (a.data_ptr(), ks[0], 3000, 0, b.data_ptr(),
                             ks[1], 3000, 100, None, 0, 0, 0)
        assert (tiles, width) == (1, 128) and args[-1] == width
        args = args[12:-1]
    else:
        assert args[:9] == (a.data_ptr(), ks[0], 0, b.data_ptr(), ks[1],
                            100, None, 0, 0)
        args = args[9:]
    assert args[:6] == (2, g.data_ptr(), m, n, m, m)
    assert args[7:9] == (splits, chunk) and splits > 1
    assert args[6] is not None and args[9] == out.data_ptr()
    assert args[11] == K.TC_TIERS.index(tier)
    assert out.shape == (sum(ks), n)
    assert K.LAUNCHES["gemm_wgrad"] == 1
    assert K.TIER_LAUNCHES["gemm_wgrad"][tier] == 1
    assert K.VARIANT_LAUNCHES["gemm_wgrad"] == {
        v: int(v == variant) for v in K.WGRAD_VARIANTS}
    K.reset_launches()


def test_wgrad_library_binds_every_symbol(monkeypatch, tmp_path):
    """gemm_wgrad.cu's library binds its three C functions (general,
    wgmma, smallk) with their argument types: ctypes would pass an unbound
    pointer as a 32-bit int."""
    class Fn:
        argtypes = restype = None

    symbols = ("gemm_wgrad", "gemm_wgrad_hopper", "gemm_wgrad_smallk")

    class Lib:
        def __init__(self, path):
            for symbol in symbols + ("error_string",):
                setattr(self, symbol, Fn())

    lib_file = tmp_path / "lib.so"
    lib_file.touch()
    monkeypatch.setattr(K, "_library_path", lambda _: lib_file)
    monkeypatch.setattr(K.ctypes, "CDLL", Lib)
    monkeypatch.setattr(K, "_LIBS", {})
    lib = K._lib("gemm_wgrad")
    for symbol in symbols:
        assert getattr(lib, symbol).argtypes == K._ARGTYPES[symbol]
    assert [len(K._ARGTYPES[s]) for s in symbols] == [21, 25, 21]
