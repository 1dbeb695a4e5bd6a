"""The plain sites' precision tiers (the JAX package's XLA sites) on the CPU.

(a) The site map: each plain site's tier, ``GastNetConfig.site_tier``
through ``ops.precision.resolve_site_tiers``, against the JAX forward's
resolution (``xla_precision`` of the level-qualified, else bare, override,
else the ambient ``matmul_precision``: ``gastx/models/gastnet.py:222-236``
``level_prec(tag)`` for the conv chains and GABs, ``prec(op)`` for the
expand conv and the shrink, ``:285, 428``), at every site of every level.

(b) The arithmetic: each tiered plain product against the JAX package's
tier arithmetic on the same operands, ``kdot``/``kdot_general`` in their
non-interpret branch (the bf16 ``jnp`` product with float32 sums for one
pass). Both sides multiply bf16-valued operands exactly and sum in
float32, so only the order of the sums differs: rtol 1e-5 of the largest
reference value, as ``tests/test_torch_precision.py`` holds them. The conv
taps (dilated, strided, dense), the 1x1 and the shrink are called
directly; the graph products are recorded as the plain GAB runs them and
each is replayed through JAX (an intermediate that two float32 orders put
on either side of a bf16 boundary would otherwise round apart). The model
on the CPU resolves every site to "highest"; the wiring test resolves them
as on the card, and the CPU runs the plain versions.

(c) ``gab_narrow``'s plain version at the tiers against the chain's, and
``gab_route``'s tiered rule.

No JAX model is compiled here.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models as jm
import gastx.models.config as jc
from gastx.ops.pallas.precision import kdot, kdot_general
import gastx_torch.models.config as tc
from gastx_torch.models import gastnet as GN
from gastx_torch.ops import graph as G
from gastx_torch.ops import precision as P
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.fused_gab import KERNEL_OPS, gab_tables
from gastx_torch.ops.temporal import pointwise, temporal_conv
from test_torch_common import inputs, port_model, random_jax_tree

RTOL = 1e-5
PRESET = jc.TPU_MIXED_PRECISION_OVERRIDES
CUDA = torch.device("cuda")  # the resolvers read only its type
QUALIFIED = (("lvl2.temporal", "default"), ("gab1.attn_proj", "high_lhs"),
             ("attn_proj", "default"), ("temporal", "high_rhs"),
             ("gab0.gab_cat", "kdefault"), ("shrink", "default"))
# name: (frames, matmul_precision, precision_overrides)
SITE_CONFIGS = {
    "high": (27, "high", ()), "default": (81, "default", ()),
    "preset27": (27, "high", PRESET), "preset81": (81, "high", PRESET),
    "preset243": (243, "high", PRESET),
    "qualified": (27, "high", QUALIFIED),
    "qualified_default": (81, "default", QUALIFIED)}


def _jax_site(cfg, tag, op):
    """The JAX forward's tier at a plain site: its resolver's value, or
    the ambient default_matmul_precision (= matmul_precision) for None."""
    raw = cfg.precision_for(f"{tag}.{op}") if tag is not None else None
    if raw is None:
        raw = cfg.precision_for(op)
    tier = jc.xla_precision(raw)
    if tier is None:
        with jax.default_matmul_precision(cfg.matmul_precision):
            tier = jax.config.jax_default_matmul_precision
    return tier


def _configs(name):
    frames, base, over = SITE_CONFIGS[name]
    jcfg = jc.config_for_frames(frames, precision_overrides=over)
    jcfg = dataclasses.replace(jcfg, matmul_precision=base)
    pcfg = tc.config_for_frames(frames, precision_overrides=over,
                                matmul_precision=base)
    return jcfg, pcfg


def _sites(cfg):
    """(tag, op classes) of every plain site of the model: the bare expand
    and shrink, each level's conv chain and GAB."""
    sites = [(None, ("expand", "shrink"))]
    for i in range(cfg.num_levels):
        sites.append((f"gab{i}", GN.GAB_SITE_OPS))
        if i:
            sites.append((f"lvl{i}", GN.CHAIN_SITE_OPS))
    return sites


@pytest.mark.parametrize("name", sorted(SITE_CONFIGS))
def test_site_map_matches_jax(name):
    jcfg, pcfg = _configs(name)
    assert pcfg.precision_overrides == jcfg.precision_overrides
    assert set(GN.GAB_SITE_OPS) | set(GN.CHAIN_SITE_OPS) | {
        "expand", "shrink"} == set(tc.OP_CLASSES)
    for tag, ops in _sites(pcfg):
        want = {op: _jax_site(jcfg, tag, op) for op in ops}
        assert P.resolve_site_tiers(pcfg, tag, ops, CUDA) == want, tag
        assert P.resolve_site_tiers(pcfg, tag, ops, torch.device("cpu")) \
            == dict.fromkeys(ops, "highest")
        # An XLA site never takes a kernel-only tier.
        assert not set(want.values()) & set(tc.KERNEL_ONLY_TIERS)
    if name == "preset243":  # the kdefault gate loosens kernels alone
        assert pcfg.tier_for("gab_cat", "gab0") == "kdefault"
        assert pcfg.site_tier("gab_cat", "gab0") == "high"


# ---------------------------------------------------------------------------
# (b) the arithmetic
# ---------------------------------------------------------------------------

def _ref_dot(a, b, tier):
    a, b = jnp.asarray(a), jnp.asarray(b)
    if tier in ("default", "kdefault"):
        return np.asarray(jnp.matmul(a.astype(jnp.bfloat16),
                                     b.astype(jnp.bfloat16),
                                     preferred_element_type=jnp.float32))
    return np.asarray(kdot(a, b, tier))


def _ref_general(a, b, dims, tier):
    a, b = jnp.asarray(a), jnp.asarray(b)
    if tier in ("default", "kdefault"):
        return np.asarray(jax.lax.dot_general(
            a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), dims,
            preferred_element_type=jnp.float32))
    return np.asarray(kdot_general(a, b, dims, tier))


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()))


def _bn(c, seed):
    bn = torch.nn.BatchNorm2d(c).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t, lo, hi in ((bn.weight, 0.5, 1.5), (bn.bias, -0.2, 0.2),
                          (bn.running_mean, -0.2, 0.2),
                          (bn.running_var, 0.5, 1.5)):
            t.copy_(torch.from_numpy(rng.uniform(lo, hi, c).astype(
                np.float32)))
    return bn


def _bn_relu(y, bn):
    p = {k: v.detach().numpy() for k, v in (
        ("w", bn.weight), ("b", bn.bias), ("m", bn.running_mean),
        ("v", bn.running_var))}
    return np.maximum((y - p["m"]) / np.sqrt(p["v"] + 1e-5) * p["w"]
                      + p["b"], 0.0)


# (B, T, C_in, C_out, fw, dilation, stride, op): the dilated chain tap, the
# strided one on a T that is a multiple of the stride and on one that is
# not, the dense 7-tap conv (three launches), the expand conv (C_in = 2).
CONV_CASES = {
    "dilated": (2, 11, 8, 12, 3, 3, 1, "temporal"),
    "strided": (2, 9, 8, 12, 3, 1, 3, "temporal"),
    "strided_ragged": (2, 10, 8, 12, 3, 1, 3, "temporal"),
    "dense": (2, 12, 8, 12, 7, 1, 1, "temporal"),
    "expand": (3, 9, 2, 16, 3, 1, 1, "expand"),
    "expand_strided": (3, 9, 2, 16, 3, 1, 3, "expand")}


@pytest.mark.parametrize("tier", ("default", "high"))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
@torch.no_grad()
def test_conv_taps_match_kdot(case, tier):
    """``temporal_conv`` at a tier with its BN and ReLU: each output frame
    t sums tap k of frame t*stride + k*dilation by the tier's kdot."""
    b, t, ci, co, fw, dil, stride, op = CONV_CASES[case]
    j = 5
    x = inputs((b, t, j, ci), 1)
    w = inputs((fw, ci, co), 2) / np.sqrt(fw * ci)
    bn = _bn(co, 3)
    got = temporal_conv(torch.from_numpy(x), torch.from_numpy(w),
                        dilation=dil, stride=stride, tier=tier, bn=bn,
                        relu=True, op=op)
    t_out = (t - (fw - 1) * dil - 1) // stride + 1
    acc = 0.0
    for k in range(fw):
        frames = x[:, k * dil:k * dil + (t_out - 1) * stride + 1:stride]
        acc = acc + _ref_dot(frames.reshape(-1, ci), w[k], tier)
    want = _bn_relu(acc.reshape(b, t_out, j, co), bn)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("tier", ("default", "high"))
@torch.no_grad()
def test_pointwise_and_shrink_match_kdot(tier):
    """The 1x1 with its BN and ReLU, the shrink (N = 3, no epilogue), and
    a projection with its bias (``_heads``')."""
    x = inputs((2, 3, 5, 24), 4)
    w, ws = inputs((24, 16), 5) / 5.0, inputs((24, 3), 6) / 5.0
    shift = inputs((16,), 7)
    bn = _bn(16, 8)
    xt = torch.from_numpy(x)
    ref = _ref_dot(x.reshape(-1, 24), w, tier).reshape(2, 3, 5, 16)
    _close(pointwise(xt, torch.from_numpy(w), tier=tier, bn=bn, relu=True),
           _bn_relu(ref, bn))
    _close(pointwise(xt, torch.from_numpy(w), tier=tier,
                     shift=torch.from_numpy(shift), op="attn_proj"),
           ref + shift)
    _close(pointwise(xt, torch.from_numpy(ws), tier=tier, op="shrink"),
           _ref_dot(x.reshape(-1, 24), ws, tier).reshape(2, 3, 5, 3))


def _jj_ref(op, a, b, tier):
    """The JAX arithmetic of a J x J contraction: the local branch's
    einsum ``cjk,btkc->btjc`` (batched over c), a head's score vector, its
    attention applied to g (batched over the frames)."""
    a, b = a.detach().numpy(), b.detach().numpy()
    if op == "local_off":
        c, j, kk = a.shape
        h1 = np.transpose(b.reshape(-1, kk, c), (2, 1, 0))   # (C, K, M)
        y = _ref_general(a, h1, (((2,), (1,)), ((0,), (0,))), tier)
        return np.transpose(y, (2, 1, 0)).reshape(*b.shape[:-2], j, c)
    if op == "attn_score":
        return _ref_dot(a.reshape(-1, a.shape[-1]), b[:, None],
                        tier).reshape(a.shape[:-1])
    j, g = b.shape[-2], b.shape[-1]
    y = _ref_general(a.reshape(-1, j, j), b.reshape(-1, j, g),
                     (((2,), (1,)), ((0,), (0,))), tier)
    return y.reshape(*a.shape[:-1], g)


def _record(monkeypatch):
    """Record every tiered plain product: (kind, op, tier, operands,
    keywords, output)."""
    calls = []
    gemm, jj = K.site_gemm, G._jj

    def site_gemm(op, pieces, m, tier, plain=False, **kw):
        out = gemm(op, pieces, m, tier, plain, **kw)
        calls.append(("gemm", op, tier, pieces, kw, out))
        return out

    def rec_jj(op, tiers, fn, a, b):
        out = jj(op, tiers, fn, a, b)
        tier = "highest" if tiers is None else tiers[op]
        calls.append(("jj", op, tier, (a, b), {}, out))
        return out

    monkeypatch.setattr(K, "site_gemm", site_gemm)
    monkeypatch.setattr(G, "_jj", rec_jj)
    return calls


def _replay(call):
    kind, op, tier, operands, kw, out = call
    if kind == "jj":
        if tier != "highest":
            _close(out, _jj_ref(op, *operands, tier))
        return
    assert kw.get("res") is None and "s_out" not in kw
    acc = sum(_ref_dot(a.numpy(), w.numpy(), tier) for a, w, _ in operands)
    if kw.get("scale") is not None:
        acc = acc * kw["scale"].numpy() + kw["shift"].numpy()
    if kw.get("relu"):
        acc = np.maximum(acc, 0.0)
    _close(out, acc)


# The plain GAB's site tiers: all "high", all "default", and the JAX
# preset's XLA tiers (kernel-only tiers as "high").
GAB_TIERS = {
    "high": dict.fromkeys(GN.GAB_SITE_OPS, "high"),
    "default": dict.fromkeys(GN.GAB_SITE_OPS, "default"),
    "preset": {op: jc.xla_precision(dict(PRESET).get(op, "high"))
               for op in GN.GAB_SITE_OPS}}


def _gab_module(c=16, seed=9):
    cfg = jm.GastNetConfig(filter_widths=(3,), channels=c, dropout=0.0)
    params, state = random_jax_tree(cfg, seed)
    model = port_model(cfg, params, state, gab_impl="xla")
    return model.layers_graph_conv[0], model.statics


@pytest.mark.parametrize("attn_impl", ("einsum", "batched"))
@pytest.mark.parametrize("name", sorted(GAB_TIERS))
def test_graph_products_match_kdot(monkeypatch, name, attn_impl):
    """Every product of the plain GAB at its tier, replayed through JAX's
    arithmetic on the operands it met; each class at the tier it was
    given, the row-wide ones on ``gemm_epilogue`` (here its plain
    version), the J x J ones rounded."""
    tiers = GAB_TIERS[name]
    gab, statics = _gab_module()
    x = torch.from_numpy(inputs((2, 3, 17, 16), 10))
    with torch.no_grad():
        f32 = G.graph_attention_block(x, gab, statics)
        calls = _record(monkeypatch)
        local = G.local_graph(x, gab.local_graph_layer, statics,
                              tiers=tiers)
        globl = G.multi_global_graph(x, gab.global_graph_layer,
                                     impl=attn_impl, tiers=tiers)
        y = G.block_concat(x, local, globl, gab, tiers=tiers)
    k = len(gab.global_graph_layer.attentions)
    seen = collections.Counter((c[1], c[2]) for c in calls)
    assert seen == collections.Counter(
        {("local_sem", tiers["local_sem"]): 2,
         ("local_off", tiers["local_off"]): 2,
         ("local_cat", tiers["local_cat"]): 1,
         ("attn_proj", tiers["attn_proj"]): 1,
         ("attn_score", tiers["attn_score"]): 2 * k,
         ("attn_apply", tiers["attn_apply"]): k,
         ("attn_cat", tiers["attn_cat"]): 1,
         ("gab_cat", tiers["gab_cat"]): 1})
    for call in calls:
        _replay(call)
    # The tiers are visible, and near the float32 block.
    assert not torch.equal(y, f32)
    np.testing.assert_allclose(y.numpy(), f32.numpy(), atol=0.05)


def test_graph_sites_without_tiers_are_unchanged():
    """No tiers (training, the reference) and all-"highest" tiers compute
    the float32 block bit for bit."""
    gab, statics = _gab_module()
    x = torch.from_numpy(inputs((2, 3, 17, 16), 11))
    tiers = dict.fromkeys(GN.GAB_SITE_OPS, "highest")
    with torch.no_grad():
        f32 = G.graph_attention_block(x, gab, statics)
        local = G.local_graph(x, gab.local_graph_layer, statics,
                              tiers=tiers)
        globl = G.multi_global_graph(x, gab.global_graph_layer, tiers=tiers)
        y = G.block_concat(x, local, globl, gab, tiers=tiers)
    assert torch.equal(y, f32)


# ---------------------------------------------------------------------------
# The wiring: every plain site of the model at its tier
# ---------------------------------------------------------------------------

def _as_on_card(monkeypatch):
    """The model's resolvers as on the card (the CPU then runs each
    tiered site through its plain version)."""
    for name in ("resolve_site_tiers", "resolve_tiers"):
        real = getattr(P, name)
        monkeypatch.setattr(
            GN, name, lambda cfg, tag, ops, dev, real=real: real(
                cfg, tag, ops, CUDA))


@pytest.mark.parametrize("variant,dense", [("dilated", False),
                                           ("strided", False),
                                           ("dilated", True)])
def test_model_sites_take_their_tiers(monkeypatch, variant, dense):
    """The route ``gab_impl="xla"`` at level-qualified overrides: every
    plain site's products, counted by class and tier, are the JAX
    forward's resolution at each level (the expand and shrink bare); the
    output moves off the float32 one by a tier's rounding."""
    over = (("lvl2.temporal", "default"), ("gab1.attn_proj", "default"),
            ("mid1x1", "high_rhs"), ("local_off", "default"),
            ("shrink", "default"))
    jcfg = jm.GastNetConfig(filter_widths=(3, 3, 3), channels=8,
                            dropout=0.0, dense=dense,
                            matmul_precision="high",
                            precision_overrides=over)
    params, state = random_jax_tree(jcfg, 12)
    tiered = port_model(jcfg, params, state, gab_impl="xla",
                        matmul_precision="high", precision_overrides=over)
    f32 = port_model(jcfg, params, state, gab_impl="xla")
    x = torch.from_numpy(inputs((2, 27, 17, 2), 13))
    _as_on_card(monkeypatch)
    calls = _record(monkeypatch)
    y = tiered(x, variant)
    cfg = tiered.cfg
    want = collections.Counter({("expand", _jax_site(jcfg, None, "expand")):
                                1,
                                ("shrink", _jax_site(jcfg, None, "shrink")):
                                1})
    for i in range(cfg.num_levels):
        k = cfg.block_channels(i) // (cfg.block_channels(i) // 4)
        counts = dict(local_sem=2, local_off=2, local_cat=1, attn_proj=1,
                      attn_score=2 * k, attn_apply=k, attn_cat=1,
                      gab_cat=1)
        for op, n in counts.items():
            want[(op, _jax_site(jcfg, f"gab{i}", op))] += n
        if i:
            want[("temporal", _jax_site(jcfg, f"lvl{i}", "temporal"))] += \
                -(-cfg.conv_width(i) // 3) if dense else 1
            want[("mid1x1", _jax_site(jcfg, f"lvl{i}", "mid1x1"))] += 1
    assert collections.Counter((c[1], c[2]) for c in calls) == want
    ref = f32(x, variant)
    assert y.shape == ref.shape and bool(torch.isfinite(y).all())
    assert not torch.equal(y, ref)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=0.05)
    assert torch.equal(y, tiered.plain_route_forward(x, variant))


# ---------------------------------------------------------------------------
# (c) gab_narrow at the tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("high", "preset", "mixed"))
def test_gab_narrow_plain_at_tiers_is_the_chain(name):
    """``gab_narrow``'s plain version at the kernel tiers is the chain's
    plain version at the same tiers, bit for bit, and moves off float32."""
    gab, statics = _gab_module(c=32, seed=14)
    t = gab_tables(gab, statics)
    preset = tc.config_for_frames(243, matmul_precision="high",
                                  precision_overrides=PRESET)
    tiers = {"high": dict.fromkeys(KERNEL_OPS, "high"),
             "preset": {op: preset.tier_for(op, "gab1")
                        for op in KERNEL_OPS},
             "mixed": dict(zip(KERNEL_OPS, ("high_rhs", "default",
                                            "high_lhs", "high", "default",
                                            "kdefault", "high")))}[name]
    x = torch.from_numpy(inputs((4 * 17, 32), 15))
    got = K.gab_narrow_plain(x, t, tiers=tiers)
    want = K.gab_chain(x, t, K.gemm_epilogue_plain, K.sem_graph_plain,
                       K.joint_attention_plain, tiers)
    assert torch.equal(got, want)
    assert not torch.equal(got, K.gab_narrow_plain(x, t))


@pytest.mark.parametrize("c", (16, 32, 48, 64, 80, 128))
def test_gab_route_tiered_rule(c):
    """The tiered rule: ``NARROW_ROUTE_WIDTHS_TIERED`` where every chain
    GEMM class is below "highest"; the chain where some are "highest"
    and others not; the float32 rule where all are "highest"."""
    shape = (c, 4, c // 4, c // 4, 17, 4)
    low = dict.fromkeys(KERNEL_OPS, "default")
    mixed = dict(low, gab_cat="highest")
    f32 = dict.fromkeys(KERNEL_OPS, "highest")
    narrow = K.narrow_shape_ok(*shape)
    assert K.gab_route(*shape, low) == (
        "gab_narrow" if narrow and c in K.NARROW_ROUTE_WIDTHS_TIERED
        else "chain")
    assert K.gab_route(*shape, mixed) == "chain"
    assert K.gab_route(*shape, f32) == K.gab_route(*shape) == (
        "gab_narrow" if narrow and c in K.NARROW_ROUTE_WIDTHS else "chain")


def test_gab_narrow_tiered_form_refusals():
    """The tiered form takes C in ``NARROW_TIERED_WIDTHS`` alone, and no
    GAB whose GEMM classes mix "highest" with a lower tier: both raise
    (the plain version too), as the C entry point refuses them."""
    low = dict.fromkeys(KERNEL_OPS, "default")
    mixed = dict(low, gab_cat="highest")
    gab, statics = _gab_module(c=32, seed=16)
    t = gab_tables(gab, statics)
    x = torch.from_numpy(inputs((2 * 17, 32), 17))
    assert K.narrow_form(mixed) is None
    for fn in (K.gab_narrow, K.gab_narrow_plain):
        with pytest.raises(ValueError, match="highest"):
            fn(x, t, tiers=mixed)
    wide, statics = _gab_module(c=80, seed=18)
    t80 = gab_tables(wide, statics)
    with pytest.raises(ValueError, match="tiered form takes C"):
        K.gab_narrow(torch.from_numpy(inputs((17, 80), 19)), t80, tiers=low)
    assert 80 not in K.NARROW_TIERED_WIDTHS
    assert set(K.NARROW_ROUTE_WIDTHS_TIERED) <= set(K.NARROW_TIERED_WIDTHS)


@pytest.mark.parametrize("name", ["gab_narrow_tiered", "gab_narrow_tiered_io"])
def test_tiered_library_binds_its_symbol(name, monkeypatch, tmp_path):
    """The tiered form's libraries (gab_narrow.cu built with the tiered
    flag, float32 and bf16 I/O) bind their one C function with its
    argument types (ctypes would pass an unbound pointer as a 32-bit
    int)."""
    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self, path):
            self.gab_narrow_tiered, self.error_string = Fn(), Fn()

    lib_file = tmp_path / "lib.so"
    lib_file.touch()
    monkeypatch.setattr(K, "_library_path", lambda _: lib_file)
    monkeypatch.setattr(K.ctypes, "CDLL", Lib)
    monkeypatch.setattr(K, "_LIBS", {})
    lib = K._lib(name)
    assert lib.gab_narrow_tiered.argtypes == K._ARGTYPES["gab_narrow_tiered"]
    assert len(K._ARGTYPES["gab_narrow_tiered"]) == 42
    assert K._ARGTYPES["gab_narrow_tiered"][40:] == [K._P, K._LL]
    flags = K.TIERED_FLAGS if name.endswith("tiered") else \
        K.IO_FLAGS + K.TIERED_FLAGS
    assert K._libraries()[name] == ("gab_narrow", flags)


@pytest.mark.parametrize("name", ["high", "preset"])
def test_tiered_gab_narrow_launch_arguments(monkeypatch, name):
    """A tiered gab_narrow call on the card launches the tiered library's
    C function with the float32 call's arguments and each class's tier
    code (TC_TIERS for the GEMM classes, kdefault as default; ATTN_TIERS
    for the attention's), counted under its tiers; float32 tiers launch
    the float32 library. The launch is recorded with ``_lib`` patched."""
    calls = []

    class Lib:
        def __getattr__(self, symbol):
            return lambda *args: calls.append((symbol, args)) or 0

    monkeypatch.setattr(K, "_lib", lambda lib: calls.append(lib) or Lib())
    monkeypatch.setattr(K, "use_kernel", lambda device: True)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    preset = tc.config_for_frames(243, matmul_precision="high",
                                  precision_overrides=PRESET)
    tiers = ({op: preset.tier_for(op, "gab1") for op in KERNEL_OPS}
             if name == "preset" else dict.fromkeys(KERNEL_OPS, "high"))
    gab, statics = _gab_module(c=32, seed=20)
    t = gab_tables(gab, statics)
    x = torch.zeros(3 * 17, 32)
    K.reset_launches()
    K.gab_narrow(x, t, tiers=tiers)
    K.gab_narrow(x, t)
    (lib, (symbol, args)), (lib32, (symbol32, args32)) = \
        calls[:2], calls[2:]
    assert (lib, symbol) == ("gab_narrow_tiered", "gab_narrow_tiered")
    assert (lib32, symbol32) == ("gab_narrow", "gab_narrow")
    assert len(args) == 42 and args[:33][2:] == args32[2:]
    assert args32[-1] == 0  # the fold flag: v1 tables
    codes = [K.TC_TIERS.index("default" if tiers[op] == "kdefault"
                              else tiers[op])
             for op in K.NARROW_TIER_CLASSES[:5]]
    codes += [K.ATTN_TIERS.index(tiers[op])
              for op in K.NARROW_TIER_CLASSES[5:]]
    assert list(args[33:40]) == codes
    # The scratch buffer of the stream, and its size in words.
    scratch = K.narrow_scratch(x.device, 0)
    assert args[40:] == (scratch.data_ptr(), K.NARROW_SCRATCH_WORDS)
    assert K.LAUNCHES["gab_narrow"] == 2
    assert sum(K.TIER_LAUNCHES["gab_narrow"].values()) == 1
    K.reset_launches()
