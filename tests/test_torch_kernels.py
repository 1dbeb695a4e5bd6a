"""The port's kernel wrappers (gastx_torch.ops.cuda) against the JAX
package's Pallas kernels, run in interpret mode on the CPU, where each
wrapper takes its plain version (tests/test_torch_cuda.py holds the
kernels themselves to their plain versions on the card).

Tolerance: atol 2e-5, rtol 1e-4 (both sides float32; only the order of
summation differs between XLA:CPU and ATen).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models as jm
from gastx.ops.pallas.fused_gab import fused_gab as j_fused_gab
from gastx.ops.pallas.fused_gab import fused_gab_packed as j_fused_gab_packed
from gastx.ops.pallas.fused_gab import fused_gab_pbatch as j_fused_gab_pbatch
from gastx.ops.pallas.fused_gab import fused_gab_split as j_fused_gab_split
from gastx.ops.pallas.fused_gab import (
    fused_local_branch as j_fused_local_branch)
from gastx.ops.pallas.fused_level import fused_level as j_fused_level
from gastx.ops.pallas.fused_level import fused_level0 as j_fused_level0
from gastx.ops.pallas.global_attn import (
    fused_global_attention as j_fused_global_attention)
from gastx.ops.pallas.head_attn import head_attention as j_head_attention
from gastx_torch.models.gastnet import GraphAttentionBlock
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.fused_gab import (fused_gab, fused_gab_packed,
                                            fused_local_branch, gab_tables,
                                            local_tables)
from gastx_torch.ops.cuda.fused_level import (fused_level, fused_level0,
                                              level0_tables, level_tables)
from gastx_torch.ops.cuda.global_attn import (fused_global_attention,
                                              global_tables)
from gastx_torch.ops.cuda.head_attn import head_attention
from test_torch_common import (assert_close, inputs, port_model,
                               random_jax_tree)

LEVEL_CFG = jm.GastNetConfig(filter_widths=(3, 3), channels=64, dropout=0.0)
# The 243-frame model's widths: C = 32, 64, ... (the narrow GABs of levels
# 0-1, gab_narrow on the card).
NARROW_CFG = jm.GastNetConfig(filter_widths=(3, 3, 3, 3, 3), channels=32,
                              dropout=0.0)
# The 27-frame model's widths: C = 128, 256, 512.
WIDE_CFG = jm.GastNetConfig(dropout=0.0)
# The other joint layouts (J = 15, 16, 19; D = 5 neighbour slots, as at
# J = 17), whose frames the card's graph kernels tile: a two-level model of
# each, C = 32, 64.
LAYOUTS = ("humaneva15", "sh16", "h36m19")


def _layout_cfg(layout):
    j = jm.graph_statics(layout).num_joints
    return jm.GastNetConfig(filter_widths=(3, 3), channels=32, dropout=0.0,
                            num_joints_in=j, num_joints_out=j, layout=layout)


def _idx(cfg):
    s = jm.graph_statics(cfg.layout)
    return tuple(int(i) for i in s.sym_idx), tuple(int(i) for i in s.con_idx)


@pytest.fixture(scope="module")
def level_weights():
    params, state = random_jax_tree(LEVEL_CFG, seed=11)
    return params, state, port_model(LEVEL_CFG, params, state)


@pytest.fixture(scope="module")
def narrow_weights():
    params, state = random_jax_tree(NARROW_CFG, seed=14)
    return params, state, port_model(NARROW_CFG, params, state)


@pytest.fixture(scope="module")
def wide_weights():
    params, state = random_jax_tree(WIDE_CFG, seed=12)
    return params, state, port_model(WIDE_CFG, params, state)


@pytest.fixture(scope="module")
def layout_weights():
    """layout -> (params, state, port model) of its ``_layout_cfg``."""
    out = {}
    for i, layout in enumerate(LAYOUTS):
        cfg = _layout_cfg(layout)
        params, state = random_jax_tree(cfg, seed=26 + i)
        out[layout] = params, state, port_model(cfg, params, state)
    return out


def _weights(request, name):
    """A parity case's (params, state, port model): a module fixture by
    name, or a layout's model."""
    if name in LAYOUTS:
        return request.getfixturevalue("layout_weights")[name]
    return request.getfixturevalue(name)


def test_fused_gab_matches_jax_kernel(level_weights):
    params, state, model = level_weights
    x = inputs((2, 5, 17, 64), 1)
    want = j_fused_gab(jnp.asarray(x), params["gabs"][0], state["gabs"][0],
                       *_idx(LEVEL_CFG), interpret=True)
    got = fused_gab(torch.from_numpy(x),
                    gab_tables(model.layers_graph_conv[0], model.statics))
    assert_close(got, want)


def test_fused_gab_matches_jax_split_kernel_at_512(wide_weights):
    params, state, model = wide_weights
    assert WIDE_CFG.block_channels(2) == 512
    x = inputs((1, 3, 17, 512), 2)
    want = j_fused_gab_split(jnp.asarray(x), params["gabs"][2],
                             state["gabs"][2], *_idx(WIDE_CFG),
                             interpret=True)
    got = fused_gab(torch.from_numpy(x),
                    gab_tables(model.layers_graph_conv[2], model.statics))
    assert_close(got, want)


@pytest.mark.parametrize("weights,cfg,level", [
    ("narrow_weights", NARROW_CFG, 0), ("wide_weights", WIDE_CFG, 2)] + [
    (layout, _layout_cfg(layout), 1) for layout in LAYOUTS],
    ids=["C=32", "C=512", *LAYOUTS])
def test_fused_local_branch_matches_jax_kernel(request, weights, cfg, level):
    """At C=32 and 512 on 17 joints, and at C=64 on each other layout."""
    params, state, model = _weights(request, weights)
    c = cfg.block_channels(level)
    x = inputs((1, 3, cfg.num_joints_in, c), 16)
    want = j_fused_local_branch(jnp.asarray(x), params["gabs"][level],
                                state["gabs"][level], *_idx(cfg),
                                interpret=True)
    got = fused_local_branch(
        torch.from_numpy(x),
        local_tables(model.layers_graph_conv[level].local_graph_layer,
                     model.statics))
    assert_close(got, want)


@pytest.mark.parametrize("weights,j,c", [("level_weights", 17, 128)] + [
    (layout, _layout_cfg(layout).num_joints_in, 64) for layout in LAYOUTS],
    ids=["h36m17", *LAYOUTS])
def test_head_attention_matches_jax_kernel(request, weights, j, c):
    """Each head of level 1's block (C=128 on 17 joints, C=64 on each other
    layout) on its slices of one projection output, over M = 37 frames:
    not a multiple of the TPU kernel's 32-frame tile, which it pads."""
    params, _, model = _weights(request, weights)
    gp = params["gabs"][1]["global"]
    k, inter = gp["proj_theta"].shape
    assert k * inter == c and gp["g_w"].shape[2] == inter
    p = inputs((37, j, 3 * k * inter), 17)     # theta | phi | g
    heads = model.layers_graph_conv[1].global_graph_layer.attentions
    for h in range(k):
        cols = [slice(s * k * inter + h * inter, s * k * inter +
                      (h + 1) * inter) for s in range(3)]
        want = j_head_attention(
            *(jnp.asarray(p[..., c]) for c in cols),
            jnp.asarray(gp["proj_theta"][h].reshape(inter, 1)),
            jnp.asarray(gp["proj_phi"][h].reshape(inter, 1)),
            jnp.asarray(gp["C_k"][h]), interpret=True)
        proj = heads[h].concat_project[0].weight.reshape(-1, 1)
        pt = torch.from_numpy(p)
        got = head_attention(*(pt[..., c] for c in cols), proj[:inter],
                             proj[inter:], heads[h].C_k)
        assert_close(got, want)


@pytest.mark.parametrize("weights,level", [
    ("level_weights", 0), ("wide_weights", 2)], ids=["C=64", "C=512"])
def test_fused_global_attention_matches_jax_kernel(request, weights, level):
    """Held to the TPU kernel with cat_bn folded as the JAX package's own
    test folds it."""
    params, state, model = request.getfixturevalue(weights)
    gp = params["gabs"][level]["global"]
    gs = state["gabs"][level]["global"]
    scale = gp["cat_bn"]["scale"] / np.sqrt(gs["cat_bn"]["var"] + 1e-5)
    shift = gp["cat_bn"]["bias"] - gs["cat_bn"]["mean"] * scale
    glb = model.layers_graph_conv[level].global_graph_layer
    x = inputs((1, 3, 17, glb.cat_conv.weight.shape[0]), 18)
    want = j_fused_global_attention(jnp.asarray(x), gp, jnp.asarray(scale),
                                    jnp.asarray(shift), interpret=True)
    got = fused_global_attention(torch.from_numpy(x), global_tables(glb))
    assert_close(got, want)


@pytest.mark.parametrize("c", [32, 64])
def test_fused_gab_packed_matches_jax_kernel(narrow_weights, c):
    """On the packed (B, T, J*C) layout, B*T = 10 frames: not a multiple of
    the TPU kernel's row tile."""
    params, state, model = narrow_weights
    level = {32: 0, 64: 1}[c]
    x = inputs((2, 5, 17 * c), 19)
    want = j_fused_gab_packed(jnp.asarray(x), params["gabs"][level],
                              state["gabs"][level], 17, *_idx(NARROW_CFG),
                              interpret=True)
    t = gab_tables(model.layers_graph_conv[level], model.statics)
    assert_close(fused_gab_packed(torch.from_numpy(x), t, 17), want)


@pytest.mark.parametrize("b,c,pack", [(8, 32, 4), (3, 32, 4), (4, 64, 2)])
def test_fused_gab_matches_jax_pbatch_kernel(narrow_weights, b, c, pack):
    """The narrow GAB (C < 128: gab_narrow on the card, its plain chain
    here) against the frame-packed TPU kernel; b=3 leaves a frame count
    that is not a multiple of the pack."""
    params, state, model = narrow_weights
    level = {32: 0, 64: 1}[c]
    x = inputs((b, 5, 17, c), 5)
    want = j_fused_gab_pbatch(jnp.asarray(x), params["gabs"][level],
                              state["gabs"][level], *_idx(NARROW_CFG),
                              pack=pack, interpret=True)
    t = gab_tables(model.layers_graph_conv[level], model.statics)
    assert_close(fused_gab(torch.from_numpy(x), t), want)
    assert_close(K.gab_narrow(torch.from_numpy(x).reshape(-1, c), t),
                 np.asarray(want).reshape(-1, 2 * c))


def test_fused_level0_matches_jax_kernel_at_32(narrow_weights):
    params, state, model = narrow_weights
    x = inputs((2, 7, 17, 2), 6)
    want = j_fused_level0(jnp.asarray(x), params, state, *_idx(NARROW_CFG),
                          fw=3, interpret=True)
    got = fused_level0(
        torch.from_numpy(x),
        level0_tables(model.init_bn, model.expand_conv, model.expand_bn),
        gab_tables(model.layers_graph_conv[0], model.statics))
    assert_close(got, want)


@pytest.mark.parametrize("channels", [16, 32], ids=["C=32", "C=64"])
def test_fused_level_matches_jax_kernel_narrow(channels):
    """An interior level whose GAB is narrow: C=32 (a 16-channel model's
    level 1) and C=64 (the 243-frame model's level 1)."""
    cfg = jm.GastNetConfig(filter_widths=(3, 3), channels=channels,
                           dropout=0.0)
    params, state = random_jax_tree(cfg, seed=15)
    model = port_model(cfg, params, state)
    c = cfg.block_channels(1)
    x = inputs((2, 9, 17, c), 7)
    want = j_fused_level(jnp.asarray(x), params["temporal"][0],
                         state["temporal"][0], params["gabs"][1],
                         state["gabs"][1], *_idx(cfg), fw=3, dilation=3,
                         res_off=3, interpret=True)
    got = fused_level(
        torch.from_numpy(x), level_tables(*model.level_modules(1)),
        gab_tables(model.layers_graph_conv[1], model.statics),
        fw=3, dilation=3, res_off=3)
    assert_close(got, want)


def test_fused_level0_matches_jax_kernel(level_weights):
    params, state, model = level_weights
    x = inputs((2, 9, 17, 2), 3)
    want = j_fused_level0(jnp.asarray(x), params, state, *_idx(LEVEL_CFG),
                          fw=3, interpret=True)
    got = fused_level0(
        torch.from_numpy(x),
        level0_tables(model.init_bn, model.expand_conv, model.expand_bn),
        gab_tables(model.layers_graph_conv[0], model.statics))
    assert_close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_level_matches_jax_kernel(causal):
    cfg = jm.GastNetConfig(filter_widths=(3, 3), channels=64, dropout=0.0,
                           causal=causal)
    params, state = random_jax_tree(cfg, seed=13)
    model = port_model(cfg, params, state)
    res_off = cfg.pads()[1] + cfg.causal_shifts("dilated")[1]
    x = inputs((2, 9, 17, 128), 4)
    want = j_fused_level(jnp.asarray(x), params["temporal"][0],
                         state["temporal"][0], params["gabs"][1],
                         state["gabs"][1], *_idx(cfg), fw=3, dilation=3,
                         res_off=res_off, interpret=True)
    got = fused_level(
        torch.from_numpy(x),
        level_tables(*model.level_modules(1)),
        gab_tables(model.layers_graph_conv[1], model.statics),
        fw=3, dilation=3, res_off=res_off)
    assert_close(got, want)


def test_gemm_epilogue_row_map_and_residual():
    """The tap row map and residual offset, against an explicit loop: two
    sequences of T_in=6 frames of J=2 rows, a 3-tap conv of dilation 2
    (T_out=2), residual from frame 1."""
    rng = np.random.default_rng(5)
    b, t_in, j, c, n, d = 2, 6, 2, 3, 4, 2
    x = rng.standard_normal((b * t_in * j, c)).astype(np.float32)
    w = rng.standard_normal((3, c, n)).astype(np.float32)
    res = rng.standard_normal((b * t_in * j, n)).astype(np.float32)
    scale, shift = rng.uniform(0.5, 1.5, n), rng.standard_normal(n)
    t_out = t_in - 2 * d
    want = np.zeros((b * t_out * j, n), np.float32)
    for s in range(b):
        for q in range(t_out * j):
            acc = sum(x[s * t_in * j + q + k * d * j] @ w[k] for k in range(3))
            want[s * t_out * j + q] = (np.maximum(acc * scale + shift, 0)
                                       + res[s * t_in * j + q + j])
    tx = torch.from_numpy
    got = K.gemm_epilogue(
        [(tx(x), tx(w[k]), k * d * j) for k in range(3)], b * t_out * j,
        s_out=t_out * j, a_s_in=t_in * j,
        scale=tx(scale.astype(np.float32)),
        shift=tx(shift.astype(np.float32)), relu=True, res=tx(res),
        res_s_in=t_in * j, res_off=j)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _at_offset(*shape):
    """A zero tensor that starts 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1)[1:].view(*shape)


def _conv_taps(c_in):
    """The level-0 expand conv's three tap pieces over (B, T, J, C_in)."""
    x = torch.zeros(2, 9, 17, c_in).reshape(-1, c_in)
    w = torch.zeros(3, c_in, 128)
    return [(x, w[k], k * 17) for k in range(3)]


# (pieces, N, residual) -> the gemm_epilogue instantiation they take.
GEMM_VARIANT_CASES = {
    "aligned": (lambda: [(torch.zeros(40, 128), torch.zeros(128, 256), 0)],
                256, None, "vec16"),
    "aligned_three_pieces": (
        lambda: [(torch.zeros(40, 128), torch.zeros(128, 256), 0)] * 3,
        256, None, "vec16"),
    "aligned_residual": (
        lambda: [(torch.zeros(40, 128), torch.zeros(128, 256), 0)], 256,
        torch.zeros(60, 256), "vec16"),
    "aligned_row_offset": (
        lambda: [(torch.zeros(40, 132), torch.zeros(132, 64), 3)], 64, None,
        "vec16"),
    "k_not_multiple_of_4": (
        lambda: [(torch.zeros(40, 130), torch.zeros(130, 64), 0)], 64, None,
        "general"),
    "n_not_multiple_of_4": (
        lambda: [(torch.zeros(40, 128), torch.zeros(128, 70), 0)], 70, None,
        "general"),
    "misaligned_a": (lambda: [(_at_offset(40, 128), torch.zeros(128, 64),
                               0)], 64, None, "general"),
    "misaligned_w": (lambda: [(torch.zeros(40, 128), _at_offset(128, 64),
                               0)], 64, None, "general"),
    "misaligned_w_third_piece": (
        lambda: [(torch.zeros(40, 128), torch.zeros(128, 64), 0)] * 2
        + [(torch.zeros(40, 128), _at_offset(128, 64), 0)], 64, None,
        "general"),
    "misaligned_res": (lambda: [(torch.zeros(40, 128), torch.zeros(128, 64),
                                 0)], 64, _at_offset(40, 64), "general"),
    "level0_taps": (lambda: _conv_taps(2), 128, None, "general"),
    "level_taps_c128": (lambda: _conv_taps(128), 128, None, "vec16"),
}


@pytest.mark.parametrize("case", sorted(GEMM_VARIANT_CASES))
def test_gemm_variant(case):
    """The 16-byte instantiation only where every K_p and N are multiples of
    4 and every operand starts 16-byte aligned."""
    pieces, n, res, want = GEMM_VARIANT_CASES[case]
    assert K.gemm_variant(pieces(), n, res) == want


def _projection(c, pad=0, offset=0, rows=34):
    """The chain's zero (rows, 7C) projection output P of a GAB with K = 4
    heads and I = G = C / 4, at row stride 7C + ``pad``, ``offset`` floats
    past an aligned start."""
    flat = torch.zeros(rows * (7 * c + pad) + offset)
    return flat[offset:].view(rows, 7 * c + pad)[:, :7 * c]


def _sem(c, **kw):
    """sem_graph's (views, widths) on the chain's P."""
    return (_projection(c, **kw),), (c,)


def _attn(c, **kw):
    """joint_attention's (views, widths) on the chain's theta | phi | g."""
    p, ki = _projection(c, **kw), c
    return ((p[:, 4 * c:4 * c + ki], p[:, 4 * c + ki:4 * c + 2 * ki],
             p[:, 4 * c + 2 * ki:]), (c // 4, c // 4))


def _head(c, h):
    """head_attention's one-head views (rows of 17 joints merged) of a
    hybrid-route projection [theta | phi | g] at C, K = 4, head h."""
    i = c // 4
    p = torch.zeros(5, 17, 3 * c).view(-1, 3 * c)
    return ((p[:, h * i:(h + 1) * i], p[:, c + h * i:c + (h + 1) * i],
             p[:, 2 * c + h * i:2 * c + (h + 1) * i]), (i, i))


# (views, widths) of sem_graph or joint_attention -> the instantiation.
GRAPH_VARIANT_CASES = {
    "sem C=128": (lambda: _sem(128), "vec16"),
    "sem C=256": (lambda: _sem(256), "vec16"),
    "sem C=512": (lambda: _sem(512), "vec16"),
    "sem C=8": (lambda: _sem(8), "vec16"),
    "sem C=24": (lambda: _sem(24), "vec16"),
    "sem C=6": (lambda: _sem(6), "general"),
    "sem odd row stride": (lambda: _sem(256, pad=1), "general"),
    "sem 4-byte offset": (lambda: _sem(256, offset=1), "general"),
    "attn C=128": (lambda: _attn(128), "vec16"),
    "attn C=256": (lambda: _attn(256), "vec16"),
    "attn C=512": (lambda: _attn(512), "vec16"),
    "attn C=8 (I=2)": (lambda: _attn(8), "general"),
    "attn C=24 (I=6)": (lambda: _attn(24), "general"),
    "attn C=16 (I=4)": (lambda: _attn(16), "vec16"),
    "attn odd row stride": (lambda: _attn(256, pad=1), "general"),
    "attn 4-byte offset": (lambda: _attn(256, offset=1), "general"),
    "head C=256": (lambda: _head(256, 1), "vec16"),
    "head C=128": (lambda: _head(128, 3), "vec16"),
    "head C=8": (lambda: _head(8, 1), "general"),
}


@pytest.mark.parametrize("case", sorted(GRAPH_VARIANT_CASES))
def test_graph_variant(case):
    """The graph kernels' 16-byte instantiation only where every width and
    row stride is a multiple of 4 and every view starts 16-byte aligned."""
    operands, want = GRAPH_VARIANT_CASES[case]
    assert K.graph_variant(*operands()) == want


# (C, K, I, G, J, D) -> the kernels the GAB takes on the card. The model's
# GABs have K = 4 heads and I = G = C // 4; C = 8, 24 and 40 are not
# multiples of 16, gab_narrow lost to the chain at C = 80 and 96, C = 112
# has no instantiation of it, C = 128 is wide.
GAB_ROUTE_CASES = {
    "C=8": ((8, 4, 2, 2, 17, 4), "chain"),
    "C=16": ((16, 4, 4, 4, 17, 4), "gab_narrow"),
    "C=24": ((24, 4, 6, 6, 17, 4), "chain"),
    "C=32": ((32, 4, 8, 8, 17, 4), "gab_narrow"),
    "C=40": ((40, 4, 10, 10, 17, 4), "chain"),
    "C=48": ((48, 4, 12, 12, 17, 4), "gab_narrow"),
    "C=64": ((64, 4, 16, 16, 17, 4), "gab_narrow"),
    "C=80": ((80, 4, 20, 20, 17, 4), "chain"),
    "C=96": ((96, 4, 24, 24, 17, 4), "chain"),
    "C=112": ((112, 4, 28, 28, 17, 4), "chain"),
    "C=128": ((128, 4, 32, 32, 17, 4), "chain"),
    "C=64, 8 heads": ((64, 8, 8, 8, 17, 4), "chain"),
    "C=64, G != I": ((64, 4, 16, 32, 17, 4), "chain"),
    "C=32, J=33": ((32, 4, 8, 8, 33, 4), "chain"),
    "C=32, D=9": ((32, 4, 8, 8, 17, 9), "chain"),
}


@pytest.mark.parametrize("case", list(GAB_ROUTE_CASES))
def test_gab_route(case):
    """gab_narrow only where its shape rule holds and it beat the chain;
    every other GAB shape takes the chain."""
    shape, want = GAB_ROUTE_CASES[case]
    assert K.gab_route(*shape) == want
    assert K.narrow_shape_ok(*shape) == (
        want == "gab_narrow" or shape[0] in (80, 96))


@pytest.mark.parametrize("channels", [8, 24])
def test_gab_narrow_refuses_widths_it_cannot_compute(channels):
    """A direct gab_narrow call on a GAB off its shape rule raises before
    any device work, though the GAB itself runs (on the chain)."""
    cfg = jm.GastNetConfig(filter_widths=(3,), channels=channels,
                           dropout=0.0)
    params, state = random_jax_tree(cfg, seed=23)
    model = port_model(cfg, params, state)
    t = gab_tables(model.layers_graph_conv[0], model.statics)
    assert K.gab_shape(t) == (channels, 4, channels // 4, channels // 4, 17,
                              t.col.shape[2])
    x = torch.zeros(2 * 17, channels)
    with pytest.raises(ValueError, match="gab_narrow takes"):
        K.gab_narrow(x, t)
    assert fused_gab(x.reshape(1, 2, 17, channels), t).shape == (
        1, 2, 17, 2 * channels)


@pytest.mark.parametrize("route", [
    {"gab_impl": "auto"}, {"gab_impl": "pallas"},
    {"gab_impl": "pallas", "packed_channels": 16}],
    ids=["auto", "pallas", "packed16"])
def test_channels8_forward_matches_gastnet_forward(route):
    """The 8-channel model (GABs at C = 8, 16, 32: the chain, then
    gab_narrow on the card) on each route that reaches fused_gab, against
    the JAX eval forward."""
    cfg = jm.GastNetConfig(filter_widths=(3, 3, 3), channels=8, dropout=0.0)
    params, state = random_jax_tree(cfg, seed=24)
    model = port_model(cfg, params, state, **route)
    x = inputs((2, 29, 17, 2), 25)
    want, _ = jm.gastnet_forward(params, state, jnp.asarray(x), cfg,
                                 variant="dilated", train=False)
    assert_close(model(torch.from_numpy(x)), want)


def test_wrappers_reject_bad_inputs(level_weights):
    _, _, model = level_weights
    t = gab_tables(model.layers_graph_conv[0], model.statics)
    x = torch.zeros(2, 3, 17, 64)
    with pytest.raises(ValueError):
        fused_gab(x.double(), t)
    with pytest.raises(ValueError):
        fused_gab(x.transpose(1, 2), t)
    with pytest.raises(ValueError):
        fused_gab(torch.zeros(2, 3, 17, 32), t)
    with pytest.raises(ValueError):  # rows are not whole frames
        K.gab_narrow(torch.zeros(20, 64), t)
    wide = gab_tables(GraphAttentionBlock(128, model.statics), model.statics)
    with pytest.raises(ValueError):  # C >= 128 is the chain's
        K.gab_narrow(torch.zeros(17, 128), wide)
    a = torch.zeros(8, 3)
    with pytest.raises(ValueError):
        K.gemm_epilogue([(a, torch.zeros(4, 2), 0)], 8)
    with pytest.raises(ValueError):  # the row map would read past a
        K.gemm_epilogue([(a, torch.zeros(3, 2), 1)], 8)
    with pytest.raises(ValueError, match="D <= 8"):  # 9 neighbour slots
        K.sem_graph(torch.zeros(17, 8), 2, torch.zeros(2, 17, 2),
                    torch.zeros(2, 17, 9, 2),
                    torch.zeros(2, 17, 9, dtype=torch.int32), torch.zeros(4),
                    torch.zeros(4))


def test_route_entry_points_reject_bad_inputs(level_weights, wide_weights):
    _, _, model = level_weights
    gab = model.layers_graph_conv[0]
    t = gab_tables(gab, model.statics)
    x = torch.zeros(2, 3, 17, 64)
    with pytest.raises(ValueError):  # 16 joints for a 17-joint block
        fused_gab_packed(x.reshape(2, 3, -1)[..., :16 * 64], t, 16)
    with pytest.raises(ValueError):  # not contiguous
        fused_gab_packed(torch.zeros(2, 3, 2 * 17 * 64)[..., ::2], t, 17)
    wide = wide_weights[2].layers_graph_conv[2]
    with pytest.raises(ValueError):  # C=512 is beyond the packed kernel
        fused_gab_packed(torch.zeros(1, 1, 17 * 512),
                         gab_tables(wide, model.statics), 17)
    with pytest.raises(ValueError):
        fused_local_branch(x[..., :32].contiguous(),
                           local_tables(gab.local_graph_layer, model.statics))
    with pytest.raises(ValueError):
        fused_global_attention(x.double(), global_tables(
            gab.global_graph_layer))
    head = gab.global_graph_layer.attentions[0]
    proj = head.concat_project[0].weight.reshape(-1, 1)
    p = torch.zeros(4, 17, 48)
    with pytest.raises(ValueError):  # proj vectors of the wrong length
        head_attention(p[..., :16], p[..., 16:32], p[..., 32:], proj, proj,
                       head.C_k)
    with pytest.raises(ValueError):  # rows that do not merge without a copy
        head_attention(*(p.transpose(0, 1)[..., s:s + 16]
                         for s in (0, 16, 32)),
                       proj[:16], proj[16:], head.C_k)
