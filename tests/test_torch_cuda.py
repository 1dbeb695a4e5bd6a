"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA device.

The file imports neither JAX nor gastx, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest`` (the suite's conftest configures JAX).

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|). Both sides
compute in float32; only the order of summation differs. At the precision
tiers both sides round the same operands to bf16 and sum exact products in
float32, so the same bound holds, except where an operand is itself
computed (joint_attention's softmax weights): see ``_attn_close``.
"""
import dataclasses

import pytest
import torch

from gastx_torch.models import (GastNet, GastNetConfig, config_for_frames,
                                randomize_eval_statistics)
from gastx_torch.models.init import init_gastnet
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.fused_gab import (
    fused_gab, fused_gab_packed, fused_gab_packed_plain, fused_gab_plain,
    fused_local_branch, fused_local_branch_plain, gab_tables, local_tables)
from gastx_torch.ops.cuda.fused_level import (fused_level, fused_level0,
                                              fused_level0_plain,
                                              fused_level_plain,
                                              level0_tables, level_tables)
from gastx_torch.ops.cuda.global_attn import (fused_global_attention,
                                              fused_global_attention_plain,
                                              global_tables)
from gastx_torch.ops.cuda.head_attn import (head_attention,
                                            head_attention_plain)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator().manual_seed(0)
    m = init_gastnet(GastNet(config_for_frames(27)), gen)
    return randomize_eval_statistics(m, gen).cuda().eval()


@pytest.mark.cuda
def test_cuda_conv_sites_refuse_tf32(monkeypatch):
    """The plain float32 convolutions (YOLO, HRNet) on the card refuse
    cuDNN's TF32, which PyTorch turns on by default, and run with it off;
    the card's HRNet then agrees with the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gastx_torch.pipeline.hrnet import PoseHighResolutionNet, hrnet_extra

    torch.manual_seed(0)
    net = PoseHighResolutionNet(hrnet_extra(8)).eval()
    x = torch.randn(1, 3, 64, 64)  # sides divisible by 32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        net.cuda()(x.cuda())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert not torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        got = net.cuda()(x.cuda()).cpu()
        want = net.cpu()(x)
    _assert_close(got, want)


def _randn(*shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).cuda()


def _assert_close(got, plain):
    torch.cuda.synchronize()
    assert got.shape == plain.shape
    bound = 1e-4 * max(1.0, plain.abs().max().item())
    err = (got - plain).abs().max().item()
    assert err <= bound, (err, bound)


def _taps(c, n, d, res):
    """A 3-tap dilated conv's row map over B=3 sequences of T_in=11 frames
    of J=17 joints, BN and ReLU, and the residual slice if ``res``."""
    b, t_in, j = 3, 11, 17
    t_out = t_in - 2 * d
    x = _randn(b * t_in * j, c, seed=1)
    w = _randn(3, c, n, seed=2)
    kw = dict(s_out=t_out * j, a_s_in=t_in * j, scale=_randn(n, seed=4),
              shift=_randn(n, seed=5), relu=True)
    if res:
        kw.update(res=_randn(b * t_in * j, n, seed=6), res_s_in=t_in * j,
                  res_off=d * j)
    return [(x, w[k].contiguous(), k * d * j) for k in range(3)], \
        b * t_out * j, kw


def _w_at_offset(k, n):
    """A (k, n) weight that starts 4 bytes past a 16-byte boundary."""
    w = torch.empty(k * n + 1, device="cuda")[1:].view(k, n)
    return w.copy_(_randn(k, n, seed=3))


def _one(m, k, n, **kw):
    """One piece (m, k) @ (k, n) with a BN epilogue."""
    return [(_randn(m, k, seed=1), _randn(k, n, seed=2) / k ** 0.5, 0)], m, \
        dict(scale=_randn(n, seed=4).abs() + 0.5, shift=_randn(n, seed=5),
             **kw)


def _three_pieces_offsets():
    """Three pieces read at row offsets 0, 17 and 34, the residual at 51."""
    m = 300
    return ([(_randn(m + 40, 128, seed=p), _randn(128, 256, seed=10 + p)
              / 384 ** 0.5, 17 * p) for p in range(3)], m,
            dict(scale=_randn(256, seed=4).abs() + 0.5,
                 shift=_randn(256, seed=5), relu=True,
                 res=_randn(m + 51, 256, seed=6), res_off=51))


# gemm_epilogue's ragged cases: (operands builder, instantiation it takes;
# "smallk": the wrapper launches gemm_smallk).
GEMM_CASES = {
    "k2_taps": (lambda: _taps(2, 128, 1, False), "smallk"),
    "k130_n70": (lambda: ([(_randn(517, 130, seed=1),
                            _randn(130, 70, seed=2), 0)], 517,
                          dict(scale=_randn(70, seed=4),
                               shift=_randn(70, seed=5), relu=True)),
                 "general"),
    "three_pieces": (lambda: ([(_randn(777, 128, seed=i),
                                _randn(128, 256, seed=10 + i), 0)
                               for i in range(3)], 777,
                              dict(scale=_randn(256, seed=4),
                                   shift=_randn(256, seed=5), relu=True)),
                     "vec16"),
    "taps_residual": (lambda: _taps(128, 128, 3, True), "vec16"),
    "taps_residual_ragged": (lambda: _taps(130, 70, 3, True), "general"),
    "m_below_tile": (lambda: ([(_randn(100, 64, seed=1),
                                _randn(64, 96, seed=2), 0)], 100, {}),
                     "vec16"),
    "w_offset": (lambda: ([(_randn(300, 128, seed=1), _w_at_offset(128, 64),
                            0)], 300, {}), "general"),
    # gemm_tc's wgmma instantiation: one push's rows, the narrow chain's
    # widths, K and N tails, more tiles than SMs, offsets and a residual.
    "m17_n1536": (lambda: _one(17, 512, 1536), "vec16"),
    "m153_n144": (lambda: _one(153, 48, 144, relu=True), "vec16"),
    "m459_n192": (lambda: _one(459, 64, 192, relu=True), "vec16"),
    "k132_n72": (lambda: _one(1000, 132, 72), "vec16"),
    "many_tiles": (lambda: _one(17000, 256, 512, relu=True), "vec16"),
    "three_pieces_offsets": (lambda: _three_pieces_offsets(), "vec16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_cuda_gemm_epilogue_matches_plain(model, case):
    """Ragged rows, columns and K, taps, pieces and a residual, each on the
    kernel and instantiation gemm_route names for it."""
    build, variant = GEMM_CASES[case]
    pieces, m, kw = build()
    kernel, routed = K.gemm_route(pieces, pieces[0][1].shape[1],
                                  kw.get("res"))
    assert routed == variant
    K.reset_launches()
    got = K.gemm_epilogue(pieces, m, **kw)
    _assert_launched(kernel, variant)
    _assert_close(got, K.gemm_epilogue_plain(pieces, m, **kw))


def _assert_launched(kernel, variant):
    """Since the last reset, ``kernel`` launched once, on ``variant``, and
    no other kernel with instantiations launched."""
    assert {k: K.LAUNCHES[k] for k in K.VARIANT_LAUNCHES} == {
        k: int(k == kernel) for k in K.VARIANT_LAUNCHES}, K.LAUNCHES
    assert K.VARIANT_LAUNCHES[kernel] == {
        v: int(v == variant) for v in K.VARIANT_LAUNCHES[kernel]}, \
        K.VARIANT_LAUNCHES


def _expand(frames, batch, n):
    """The level-0 expand conv of the ``frames`` model at ``batch``
    windows: three K = 2 taps (rows 8 bytes apart: a tap's first row lies
    off a 16-byte boundary), BN and ReLU."""
    j, t_out = 17, frames - 2
    x = _randn(batch * frames * j, 2, seed=40)
    w = _randn(3, 2, n, seed=41) / 6 ** 0.5
    return ([(x, w[k].contiguous(), k * j) for k in range(3)],
            batch * t_out * j,
            dict(s_out=t_out * j, a_s_in=frames * j,
                 scale=_randn(n, seed=42).abs() + 0.5,
                 shift=_randn(n, seed=43), relu=True))


def _a_at_offset(m, k):
    """An (m, k) A that starts 4 bytes past a 16-byte boundary."""
    a = torch.empty(m * k + 1, device="cuda")[1:].view(m, k)
    return a.copy_(_randn(m, k, seed=44))


# gemm_smallk's cases (its shape rule: float32, sum of K_p <= 16, N % 4):
# the three expand convs at small B, one push's rows, ragged M, N = 32 /
# 36 / 64 / 128 and a second column chunk (N = 1028), one to three pieces
# at row offsets, a residual at its own offset, no scale, ReLU off, A off a
# 16-byte boundary.
SMALLK_CASES = {
    "expand_27f": lambda: _expand(27, 8, 128),
    "expand_81f": lambda: _expand(81, 4, 64),
    "expand_243f": lambda: _expand(243, 2, 32),
    "push_27f_153_rows": lambda: _expand(11, 1, 128),
    "push_81f_459_rows": lambda: _expand(29, 1, 64),
    "ragged_n36_residual_no_scale": lambda: (
        [(_randn(1001, 5, seed=45), _randn(5, 36, seed=46), 0)], 1001,
        dict(res=_randn(1101, 36, seed=47), res_off=100)),
    "three_pieces_offsets_k16_relu_off": lambda: (
        [(_randn(700 + 40, k, seed=48 + k), _randn(k, 64, seed=50 + k),
          17 * p) for p, k in enumerate((4, 4, 8))], 700,
        dict(scale=_randn(64, seed=52), shift=_randn(64, seed=53),
             res=_randn(751, 64, seed=54), res_off=51)),
    "one_piece_n32_no_scale_relu": lambda: (
        [(_randn(4001, 3, seed=55), _randn(3, 32, seed=56), 0)], 4001,
        dict(relu=True)),
    "a_off_boundary_n128": lambda: (
        [(_a_at_offset(2000, 2), _randn(2, 128, seed=57), 0)], 2000, {}),
    "n1028_two_chunks": lambda: (
        [(_randn(300, 6, seed=58), _randn(6, 1028, seed=59), 0)], 300,
        dict(scale=_randn(1028, seed=60), shift=_randn(1028, seed=61),
             relu=True)),
}
SMALLK_TIERS = ("highest", "default", "kdefault", "high_lhs", "high_rhs",
                "high")


@pytest.mark.cuda
@pytest.mark.parametrize("tier", SMALLK_TIERS)
@pytest.mark.parametrize("case", sorted(SMALLK_CASES))
def test_cuda_gemm_smallk_matches_plain(model, case, tier):
    """gemm_smallk at "highest" and every tier against gemm_epilogue_plain
    at the same tier (both round the same operands and sum exact products
    in float32), each launch counted under its tier, no other GEMM
    launched."""
    pieces, m, kw = SMALLK_CASES[case]()
    n = pieces[0][1].shape[1]
    assert K.gemm_route(pieces, n, kw.get("res"), tier=tier) == (
        "gemm_smallk", "smallk")
    K.reset_launches()
    got = K.gemm_epilogue(pieces, m, tier=tier, **kw)
    label = "default" if tier == "kdefault" else tier
    assert K.TIER_LAUNCHES["gemm_smallk"] == {
        t: int(t == label) for t in K.ATTN_TIERS}
    _assert_launched("gemm_smallk", "smallk")
    _assert_close(got, K.gemm_epilogue_plain(pieces, m, tier=tier, **kw))


def _general_gemm_epilogue(pieces, m, kw):
    """gemm_epilogue's general (4-byte) instantiation on these operands,
    launched through its C function (the wrapper sends them to
    gemm_smallk)."""
    n = pieces[0][1].shape[1]
    out = torch.empty((m, n), device="cuda")
    s_out = kw.get("s_out", m)
    lib = K._lib("gemm_epilogue")
    code = lib.gemm_epilogue(
        *K._flat_pieces(pieces), len(pieces), m, n, s_out,
        kw.get("a_s_in", s_out), kw.get("res_s_in", s_out),
        K._ptr(kw.get("scale")), K._ptr(kw.get("shift")),
        int(kw.get("relu", False)), K._ptr(kw.get("res")),
        kw.get("res_off", 0), out.data_ptr(), K._stream(), 0, 0)
    assert code == 0, lib.error_string(code)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SMALLK_CASES))
def test_cuda_gemm_smallk_highest_is_bitwise_general(model, case):
    """At "highest" gemm_smallk is bitwise gemm_epilogue's general
    instantiation, which the float32 path launched on these operands
    before: one fmaf chain from 0 in the same order, the same epilogue."""
    pieces, m, kw = SMALLK_CASES[case]()
    got = K.gemm_epilogue(pieces, m, **kw)
    want = _general_gemm_epilogue(pieces, m, kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()


def _model(frames, num_joints=17):
    gen = torch.Generator().manual_seed(frames + num_joints)
    m = init_gastnet(GastNet(config_for_frames(frames, num_joints)), gen)
    return randomize_eval_statistics(m, gen).cuda().eval()


# The graph kernels' cases: (joints, GAB level of the 27-frame model (C =
# 128, 256, 512), extra row-stride columns of P, the instantiation taken).
# A row stride of 7C + 1 is not a multiple of 4: the 4-byte instantiation.
GRAPH_CASES = {
    "J=17, C=128": (17, 0, 0, "vec16"),
    "J=17, C=256": (17, 1, 0, "vec16"),
    "J=17, C=512": (17, 2, 0, "vec16"),
    "J=15, C=256": (15, 1, 0, "vec16"),
    "J=16, C=256": (16, 1, 0, "vec16"),
    "J=19, C=256": (19, 1, 0, "vec16"),
    "J=17, C=256, odd row stride": (17, 1, 1, "general"),
}
# Frame counts ragged against both kernels' frame tiles: 1 frame, a tile
# that is not full (sem_graph's tiles are 4 frames, joint_attention's 1 to
# 8), more tiles than the card has persistent blocks.
GRAPH_FRAMES = (1, 7, 1000, 4001)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_cuda_graph_kernels_match_plain(model, case):
    """sem_graph and joint_attention on column views of one projection
    output, at each of GRAPH_FRAMES, each launch on the instantiation
    graph_variant picks for it."""
    j, level, pad, variant = GRAPH_CASES[case]
    m = model if j == 17 else _model(27, j)
    t = gab_tables(m.layers_graph_conv[level], m.statics)
    c = t.w_proj.shape[0]
    ki = t.proj_t.numel()
    width = t.w_proj.shape[1]
    for frames in GRAPH_FRAMES:
        p = _randn(frames * j, width + pad, seed=7 + frames)[:, :width]
        args = (c, t.w_self, t.w_nbr, t.col, t.sem_scale, t.sem_shift)
        K.reset_launches()
        got = K.sem_graph(p, *args)
        _assert_launched("sem_graph", variant)
        _assert_close(got, K.sem_graph_plain(p, *args))
        views = (p[:, 4 * c:4 * c + ki], p[:, 4 * c + ki:4 * c + 2 * ki],
                 p[:, 4 * c + 2 * ki:], t.proj_t, t.proj_p, t.c_k)
        K.reset_launches()
        got = K.joint_attention(*views)
        _assert_launched("joint_attention", variant)
        _assert_close(got, K.joint_attention_plain(*views))


@pytest.mark.cuda
@pytest.mark.parametrize("channels,variant", [(128, "vec16"), (8, "general")],
                         ids=["C=256", "C=8"])
def test_cuda_head_attention_views_take_their_instantiation(model, channels,
                                                            variant):
    """head_attention's one-head views of a projection output: I = G = 64 at
    the 27-frame model's level 1 (C=256, 16-byte), I = G = 2 at the
    8-channel model's level 0 (C=8, 4-byte)."""
    gen = torch.Generator().manual_seed(channels)
    m = GastNet(dataclasses.replace(config_for_frames(27), channels=channels))
    m = randomize_eval_statistics(init_gastnet(m, gen), gen).cuda().eval()
    gt = global_tables(m.layers_graph_conv[1 if channels == 128 else 0]
                       .global_graph_layer)
    k, inter = gt.proj_t.shape
    g_ch = (gt.w_attn.shape[1] - 2 * k * inter) // k
    p = _randn(1001, 17, gt.w_attn.shape[1], seed=19)
    for h in range(k):
        g0 = 2 * k * inter + h * g_ch
        args = (p[..., h * inter:(h + 1) * inter],
                p[..., (k + h) * inter:(k + h + 1) * inter],
                p[..., g0:g0 + g_ch], gt.proj_t[h].reshape(-1, 1),
                gt.proj_p[h].reshape(-1, 1), gt.c_k[h])
        K.reset_launches()
        got = head_attention(*args)
        _assert_launched("joint_attention", variant)
        _assert_close(got, head_attention_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("level,frames", [(0, 25), (1, 19), (2, 1)])
def test_cuda_fused_gab_matches_plain(model, level, frames):
    t = gab_tables(model.layers_graph_conv[level], model.statics)
    x = _randn(16, frames, 17, t.w_proj.shape[0], seed=8)
    _assert_close(fused_gab(x, t), fused_gab_plain(x, t))


@pytest.mark.cuda
def test_cuda_fused_level0_matches_plain(model):
    l0 = level0_tables(model.init_bn, model.expand_conv, model.expand_bn)
    gt = gab_tables(model.layers_graph_conv[0], model.statics)
    x = _randn(16, 27, 17, 2, seed=9)
    _assert_close(fused_level0(x, l0, gt), fused_level0_plain(x, l0, gt))


@pytest.mark.cuda
def test_cuda_fused_level_matches_plain(model):
    lt = level_tables(*model.level_modules(1))
    gt = gab_tables(model.layers_graph_conv[1], model.statics)
    x = _randn(16, 25, 17, 256, seed=10)
    kw = dict(fw=3, dilation=3, res_off=3)
    _assert_close(fused_level(x, lt, gt, **kw),
                  fused_level_plain(x, lt, gt, **kw))


# What a forward of each shipped model launches: its levels are C = 128,
# 256, 512 (27f), 64 .. 512 (81f) and 32 .. 512 (243f), and only C < 128
# takes gab_narrow, under the entry point fused_gab_pbatch.
CHAIN = ("gemm_epilogue", "sem_graph", "joint_attention")
WIDE_ENTRIES = ("fused_level0", "fused_level", "fused_gab", "fused_gab_split")


@pytest.mark.cuda
def test_cuda_forward_runs_the_kernels_and_matches_reference(model):
    x = _randn(8, 40, 17, 2, seed=11)
    K.reset_launches()
    y = model(x)
    torch.cuda.synchronize()
    assert all(K.LAUNCHES[k] > 0 for k in CHAIN), K.LAUNCHES
    assert K.LAUNCHES["gab_narrow"] == 0, K.LAUNCHES
    # The level-0 expand conv (K = 2 taps) on gemm_smallk, nothing on the
    # general gemm_epilogue.
    assert K.TIER_LAUNCHES["gemm_smallk"]["highest"] == 1, K.TIER_LAUNCHES
    assert K.VARIANT_LAUNCHES["gemm_epilogue"]["general"] == 0
    assert all(K.ENTRY_LAUNCHES[k] > 0 for k in WIDE_ENTRIES), \
        K.ENTRY_LAUNCHES
    assert K.ENTRY_LAUNCHES["fused_gab_pbatch"] == 0, K.ENTRY_LAUNCHES
    _assert_close(y, model.reference_forward(x))


# Frame counts that meet gab_narrow's tile edges at every tested width and
# layout: one frame, a tile that is not full (7 frames; a tile is 3 to 17
# frames, 64 to 256 rows by width), more tiles than the card has
# persistent blocks (4001 frames: 236 to 1334 tiles), each with a ragged
# last tile.
NARROW_FRAMES = (1, 7, 1000, 4001)


@pytest.mark.cuda
@pytest.mark.parametrize("num_joints", [15, 16, 17, 19])
def test_cuda_gab_narrow_matches_plain(model, num_joints):
    """C=32 and C=64 (the 243-frame model's levels 0-1) on every layout, at
    each of NARROW_FRAMES."""
    m = _model(243, num_joints)
    for level in (0, 1):
        t = gab_tables(m.layers_graph_conv[level], m.statics)
        c = t.w_proj.shape[0]
        for frames in NARROW_FRAMES:
            x = _randn(frames * num_joints, c, seed=12 + frames)
            _assert_close(K.gab_narrow(x, t), K.gab_narrow_plain(x, t))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [16, 48])
def test_cuda_gab_narrow_other_widths(model, channels):
    """Narrow widths no shipped model has: C = 16, 32 and 48, 96 (the
    tiles of 256, 128 and 64 rows), at each of NARROW_FRAMES."""
    gen = torch.Generator().manual_seed(channels)
    m = GastNet(GastNetConfig(filter_widths=(3, 3), channels=channels))
    m = randomize_eval_statistics(init_gastnet(m, gen), gen).cuda().eval()
    for level in (0, 1):
        t = gab_tables(m.layers_graph_conv[level], m.statics)
        c = t.w_proj.shape[0]
        for frames in NARROW_FRAMES:
            x = _randn(frames * 17, c, seed=frames + c)
            _assert_close(K.gab_narrow(x, t), K.gab_narrow_plain(x, t))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [8, 24])
@pytest.mark.parametrize("route", [
    {"gab_impl": "auto"}, {"gab_impl": "pallas"},
    {"gab_impl": "pallas", "packed_channels": 64}],
    ids=["auto", "pallas", "packed"])
def test_cuda_odd_width_forward_routes_and_matches_reference(model, channels,
                                                            route):
    """Models whose first GAB (C = 8, 24) is off gab_narrow's shape rule:
    that level takes the chain, the others the kernel gab_route picks, on
    every route that reaches fused_gab."""
    gen = torch.Generator().manual_seed(channels)
    m = GastNet(GastNetConfig(filter_widths=(3, 3, 3), channels=channels,
                              **route))
    m = randomize_eval_statistics(init_gastnet(m, gen), gen).cuda().eval()
    routes = [K.gab_route(*K.gab_shape(gab_tables(g, m.statics)))
              for g in m.layers_graph_conv]
    assert routes[0] == "chain"
    narrow, chained = routes.count("gab_narrow"), routes.count("chain")
    x = _randn(2, 33, 17, 2, seed=18)
    K.reset_launches()
    y = m(x)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gab_narrow"] == narrow, K.LAUNCHES
    assert K.LAUNCHES["sem_graph"] == chained, K.LAUNCHES
    assert K.LAUNCHES["joint_attention"] == chained, K.LAUNCHES
    # Every GAB here is narrow by width: one launch each on gab_narrow, the
    # chain's six otherwise, under fused_gab_pbatch or fused_gab_packed.
    assert (K.ENTRY_LAUNCHES["fused_gab_pbatch"]
            + K.ENTRY_LAUNCHES["fused_gab_packed"]) == narrow + 6 * chained
    assert K.ENTRY_LAUNCHES["fused_gab_packed"] == (
        0 if "packed_channels" not in route
        else sum(1 if r == "gab_narrow" else 6
                 for r, g in zip(routes, m.layers_graph_conv)
                 if g.cat_conv.weight.shape[1] // 3 <= 64))
    _assert_close(y, m.reference_forward(x))


@pytest.mark.cuda
@pytest.mark.parametrize("level,frames", [(0, 25), (2, 1)])
def test_cuda_branch_entry_points_match_plain(model, level, frames):
    """fused_local_branch and fused_global_attention at C=128 and C=512,
    and head_attention on every head of that block."""
    gab = model.layers_graph_conv[level]
    lt = local_tables(gab.local_graph_layer, model.statics)
    gt = global_tables(gab.global_graph_layer)
    x = _randn(16, frames, 17, lt.w_sem.shape[0], seed=14)
    _assert_close(fused_local_branch(x, lt), fused_local_branch_plain(x, lt))
    _assert_close(fused_global_attention(x, gt),
                  fused_global_attention_plain(x, gt))
    k, inter = gt.proj_t.shape
    p = _randn(16 * frames, 17, gt.w_attn.shape[1], seed=15)
    for h in range(k):
        args = (p[..., h * inter:(h + 1) * inter],
                p[..., (k + h) * inter:(k + h + 1) * inter],
                p[..., (2 * k + h) * inter:(2 * k + h + 1) * inter],
                gt.proj_t[h].reshape(-1, 1), gt.proj_p[h].reshape(-1, 1),
                gt.c_k[h])
        _assert_close(head_attention(*args), head_attention_plain(*args))


@pytest.mark.cuda
def test_cuda_fused_gab_packed_matches_plain(model):
    m = _model(243)
    for level, frames in ((0, 241), (1, 235)):
        t = gab_tables(m.layers_graph_conv[level], m.statics)
        x = _randn(3, frames, 17 * t.w_proj.shape[0], seed=16 + level)
        _assert_close(fused_gab_packed(x, t, 17),
                      fused_gab_packed_plain(x, t, 17))


# What one forward of each other route launches (PERF.md): kernel launches
# by kernel, then by entry point; every counter not listed stays 0.
ROUTE_LAUNCHES = {
    "27f hybrid": (27, {"gab_impl": "pallas_local",
                        "attn_impl": "pallas_head"},
                   {"gemm_epilogue": 6, "sem_graph": 3,
                    "joint_attention": 12},
                   {"fused_local_branch": 9, "head_attention": 12}),
    "27f xla head": (27, {"gab_impl": "xla", "attn_impl": "pallas_head"},
                     {"joint_attention": 12}, {"head_attention": 12}),
    "243f packed": (243, {"gab_impl": "pallas", "packed_channels": 64},
                    {"gemm_epilogue": 12, "sem_graph": 3,
                     "joint_attention": 3, "gab_narrow": 2},
                    {"fused_gab_packed": 2, "fused_gab": 12,
                     "fused_gab_split": 6}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(ROUTE_LAUNCHES))
def test_cuda_route_forward_launches_and_matches_reference(model, cell):
    frames, route, kernels, entries = ROUTE_LAUNCHES[cell]
    gen = torch.Generator().manual_seed(frames)
    m = GastNet(dataclasses.replace(config_for_frames(frames), **route))
    m = randomize_eval_statistics(init_gastnet(m, gen), gen).cuda().eval()
    x = _randn(2, frames + 6, 17, 2, seed=17)
    K.reset_launches()
    y = m(x)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {k: kernels.get(k, 0) for k in K.LAUNCHES}, \
        K.LAUNCHES
    assert K.ENTRY_LAUNCHES == {k: entries.get(k, 0)
                                for k in K.ENTRY_LAUNCHES}, K.ENTRY_LAUNCHES
    _assert_close(y, m.reference_forward(x))


@pytest.mark.cuda
@pytest.mark.parametrize("frames,batch", [(81, 4), (243, 2)])
def test_cuda_narrow_forward_launches_gab_narrow(model, frames, batch):
    m = _model(frames)
    x = _randn(batch, frames + 6, 17, 2, seed=13)
    K.reset_launches()
    y = m(x)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gab_narrow"] == {81: 1, 243: 2}[frames], K.LAUNCHES
    assert K.ENTRY_LAUNCHES["fused_gab_pbatch"] == K.LAUNCHES["gab_narrow"]
    assert all(K.LAUNCHES[k] > 0 for k in CHAIN), K.LAUNCHES
    _assert_close(y, m.reference_forward(x))


def _variant_model(frames, num_joints=17, **fields):
    cfg = dataclasses.replace(config_for_frames(frames, num_joints), **fields)
    gen = torch.Generator().manual_seed(frames + num_joints + 1)
    m = init_gastnet(GastNet(cfg), gen)
    return randomize_eval_statistics(m, gen).cuda().eval()


def _gab_launches(m):
    """What a forward's GABs launch outside the level kernels, by kernel:
    per GAB one gab_narrow, or the chain's 4 GEMMs, sem_graph and
    joint_attention, as gab_route sends it (float32: no gemm_tc; an eval
    forward: no gemm_wgrad)."""
    routes = [K.gab_route(*K.gab_shape(gab_tables(g, m.statics)))
              for g in m.layers_graph_conv]
    chain = routes.count("chain")
    return {"gemm_epilogue": 4 * chain, "sem_graph": chain,
            "joint_attention": chain, "gab_narrow": routes.count("gab_narrow"),
            "gemm_tc": 0, "gemm_smallk": 0, "gemm_wgrad": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("frames,causal,windows", [
    (27, False, 1), (27, True, 2), (81, True, 1), (243, False, 1)])
def test_cuda_strided_forward_launches_and_matches_reference(model, frames,
                                                             causal, windows):
    """The strided forward on windows of rf frames (and 2 rf): every GAB on
    fused_gab's kernels, no level kernel, as the JAX gates have it."""
    m = _variant_model(frames, causal=causal)
    x = _randn(3, windows * frames, 17, 2, seed=20)
    K.reset_launches()
    y = m(x, variant="strided")
    torch.cuda.synchronize()
    assert K.LAUNCHES == _gab_launches(m), K.LAUNCHES
    assert K.ENTRY_LAUNCHES["fused_level0"] == 0
    assert K.ENTRY_LAUNCHES["fused_level"] == 0
    assert y.shape == (3, windows, 17, 3)
    _assert_close(y, m.reference_forward(x, variant="strided"))


@pytest.mark.cuda
def test_cuda_dense_forward_launches_and_matches_reference(model):
    m = _variant_model(27, dense=True)
    x = _randn(3, 31, 17, 2, seed=21)
    K.reset_launches()
    y = m(x)
    torch.cuda.synchronize()
    assert K.LAUNCHES == _gab_launches(m), K.LAUNCHES
    _assert_close(y, m.reference_forward(x))


@pytest.mark.cuda
@pytest.mark.parametrize("frames,num_joints", [(27, 15), (27, 16), (27, 19),
                                               (243, 19)])
def test_cuda_layout_forward_matches_reference(model, frames, num_joints):
    """The dilated "auto" forward on the other layouts: the level kernels,
    each GAB on the kernels gab_route picks."""
    m = _variant_model(frames, num_joints)
    x = _randn(2, frames + 4, num_joints, 2, seed=22)
    K.reset_launches()
    y = m(x)
    torch.cuda.synchronize()
    want = _gab_launches(m)
    assert K.ENTRY_LAUNCHES["fused_level0"] > 0
    assert K.ENTRY_LAUNCHES["fused_level"] > 0
    for k in ("sem_graph", "joint_attention", "gab_narrow"):
        assert K.LAUNCHES[k] == want[k], K.LAUNCHES
    _assert_close(y, m.reference_forward(x))


@pytest.mark.cuda
@pytest.mark.parametrize("frames,persons", [(27, 1), (81, 3)])
def test_cuda_streaming_matches_offline_windows(model, frames, persons):
    """StreamingLifter on the card against the edge-padded windows lifted
    offline by the plain strided forward, 12 pushes."""
    import numpy as np

    from gastx_torch.infer import StreamingLifter

    m = _variant_model(frames, causal=True)
    rf = m.cfg.receptive_field()
    seq = _randn(12, persons, 17, 2, seed=23).mul_(0.3).cpu().numpy()
    lifter = StreamingLifter(m, num_person=persons)
    K.reset_launches()
    handle = lifter.push_async(seq[0])
    assert handle.is_cuda
    assert K.LAUNCHES == _gab_launches(m), K.LAUNCHES
    lifter.reset()
    streamed = np.stack([lifter.push(f) for f in seq])
    padded = np.concatenate([np.repeat(seq[:1], rf - 1, axis=0), seq])
    for i in range(len(seq)):
        w = torch.from_numpy(np.ascontiguousarray(
            padded[i:i + rf].transpose(1, 0, 2, 3))).cuda()
        _assert_close(torch.from_numpy(streamed[i]).cuda(),
                      m.reference_forward(w, variant="strided")[:, 0])


# One streaming push's GABs at M = 1: (receptive field, GAB level, frames):
# 153, 51 and 17 rows at C = 128, 256, 512, and 81f's 459 rows at C = 64.
STREAM_GABS = ((27, 0, 9), (27, 1, 3), (27, 2, 1), (81, 0, 27))


@pytest.mark.cuda
@pytest.mark.parametrize("frames,level,gab_frames", STREAM_GABS)
def test_cuda_kernels_at_streaming_rows(model, frames, level, gab_frames):
    """Every kernel launch of the GAB at the rows one push gives it, each on
    the instantiation its variant function picks, and the GAB's output."""
    m = model if frames == 27 else _model(frames)
    t = gab_tables(m.layers_graph_conv[level], m.statics)
    c = t.w_proj.shape[0]
    x = _randn(gab_frames * 17, c, seed=24)

    def held(name, fn, plain, variant_of):
        def run(*args, **kw):
            K.reset_launches()
            got = fn(*args, **kw)
            _assert_launched(name, variant_of(*args, **kw))
            _assert_close(got, plain(*args, **kw))
            return got
        return run

    plain = K.gab_chain(x, t, K.gemm_epilogue_plain, K.sem_graph_plain,
                        K.joint_attention_plain)
    if K.gab_route(*K.gab_shape(t)) == "gab_narrow":
        K.reset_launches()
        got = K.gab_narrow(x, t)
        assert K.LAUNCHES["gab_narrow"] == 1
    else:
        got = K.gab_chain(
            x, t,
            held("gemm_epilogue", K.gemm_epilogue, K.gemm_epilogue_plain,
                 lambda p, m_, **kw: K.gemm_variant(p, p[0][1].shape[1],
                                                    kw.get("res"))),
            held("sem_graph", K.sem_graph, K.sem_graph_plain,
                 lambda p, c_, *_: K.graph_variant((p,), (c_,))),
            held("joint_attention", K.joint_attention,
                 K.joint_attention_plain,
                 lambda th, ph, g, pt, *_: K.graph_variant(
                     (th, ph, g), (pt.shape[1], g.shape[1] // pt.shape[0]))))
    _assert_close(got, plain)


# -- training ----------------------------------------------------------------

def _train_batch(frames, batch, seed, device, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    x2 = torch.randn((batch, frames, 17, 2), generator=gen)
    x3 = 0.3 * torch.randn((batch, 1, 17, 3), generator=gen)
    return (x2.to(device, dtype), x3.to(device, dtype),
            torch.ones(batch, device=device, dtype=dtype))


def _one_train_step(base, dtype, device):
    import copy

    from gastx_torch.train import make_optimizer, train_step

    m = copy.deepcopy(base).to(dtype=dtype, device=device)
    opt = make_optimizer(m.parameters())
    loss = train_step(m, opt, *_train_batch(27, 4, 30, device, dtype), 1e-3,
                      None, "strided")
    return loss, m


def _close_per_tensor(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    bound = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= bound


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu_step(model):
    """One strided step of the 27f model (dropout 0) on the card against
    the CPU from the same weights and batch. In float64 the whole step:
    the loss, every gradient, every parameter after the amsgrad step and
    the BN running statistics. In float32 the loss and the BN statistics:
    its gradients differ where a ReLU input lies within rounding of zero
    (chip_smoke.py's STEP_CHECK_DTYPES note)."""
    import dataclasses

    base = GastNet(dataclasses.replace(config_for_frames(27), dropout=0.0))
    gen = torch.Generator().manual_seed(31)
    randomize_eval_statistics(init_gastnet(base, gen), gen)
    for dtype in (torch.float64, torch.float32):
        loss_c, cpu = _one_train_step(base, dtype, "cpu")
        loss_g, card = _one_train_step(base, dtype, "cuda")
        _close_per_tensor(loss_g, loss_c)
        for (n, b), (_, bc) in zip(card.named_buffers(),
                                   cpu.named_buffers()):
            if "running" in n:
                _close_per_tensor(b, bc)
        if dtype is torch.float64:
            for (n, p), (_, pc) in zip(card.named_parameters(),
                                       cpu.named_parameters()):
                _close_per_tensor(p.grad, pc.grad)
                _close_per_tensor(p, pc)


@pytest.mark.cuda
def test_cuda_train_step_launches_no_kernel(model):
    """A train step (dropout 0.05) runs the plain ops alone: every launch
    counter stays 0, and the loss is finite."""
    import dataclasses

    from gastx_torch.models import build_gastnet
    from gastx_torch.train import make_optimizer, train_step

    m = build_gastnet(dataclasses.replace(config_for_frames(27),
                                          dropout=0.05), device="cuda")
    opt = make_optimizer(m.parameters())
    K.reset_launches()
    loss = train_step(m, opt, *_train_batch(27, 8, 32, "cuda"), 1e-3,
                      torch.Generator(device="cuda").manual_seed(0),
                      "strided")
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert all(v == 0 for v in K.LAUNCHES.values()), K.LAUNCHES
    assert all(v == 0 for v in K.ENTRY_LAUNCHES.values()), K.ENTRY_LAUNCHES


@pytest.mark.cuda
def test_cuda_run_evaluation_runs_the_kernels(model, tmp_path):
    """run_evaluation on the card launches the level kernels and agrees
    with the same evaluation on the CPU (P1, P2 in mm, to 2e-2 mm)."""
    import copy

    import numpy as np

    from gastx_torch.data.harness import group_actions_by_name, load_data
    from gastx_torch.eval import run_evaluation

    rng = np.random.default_rng(0)
    subjects = ["S1", "S9", "S11"]
    p3 = {s: {"Walking 1": rng.standard_normal((60, 32, 3)).astype(
        np.float32)} for s in subjects}
    p2 = {s: {"Walking 1": [(rng.random((60, 17, 2)) * 1000).astype(
        np.float32) for _ in range(4)]} for s in subjects}
    np.savez_compressed(tmp_path / "data_3d_h36m.npz", positions_3d=p3)
    meta = {"layout_name": "h36m", "num_joints": 17,
            "keypoints_symmetry": [[4, 5, 6, 11, 12, 13],
                                   [1, 2, 3, 14, 15, 16]]}
    np.savez_compressed(tmp_path / "data_2d_h36m_cpn_ft_h36m_dbb.npz",
                        positions_2d=p2, metadata=meta)
    kps, ds, _, kl, kr, _, _ = load_data("h36m", "cpn_ft_h36m_dbb",
                                         str(tmp_path))
    actions = group_actions_by_name(ds, ["S9", "S11"])[0]
    kw = dict(downsample=1, kps_lr=(kl, kr), log=lambda *_: None)
    cpu = copy.deepcopy(model).cpu()
    K.reset_launches()
    got = run_evaluation(model, actions, ds, kps, **kw)
    for name in ("fused_level0", "fused_level", "fused_gab_split"):
        assert K.ENTRY_LAUNCHES[name] > 0, K.ENTRY_LAUNCHES
    want = run_evaluation(cpu, actions, ds, kps, **kw)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-4)


# ---- the precision tiers ---------------------------------------------------
TC_TIERS = ("default", "kdefault", "high_lhs", "high_rhs", "high")


@pytest.mark.cuda
@pytest.mark.parametrize("tier", TC_TIERS)
@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_cuda_gemm_tc_matches_plain(model, case, tier):
    """gemm_epilogue at a tier below "highest" launches the kernel
    gemm_route names, gemm_tc (or gemm_smallk, for the K = 2 taps; never
    the float32 kernel: no fallback), on its instantiation and the tier's
    own, and agrees with its plain
    version: both round the same operands, the tensor cores sum the exact
    bf16 products in float32, so the float32 bound holds."""
    build, _ = GEMM_CASES[case]
    pieces, m, kw = build()
    kw["tier"] = tier
    n = pieces[0][1].shape[1]
    kernel, variant = K.gemm_route(pieces, n, kw.get("res"), tier=tier)
    assert kernel in ("gemm_tc", "gemm_smallk")
    K.reset_launches()
    got = K.gemm_epilogue(pieces, m, **kw)
    _assert_launched(kernel, variant)
    want = "default" if tier == "kdefault" else tier
    for name in ("gemm_tc", "gemm_smallk"):
        assert K.TIER_LAUNCHES[name] == {
            t: int(name == kernel and t == want)
            for t in K.TIER_LAUNCHES[name]}
    _assert_close(got, K.gemm_epilogue_plain(pieces, m, **kw))


def _attn_close(got, plain, plain_f32, noise, g, c_k, apply_tier):
    """A tiered joint_attention against its plain version: the float32
    bound, plus one bf16 ulp (2^-7 |w|; 2^-14 where the lhs keeps 16 bits)
    of any attention weight, which the two sides' float32 softmaxes may
    round to neighbouring bf16 values; and, in root-mean-square, half as
    far from its plain version as from the float32 output, which a kernel
    skipping the rounding would not meet, wherever the tier moves the
    plain output by more than twice the float32 kernel's own distance
    ``noise`` from its plain version."""
    torch.cuda.synchronize()
    flip = {"highest": 0.0, "high_lhs": 2.0 ** -14,
            "high": 2.0 ** -14}.get(apply_tier, 2.0 ** -7)
    bound = (1e-4 * max(1.0, plain.abs().max().item()) + flip
             * g.abs().max().item() * (1 + c_k.abs().sum(-1).max().item()))
    assert (got - plain).abs().max().item() <= bound
    if (plain - plain_f32).pow(2).mean().sqrt().item() <= 2 * noise:
        return
    rms = (got - plain).pow(2).mean().sqrt().item()
    rms_f32 = (got - plain_f32).pow(2).mean().sqrt().item()
    assert rms <= 0.5 * rms_f32, (rms, rms_f32)


ATTN_TIERS = ("highest", "default", "high_lhs", "high_rhs", "high")


@pytest.mark.cuda
@pytest.mark.parametrize("apply_tier", ATTN_TIERS)
@pytest.mark.parametrize("level", (0, 1))
def test_cuda_joint_attention_tiers_match_plain(model, level, apply_tier):
    """joint_attention with its score and apply dots at every pair of
    tiers (the apply tier "high" is its second instantiation), 16-byte
    views and a 4-byte one, each launch counted under its pair."""
    t = gab_tables(model.layers_graph_conv[level], model.statics)
    c, ki, width = t.w_proj.shape[0], t.proj_t.numel(), t.w_proj.shape[1]
    for pad, variant in ((0, "vec16"), (1, "general")):
        p = _randn(301 * 17, width + pad, seed=9 + pad)[:, :width]
        views = (p[:, 4 * c:4 * c + ki], p[:, 4 * c + ki:4 * c + 2 * ki],
                 p[:, 4 * c + 2 * ki:], t.proj_t, t.proj_p, t.c_k)
        f32 = K.joint_attention_plain(*views)
        noise = (K.joint_attention(*views) - f32).pow(2).mean().sqrt().item()
        for score_tier in ATTN_TIERS:
            kw = dict(score_tier=score_tier, apply_tier=apply_tier)
            K.reset_launches()
            got = K.joint_attention(*views, **kw)
            _assert_launched("joint_attention", variant)
            pair = f"{score_tier}/{apply_tier}"
            assert K.TIER_LAUNCHES["joint_attention"] == (
                {} if pair == "highest/highest" else {pair: 1})
            plain = (f32 if pair == "highest/highest"
                     else K.joint_attention_plain(*views, **kw))
            _attn_close(got, plain, f32, noise, views[2], t.c_k,
                        apply_tier)


# joint_attention's shipped pairs (the instantiations of their own) at the
# shapes the routes hand it: case -> (J, K, I, G, frames, the pairs). The
# 15/16/19-joint layouts and J = 32 (one and two k16 steps); a ragged last
# tile (1023 frames in tiles of 2); I = 1 with unit score vectors, the fold
# form's columns, at its own pairs too (score "highest": the chain's fold
# GAB) on the 4-byte view; K = 1 through head_attention.
SHIPPED_PAIRS = ("default/default", "high/high")
SHIPPED_ATTN_CASES = {
    "J15": (15, 4, 16, 16, 301, SHIPPED_PAIRS),
    "J16": (16, 4, 16, 16, 301, SHIPPED_PAIRS),
    "J19": (19, 4, 16, 16, 301, SHIPPED_PAIRS),
    "J32": (32, 4, 16, 16, 129, SHIPPED_PAIRS),
    "ragged tile": (17, 4, 64, 64, 1023, SHIPPED_PAIRS),
    "fold I=1": (17, 4, 1, 64, 301, SHIPPED_PAIRS + ("highest/default",
                                                      "highest/high")),
    "K=1": (17, 1, 64, 64, 257, SHIPPED_PAIRS),
}


def _attn_operands(j, k, inter, g_ch, frames, seed, unit=False):
    """joint_attention's arguments on one random projection output (row
    stride 2KI + KG), random score vectors (ones with ``unit``) and C_k."""
    p = _randn(frames * j, 2 * k * inter + k * g_ch, seed=seed)
    ki = k * inter
    pt, pp = (torch.ones(k, inter, device="cuda") if unit else
              _randn(k, inter, seed=seed + i) for i in (1, 2))
    return (p[:, :ki], p[:, ki:2 * ki], p[:, 2 * ki:], pt, pp,
            0.1 * _randn(k, j, j, seed=seed + 3))


@pytest.mark.cuda
@pytest.mark.parametrize("case,pair", [
    (case, pair) for case in sorted(SHIPPED_ATTN_CASES)
    for pair in SHIPPED_ATTN_CASES[case][-1]])
def test_cuda_joint_attention_shipped_pairs_at_route_shapes(model, case,
                                                            pair):
    """A tier pair of the shipped routes on joint_attention at a shape a
    route hands it: one launch, counted under its pair, on the alignment
    instantiation graph_variant picks, within _attn_close of its plain
    version."""
    j, k, inter, g_ch, frames, _ = SHIPPED_ATTN_CASES[case]
    st, at = pair.split("/")
    kw = dict(score_tier=st, apply_tier=at)
    args = _attn_operands(j, k, inter, g_ch, frames, seed=len(case),
                          unit=inter == 1)
    f32 = K.joint_attention_plain(*args)
    noise = (K.joint_attention(*args) - f32).pow(2).mean().sqrt().item()
    K.reset_launches()
    if k == 1:
        m3 = [a.reshape(frames, j, -1) for a in args[:3]]
        head = (*m3, args[3].reshape(-1, 1), args[4].reshape(-1, 1),
                args[5][0])
        got = head_attention(*head, **kw).reshape(frames * j, g_ch)
    else:
        got = K.joint_attention(*args, **kw)
    _assert_launched("joint_attention",
                     K.graph_variant(args[:3], (inter, g_ch)))
    assert K.TIER_LAUNCHES["joint_attention"] == {pair: 1}
    _attn_close(got, K.joint_attention_plain(*args, **kw), f32, noise,
                args[2], args[5], at)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", SHIPPED_PAIRS)
def test_cuda_joint_attention_shipped_pairs_at_27f_l1(model, pair):
    """The shipped pairs at the 27f model's level-1 GAB (C=256: K=4,
    I=G=64, J=17; tiles of two frames) on its own tables, B=64 windows of
    its 19 frames, on the 16-byte instantiation."""
    t = gab_tables(model.layers_graph_conv[1], model.statics)
    c, ki = t.w_proj.shape[0], t.proj_t.numel()
    p = _randn(64 * 19 * 17, t.w_proj.shape[1], seed=12)
    args = (p[:, 4 * c:4 * c + ki], p[:, 4 * c + ki:4 * c + 2 * ki],
            p[:, 4 * c + 2 * ki:], t.proj_t, t.proj_p, t.c_k)
    st, at = pair.split("/")
    kw = dict(score_tier=st, apply_tier=at)
    f32 = K.joint_attention_plain(*args)
    noise = (K.joint_attention(*args) - f32).pow(2).mean().sqrt().item()
    K.reset_launches()
    got = K.joint_attention(*args, **kw)
    _assert_launched("joint_attention", "vec16")
    assert K.TIER_LAUNCHES["joint_attention"] == {pair: 1}
    _attn_close(got, K.joint_attention_plain(*args, **kw), f32, noise,
                args[2], t.c_k, at)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", (27, 243))
def test_cuda_tiered_forward_matches_plain_route(model, frames):
    """The JAX preset on the card: every GEMM on gemm_tc (no float32
    gemm_epilogue launch), the attention at its tiers, within the float32
    bound of the same route and tiers through the plain versions, and
    within the cert's 0.1 mm of the float32 forward."""
    from gastx_torch.models import build_gastnet
    from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES

    m = build_gastnet(config_for_frames(frames, dropout=0.0), seed=frames,
                      device="cuda")
    x = _randn(4, frames, 17, 2, seed=frames)
    f32 = m(x)
    m.cfg = config_for_frames(
        frames, dropout=0.0, matmul_precision="high",
        precision_overrides=TPU_MIXED_PRECISION_OVERRIDES)
    K.reset_launches()
    got = m(x)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gemm_tc"] > 0 and K.LAUNCHES["gemm_epilogue"] == 0
    # The level-0 expand conv on gemm_smallk, the shrink (N = 3, a plain
    # site) alone on the general gemm_tc.
    assert K.LAUNCHES["gemm_smallk"] == 1
    assert K.VARIANT_LAUNCHES["gemm_tc"]["general"] == 1
    assert K.TIER_LAUNCHES["joint_attention"].get("default/default")
    _assert_close(got, m.plain_route_forward(x))
    assert (got - f32).abs().max().item() <= 1e-4


def _bf16_pieces(n_pieces, k, n, m, seed):
    """``n_pieces`` A pieces of (m, k), the first bf16 (the block concat's
    x under bf16 storage), W float32."""
    pieces = []
    for p in range(n_pieces):
        a = _randn(m, k, seed=seed + p)
        pieces.append((a.to(torch.bfloat16) if p == 0 else a,
                       _randn(k, n, seed=seed + 10 + p) / k ** 0.5, 0))
    return pieces


def _assert_bf16_close(got, plain):
    """A bf16 output within one bf16 step (2^-7 of the value) of its plain
    version plus the float32 bound: both round float32 sums that differ
    only in order."""
    torch.cuda.synchronize()
    assert got.dtype == plain.dtype and got.shape == plain.shape
    g, p = got.float(), plain.float()
    slack = 1e-4 * max(1.0, p.abs().max().item())
    assert ((g - p).abs() - 2.0 ** -7 * p.abs()).max().item() <= slack


# (K of each piece, N) of the bf16-I/O GEMM cases: the 27f level-0 block
# concat (C = 128; its id "vec16" as before), the 243f (C = 32, N = 64)
# and 81f (C = 64, N = 128) GAB-0 block concats, K padded within a slab
# with an N tail, all on gemm_tc's vec16_bf16; K = 130 / N = 70 and a
# bf16 piece of K = 132 (K % 8 = 4) on its general instantiation.
BF16_GEMM_SHAPES = {"vec16": (128, 256), "n64": (32, 64), "n128": (64, 128),
                    "k40_n72": (40, 72), "ragged": (130, 70),
                    "k132": (132, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ("highest",) + K.TC_TIERS)
@pytest.mark.parametrize("shape", sorted(BF16_GEMM_SHAPES))
def test_cuda_bf16_io_gemm_matches_plain(model, tier, shape, monkeypatch):
    """``gemm_epilogue`` (and ``gemm_tc`` below ``"highest"``, on the
    instantiation tc_variant picks: vec16_bf16 where every bf16 K_p is a
    multiple of 8 and N of 8, else general) with a bf16 A piece, a bf16
    residual and a bf16 output, then a float32 one, counted under its I/O
    dtypes. The plain version's bf16 products sum in float32."""
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    k, n = BF16_GEMM_SHAPES[shape]
    m = 4001
    pieces = _bf16_pieces(3, k, n, m, seed=500)
    kw = dict(scale=_randn(n, seed=1).abs() + 0.5, shift=_randn(n, seed=2),
              relu=True, res=_randn(m, n, seed=3).to(torch.bfloat16),
              tier=tier, out_dtype=torch.bfloat16)
    kernel = "gemm_epilogue" if tier == "highest" else "gemm_tc"
    for out_dtype, io in ((torch.bfloat16, "bf16_io"),
                          (torch.float32, "bf16_in")):
        kw["out_dtype"] = out_dtype
        K.reset_launches()
        got = K.gemm_epilogue(pieces, m, **kw)
        assert K.DTYPE_LAUNCHES[kernel][io] == 1
        if tier != "highest":
            want = K.tc_variant(pieces, n, kw["res"], out_dtype)
            assert want == ("general" if shape in ("ragged", "k132")
                            else "vec16_bf16")
            _assert_launched("gemm_tc", want)
        plain = K.gemm_epilogue_plain(pieces, m, **kw)
        if out_dtype == torch.bfloat16:
            _assert_bf16_close(got, plain)
        else:
            _assert_close(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", K.TC_TIERS)
@pytest.mark.parametrize("c", (128, 40))
def test_cuda_bf16_io_gemm_taps_matches_plain(model, tier, c, monkeypatch):
    """The dilated conv's three taps on one bf16 input with a bf16
    residual (``"pallas_level"`` on bf16; A by 16-byte row gathers into
    the bf16 slabs) on vec16_bf16, to a float32 and to a bf16 output."""
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    b, t_in, j, d, n = 3, 31, 17, 3, 128
    t_out = t_in - 2 * d
    x = _randn(b * t_in * j, c, seed=600).to(torch.bfloat16)
    pieces = [(x, _randn(c, n, seed=601 + p) / (3 * c) ** 0.5, p * d * j)
              for p in range(3)]
    m = b * t_out * j
    kw = dict(s_out=t_out * j, a_s_in=t_in * j,
              scale=_randn(n, seed=604).abs() + 0.5,
              shift=_randn(n, seed=605), relu=True,
              res=_randn(b * t_in * j, n, seed=606).to(torch.bfloat16),
              res_s_in=t_in * j, res_off=d * j, tier=tier)
    for out_dtype in (torch.float32, torch.bfloat16):
        kw["out_dtype"] = out_dtype
        K.reset_launches()
        got = K.gemm_epilogue(pieces, m, **kw)
        _assert_launched("gemm_tc", "vec16_bf16")
        plain = K.gemm_epilogue_plain(pieces, m, **kw)
        if out_dtype == torch.bfloat16:
            _assert_bf16_close(got, plain)
        else:
            _assert_close(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("frames,level", [(243, 0), (81, 0), (243, 1)])
def test_cuda_bf16_io_gab_narrow_matches_plain(model, frames, level,
                                               monkeypatch):
    """``gab_narrow`` at C = 32 and 64 on bf16 x to a bf16 output, and on
    float32 x to a bf16 output. The plain version's bf16 products sum in
    float32."""
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    m = _model(frames)
    t = gab_tables(m.layers_graph_conv[level], m.statics)
    c = t.w_proj.shape[0]
    x = _randn(7 * 17, c, seed=level)
    for xin in (x.to(torch.bfloat16), x):
        K.reset_launches()
        got = K.gab_narrow(xin, t, torch.bfloat16)
        assert K.LAUNCHES["gab_narrow"] == 1
        _assert_bf16_close(got, K.gab_narrow_plain(xin, t, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [27, 243])
def test_cuda_bf16_storage_forward_matches_plain_route(model, frames,
                                                       monkeypatch):
    """``storage_dtype="bfloat16"`` on the card: every GAB on the bf16-I/O
    kernels, the output float32, within the storage's own distance from
    float32 of the same route through the plain versions."""
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    m = _model(frames)
    x = _randn(4, frames, 17, 2, seed=frames)
    f32 = m.plain_route_forward(x)
    m.cfg = dataclasses.replace(m.cfg, storage_dtype="bfloat16")
    K.reset_launches()
    got = m(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert K.DTYPE_LAUNCHES["gemm_epilogue"]["bf16_io"] > 0
    plain = m.plain_route_forward(x)
    gap = (plain - f32).abs().max().item()
    assert (got - plain).abs().max().item() <= max(
        gap, 1e-4 * max(1.0, plain.abs().max().item()))


def _tier_close(got, plain, f32, slack=0.0):
    """A tiered result against its plain version at the same tiers: the
    float32 bound or, where larger, twice the tier's own distance from
    the float32 result (``chip_smoke.tier_bound``: two float32 orders may
    round an intermediate to neighbouring bf16 values), plus ``slack``."""
    torch.cuda.synchronize()
    assert got.shape == plain.shape
    bound = slack + max(1e-4 * max(1.0, plain.abs().max().item()),
                        2 * (plain - f32).abs().max().item())
    err = (got - plain).abs().max().item()
    assert err <= bound, (err, bound)


NARROW_TIERS = ("default", "kdefault", "high_lhs", "high_rhs", "high")


def _assert_narrow_scratch(t):
    """After a tiered gab_narrow launch on ``t``: its scratch buffer holds
    the split words of ``kernels.narrow_split_plain`` bit for bit, and the
    grid barrier's counters are back at 0."""
    torch.cuda.synchronize()
    buf = K.narrow_scratch(t.w_proj.device,
                           torch.cuda.current_stream().cuda_stream)
    off, words = K.narrow_split_plain(t)
    assert torch.equal(buf[K.NARROW_SCRATCH_CTL + off], words)
    assert int(buf[:K.NARROW_SCRATCH_CTL].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("io", ("float32", "bf16"))
@pytest.mark.parametrize("channels", (16, 32, 48, 64))
def test_cuda_gab_narrow_tiered_matches_plain(model, channels, io,
                                             monkeypatch):
    """gab_narrow's tiered form (bf16 mma.sync passes) at every tier and at
    the JAX preset's mixed kernel tiers, in the float32 library and the
    bf16-I/O one (bf16 x, to a float32 and to a bf16 output), against its
    plain version at the same tiers (``_tier_close``, plus one bf16 step
    of a bf16 output), each launch counted under its tiers; and, on a
    float32 output, nearer its plain version than the float32 result
    wherever the tier moves it (a bf16 output's own rounding hides that)."""
    from gastx_torch.ops.cuda.fused_gab import KERNEL_OPS

    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    gen = torch.Generator().manual_seed(channels)
    m = GastNet(GastNetConfig(filter_widths=(3, 3), channels=channels))
    m = randomize_eval_statistics(init_gastnet(m, gen), gen).cuda().eval()
    t = gab_tables(m.layers_graph_conv[0], m.statics)
    x = _randn(301 * 17, channels, seed=channels)
    outs = (torch.float32,)
    if io == "bf16":
        x, outs = x.to(torch.bfloat16), (torch.float32, torch.bfloat16)
    f32 = K.gab_narrow_plain(x, t, torch.float32)
    noise = (K.gab_narrow(x, t, torch.float32) - f32).pow(2).mean().sqrt() \
        .item()
    preset = config_for_frames(243, matmul_precision="high",
                               precision_overrides=(
                                   ("local_sem", "default"),
                                   ("attn_proj", "kdefault"),
                                   ("attn_score", "default")))
    cases = [dict.fromkeys(KERNEL_OPS, tier) for tier in NARROW_TIERS]
    cases.append({op: preset.tier_for(op, "gab1") for op in KERNEL_OPS})
    for tiers in cases:
        for out in outs:
            K.reset_launches()
            got = K.gab_narrow(x, t, out, tiers).float()
            assert K.LAUNCHES["gab_narrow"] == 1
            assert sum(K.TIER_LAUNCHES["gab_narrow"].values()) == 1
            assert K.DTYPE_LAUNCHES["gab_narrow"][K.io_label([x], out)] == 1
            _assert_narrow_scratch(t)
            plain = K.gab_narrow_plain(x, t, out, tiers).float()
            if out == torch.bfloat16:
                _tier_close(got, plain, f32,
                            2.0 ** -8 * plain.abs().max().item())
                continue
            _tier_close(got, plain, f32)
            if (plain - f32).pow(2).mean().sqrt().item() > 2 * noise:
                rms = (got - plain).pow(2).mean().sqrt().item()
                assert rms <= 0.5 * (got - f32).pow(2).mean().sqrt().item()


@pytest.mark.cuda
@pytest.mark.parametrize("io", ("float32", "bf16"))
@pytest.mark.parametrize("channels", K.NARROW_FOLD_WIDTHS)
def test_cuda_gab_narrow_fold_matches_plain(model, channels, io,
                                           monkeypatch):
    """gab_narrow's fold form (the tables of gab_tables(..., "fold")) at
    every width it is built for, at each of NARROW_FRAMES: the float32
    kernel and the tiered one at every tier and the JAX preset's kernel
    tiers, in the float32 library and the bf16-I/O one (bf16 x, to a
    float32 and to a bf16 output), against its plain version (the float32
    bound, or ``_tier_close``; plus one bf16 step of a bf16 output), each
    launch counted under the fold form."""
    from gastx_torch.ops.cuda.fused_gab import KERNEL_OPS

    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    gen = torch.Generator().manual_seed(channels)
    m = GastNet(GastNetConfig(filter_widths=(3, 3), channels=channels))
    m = randomize_eval_statistics(init_gastnet(m, gen), gen).cuda().eval()
    t = gab_tables(m.layers_graph_conv[0], m.statics, "fold")
    preset = config_for_frames(243, matmul_precision="high",
                               precision_overrides=(
                                   ("local_sem", "default"),
                                   ("attn_proj", "kdefault"),
                                   ("attn_score", "default")))
    cases = [None] + [dict.fromkeys(KERNEL_OPS, tier)
                      for tier in NARROW_TIERS]
    cases.append({op: preset.tier_for(op, "gab0") for op in KERNEL_OPS})
    for frames in NARROW_FRAMES:
        x = _randn(frames * 17, channels, seed=frames + channels)
        outs = (torch.float32,)
        if io == "bf16":
            x, outs = x.to(torch.bfloat16), (torch.float32, torch.bfloat16)
        f32 = K.gab_narrow_plain(x, t, torch.float32)
        for tiers in cases:
            for out in outs:
                K.reset_launches()
                got = K.gab_narrow(x, t, out, tiers)
                assert K.VARIANT_LAUNCHES["gab_narrow"] == {"v1": 0,
                                                            "fold": 1}
                assert K.DTYPE_LAUNCHES["gab_narrow"][
                    K.io_label([x], out)] == 1
                assert sum(K.TIER_LAUNCHES["gab_narrow"].values()) == (
                    tiers is not None)
                assert all(k.startswith("fold ")
                           for k in K.TIER_LAUNCHES["gab_narrow"])
                if tiers is not None:
                    _assert_narrow_scratch(t)
                plain = K.gab_narrow_plain(x, t, out, tiers)
                if tiers is None and out == torch.bfloat16:
                    _assert_bf16_close(got, plain)
                elif tiers is None:
                    _assert_close(got, plain)
                else:
                    slack = (2.0 ** -8 * plain.float().abs().max().item()
                             if out == torch.bfloat16 else 0.0)
                    _tier_close(got.float(), plain.float(), f32, slack)


@pytest.mark.cuda
def test_cuda_preset_243f_runs_fold_gab_narrow(model, monkeypatch):
    """The JAX preset's 243f forward (GAB 0 folded, C = 32) runs GAB 0 as
    one fold gab_narrow launch, in its tiered form, under
    fused_level0 / fused_gab_pbatch, and each other GAB that gab_route
    sends to gab_narrow (GAB 1, C = 64, since the tiered form's redesign)
    as one v1 launch under fused_level / fused_gab_pbatch; the wider ones
    take the tiered chain. The forward holds to its plain route
    (``_tier_close``)."""
    from gastx_torch.models import build_gastnet
    from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES

    cfg = config_for_frames(243, dropout=0.0, matmul_precision="high",
                            precision_overrides=TPU_MIXED_PRECISION_OVERRIDES)
    assert cfg.gab_kernel_form_levels == ("fold",)
    m = build_gastnet(cfg, seed=243, device="cuda")
    x = _randn(4, 243, 17, 2, seed=243)
    seen = []
    real = K.gab_narrow

    def spy(x, t, *args, **kw):
        seen.append((t.form, tuple(K._OPEN_ENTRIES)))
        return real(x, t, *args, **kw)

    monkeypatch.setattr(K, "gab_narrow", spy)
    K.reset_launches()
    got = m(x)
    torch.cuda.synchronize()
    from gastx_torch.ops.cuda.fused_gab import KERNEL_OPS, gab_route, \
        gab_tables

    v1 = [i for i, g in enumerate(m.layers_graph_conv)
          if i > 0 and gab_route(gab_tables(g, m.statics), {
              op: cfg.tier_for(op, f"gab{i}") for op in KERNEL_OPS})
          == "gab_narrow"]
    assert v1 == [1]
    assert seen == [("fold", ("fused_level0", "fused_gab_pbatch"))] + [
        ("v1", ("fused_level", "fused_gab_pbatch"))] * len(v1)
    assert K.VARIANT_LAUNCHES["gab_narrow"] == {"v1": len(v1), "fold": 1}
    folds = {k: v for k, v in K.TIER_LAUNCHES["gab_narrow"].items()
             if k.startswith("fold ")}
    assert sum(folds.values()) == 1
    assert sum(K.TIER_LAUNCHES["gab_narrow"].values()) == 1 + len(v1)
    assert not K.TIER_LAUNCHES["joint_attention"].get("highest/default")
    _tier_close(got, m.plain_route_forward(x), m.reference_forward(x))


SITE_CELLS = {
    "27f xla": (27, {"gab_impl": "xla"}, "dilated", 31),
    "27f hybrid": (27, {"gab_impl": "pallas_local",
                        "attn_impl": "pallas_head"}, "dilated", 31),
    "27f strided causal": (27, {"causal": True}, "strided", 54),
    "27f dense": (27, {"dense": True}, "dilated", 31),
    "81f C=512 chain": (81, {}, "dilated", 85)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SITE_CELLS))
def test_cuda_plain_sites_launch_their_gemm(model, cell):
    """Each plain site on the card at the JAX preset's tiers launches its
    GEMM (``K.SITE_PRODUCTS``: no float32 product at any plain site; the
    row-wide classes through gemm_tc or gemm_smallk, never the float32
    gemm_epilogue), and the forward holds to its plain route."""
    from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES

    frames, fields, variant, t = SITE_CELLS[cell]
    m = _variant_model(frames, **fields)
    x = _randn(3, t, 17, 2, seed=frames)
    f32 = m.reference_forward(x, variant)
    m.cfg = dataclasses.replace(
        m.cfg, matmul_precision="high",
        precision_overrides=TPU_MIXED_PRECISION_OVERRIDES)
    K.reset_launches()
    got = m(x, variant)
    torch.cuda.synchronize()
    sites = {op: dict(v) for op, v in K.SITE_PRODUCTS.items()}
    assert not any(v.get("highest") for v in sites.values()), sites
    # Every cell but the last runs no level-0 kernel: its expand conv is a
    # plain site.
    want = {"temporal", "mid1x1", "shrink"}
    if cell != "81f C=512 chain":
        want.add("expand")
    if "xla" in cell:
        want |= {"local_sem", "local_off", "local_cat"}
    if "xla" in cell or "hybrid" in cell:
        want |= {"attn_proj", "attn_cat", "gab_cat"}
    if "xla" in cell:
        want |= {"attn_score", "attn_apply"}
    assert want <= set(sites), sites
    assert K.LAUNCHES["gemm_epilogue"] == 0
    assert K.LAUNCHES["gemm_tc"] > 0 and K.LAUNCHES["gemm_smallk"] == 1
    _tier_close(got, m.plain_route_forward(x, variant), f32)


# The weight gradient kernel: (rows of A, K_p of each piece, offsets, M,
# s_out, a_s_in, N): a conv's taps over ragged sequences, the expand conv's
# K = 2 taps (strided at 27f, B = 64), N = 51 on pieces of different K, the
# shrink's N = 3, a 27f level-1 strided conv at B = 256 (the rows split
# across blocks), and a block concat's three pieces; then pieces of 64 and
# 40 rows of dW in one wgmma tile at N = 96 (the padding, a partial
# 128-wide tile), a C=512 attention projection (N = 1536: six 256-wide
# tiles) and the 243f expand conv's K = 2 taps at N = 32. Each takes
# wgrad_route's instantiation: smallk, wgmma (TMA or the taps' gathers) or
# general.
WGRAD_CASES = {
    "ragged_rows": (2 * 11 * 5, (8, 8, 8), (0, 15, 30), 2 * 5 * 5, 25, 55,
                    12),
    "expand_k2": (64 * 27 * 17, (2, 2, 2), (0, 17, 34), 64 * 9 * 17, 17,
                  51, 128),
    "n51": (4001, (5, 13, 2), (0, 0, 0), 4001, 4001, 4001, 51),
    "shrink": (4913, (512,), (0,), 4913, 4913, 4913, 3),
    "level1_strided": (256 * 9 * 17, (256, 256, 256), (0, 17, 34),
                       256 * 3 * 17, 17, 51, 256),
    "concat3": (9000, (128, 128, 128), (0, 0, 0), 9000, 9000, 9000, 256),
    "aligned_n96": (5000, (64, 40), (0, 7), 4993, 4993, 4993, 96),
    "proj_n1536": (4352, (512,), (0,), 4352, 4352, 4352, 1536),
    "expand_k2_n32": (16 * 243 * 17, (2, 2, 2), (0, 17, 34),
                      16 * 81 * 17, 17, 51, 32),
}
WGRAD_CASE_ROUTES = {"ragged_rows": "general", "expand_k2": "smallk",
                     "n51": "general", "shrink": "general",
                     "level1_strided": "wgmma", "concat3": "wgmma",
                     "aligned_n96": "wgmma", "proj_n1536": "wgmma",
                     "expand_k2_n32": "smallk"}


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ("default", "high"))
@pytest.mark.parametrize("case", sorted(WGRAD_CASES))
def test_cuda_gemm_wgrad_matches_plain(model, case, tier):
    """gemm_wgrad at each tier against its plain version on the same
    operands (both sum products of the same bf16 halves in float32), one
    launch a call of the case's instantiation, and the same bits on a
    second call (the splits' fixed order of sums)."""
    rows, ks, offs, m, s_out, a_s_in, n = WGRAD_CASES[case]
    pieces = [(_randn(rows, k, seed=i), off)
              for i, (k, off) in enumerate(zip(ks, offs))]
    g = _randn(m, n, seed=9)
    kw = dict(s_out=s_out, a_s_in=a_s_in, tier=tier)
    K.reset_launches()
    got = K.gemm_wgrad(pieces, g, m, **kw)
    again = K.gemm_wgrad(pieces, g, m, **kw)
    assert K.LAUNCHES["gemm_wgrad"] == 2
    assert K.TIER_LAUNCHES["gemm_wgrad"][tier] == 2
    variant = WGRAD_CASE_ROUTES[case]
    assert K.wgrad_route(pieces, g, s_out, a_s_in) == variant
    assert K.VARIANT_LAUNCHES["gemm_wgrad"] == {
        v: 2 * (v == variant) for v in K.WGRAD_VARIANTS}
    _assert_close(got, K.gemm_wgrad_plain(pieces, g, m, **kw))
    assert torch.equal(got, again)


def _tiered_step(base, cfg, plain, batch=8, frames=27):
    """One strided train step of a copy of ``base`` at ``cfg`` on the card
    (``plain``: the tiered products through their plain versions): the
    loss and the model after it."""
    import copy

    from gastx_torch.train import make_optimizer, train_step

    m = copy.deepcopy(base)
    m.cfg = cfg
    opt = make_optimizer(m.parameters())
    loss = train_step(m, opt, *_train_batch(frames, batch, 33, "cuda"), 1e-3,
                      torch.Generator(device="cuda").manual_seed(1),
                      "strided", plain=plain)
    torch.cuda.synchronize()
    return loss, m


def _step_tensors(loss, m):
    out = {"loss": loss.reshape(1)}
    for n, p in m.named_parameters():
        out[f"grad {n}"], out[f"param {n}"] = p.grad, p
    out.update({f"bn {n}": b for n, b in m.named_buffers()
                if "running" in n})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("high", "preset"))
def test_cuda_tiered_train_step_matches_plain(model, name):
    """A 27f strided train step (dropout 0.05) at all ``high`` and at the
    JAX preset on the kernels against the same step through the plain
    versions on the card: for each kind of tensor (the loss, the
    gradients, the parameters after amsgrad, the BN statistics) the
    kernel step lies from the float32 step, in the 2-norm over all its
    elements, at most twice as far as the plain step does, plus the
    float32 bound (``chip_smoke.TIER_STEP_NORM``: two float32 orders may
    round an intermediate to neighbouring bf16 values, so the two steps
    are two draws of the tier's rounding, which the step's depth amplifies
    unevenly from tensor to tensor). Only gemm_tc, gemm_smallk and
    gemm_wgrad launch, every site at its tier (no float32 product), and a
    second run gives the same bits."""
    from gastx_torch.models.config import TPU_MIXED_PRECISION_OVERRIDES

    base = GastNet(dataclasses.replace(config_for_frames(27), dropout=0.05))
    gen = torch.Generator().manual_seed(35)
    base = randomize_eval_statistics(init_gastnet(base, gen), gen).cuda()
    cfg = dataclasses.replace(
        base.cfg, matmul_precision="high",
        precision_overrides=(TPU_MIXED_PRECISION_OVERRIDES
                             if name == "preset" else ()))
    f32 = _step_tensors(*_tiered_step(base, base.cfg, False))
    plain = _step_tensors(*_tiered_step(base, cfg, True))
    K.reset_launches()
    got = _step_tensors(*_tiered_step(base, cfg, False))
    launched = {k for k, v in K.LAUNCHES.items() if v}
    sites = {op: dict(v) for op, v in K.SITE_PRODUCTS.items()}
    grads = {op: dict(v) for op, v in K.SITE_GRADS.items()}
    assert launched == {"gemm_tc", "gemm_smallk", "gemm_wgrad"}, launched
    assert not any(v for v in K.ENTRY_LAUNCHES.values())
    assert not any(v.get("highest") for v in sites.values()), sites
    assert len(sites) == 12 and set(grads) == set(sites), grads
    again = _step_tensors(*_tiered_step(base, cfg, False))
    sums = {}
    for n, t in got.items():
        assert torch.equal(t, again[n]), n
        f = f32[n].detach().double()
        acc = sums.setdefault(n.split()[0], [0.0, 0.0, 0.0])
        acc[0] += ((t.detach().double() - f) ** 2).sum().item()
        acc[1] += ((plain[n].detach().double() - f) ** 2).sum().item()
        acc[2] += (f ** 2).sum().item()
    for kind, (dk, dp, scale) in sums.items():
        assert dk ** 0.5 <= 2 * dp ** 0.5 + 1e-4 * max(1.0, scale ** 0.5), \
            (kind, dk ** 0.5, dp ** 0.5)
