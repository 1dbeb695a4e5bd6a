"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA device.

The file imports neither JAX nor gastx, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest`` (the suite's conftest configures JAX).

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|). Both sides
compute in float32; only the order of summation differs.
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


# gemm_epilogue's ragged cases: (operands builder, instantiation it takes).
GEMM_CASES = {
    "k2_taps": (lambda: _taps(2, 128, 1, False), "general"),
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
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_cuda_gemm_epilogue_matches_plain(model, case):
    """Ragged rows, columns and K, taps, pieces and a residual, each on the
    instantiation gemm_variant picks for it."""
    build, variant = GEMM_CASES[case]
    pieces, m, kw = build()
    K.reset_launches()
    got = K.gemm_epilogue(pieces, m, **kw)
    _assert_launched("gemm_epilogue", variant)
    _assert_close(got, K.gemm_epilogue_plain(pieces, m, **kw))


def _assert_launched(kernel, variant):
    """Since the last reset, ``kernel`` launched once, on ``variant``."""
    assert K.VARIANT_LAUNCHES[kernel] == {
        v: int(v == variant) for v in K.VARIANTS}, K.VARIANT_LAUNCHES


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
    joint_attention, as gab_route sends it."""
    routes = [K.gab_route(*K.gab_shape(gab_tables(g, m.statics)))
              for g in m.layers_graph_conv]
    chain = routes.count("chain")
    return {"gemm_epilogue": 4 * chain, "sem_graph": chain,
            "joint_attention": chain, "gab_narrow": routes.count("gab_narrow")}


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
