"""The JAX package's whole eval config surface on the port, on the CPU:
every route knob, the fold form and bf16 storage.

Every JAX config crosses field for field (``torch_config``) and the port's
forward is held to ``gastnet_forward`` on numpy-seeded weights and inputs.
float32 routes: atol 2e-5, rtol 1e-4 (only the order of summation differs;
every route computes the same function, so a route is held to one JAX
forward of its config, shared through a module-scoped cache). bf16 storage
rounds at other places in the two frameworks (XLA:CPU computes the GAB in
bf16 ops where the port's kernel route computes it in float32 between
bf16 boundaries), so a bf16 forward is held to JAX's bf16 forward within
the JAX package's own bf16-to-float32 gap on the same inputs:
``max|port_bf16 - jax_bf16| <= max|jax_bf16 - jax_f32|``.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models as jm
from gastx.models.precision import bf16_inference_fn as j_bf16_inference_fn
from gastx.models.precision import cast_floating as j_cast_floating
from gastx_torch.device import check_bf16_matmul
from gastx_torch.io import params_from_jax
from gastx_torch.models import GastNet
from gastx_torch.models.gastnet import GraphAttentionBlock
from gastx_torch.models.config import VALID_GAB_IMPLS
from gastx_torch.models.precision import bf16_inference_fn, cast_floating
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.fused_gab import fused_gab, fused_gab_plain, \
    fused_local_branch, gab_tables, local_tables
from gastx_torch.ops.cuda.fused_level import fused_level, fused_level0, \
    fused_level_plain, level0_tables, level_tables
from test_torch_common import (assert_close, inputs, port_model,
                               random_jax_tree, torch_config)

# The route tests' model: GABs at C = 32, 64, 128 (the narrow widths and
# the chain), rf 27.
ROUTE_CFG = jm.GastNetConfig(filter_widths=(3, 3, 3), channels=32,
                             dropout=0.0)
_JAX = {}


def jax_forward(cfg, params, state, x, key):
    """``gastnet_forward`` of ``cfg``, computed once per ``key`` (on jnp
    leaves: JAX's bf16 storage casts them, and numpy's bf16 would promote
    back to float32)."""
    if key not in _JAX:
        params, state = jax.tree_util.tree_map(jnp.asarray, (params, state))
        y, _ = jm.gastnet_forward(params, state, jnp.asarray(x), cfg,
                                  variant="dilated", train=False)
        _JAX[key] = np.asarray(y)
    return _JAX[key]


@pytest.fixture(scope="module")
def route_weights():
    return random_jax_tree(ROUTE_CFG, seed=40)


ROUTE_X = inputs((2, 29, 17, 2), 41)


@pytest.mark.parametrize("gab_impl", VALID_GAB_IMPLS)
def test_every_gab_impl_matches_gastnet_forward(route_weights, gab_impl):
    """Each JAX ``gab_impl`` value, with and without ``_interpret``, crosses
    as it is and computes the JAX forward's function."""
    params, state = route_weights
    want = jax_forward(ROUTE_CFG, params, state, ROUTE_X, "route")
    model = port_model(dataclasses.replace(ROUTE_CFG, gab_impl=gab_impl),
                       params, state)
    assert model.cfg.gab_impl == gab_impl
    assert_close(model(torch.from_numpy(ROUTE_X)), want)


@pytest.mark.parametrize("fields", [
    {"gab_impl_levels": ("pallas_level", "xla", "pallas_pbatch")},
    {"gab_impl": "pallas_level", "gab_impl_levels": ("", "pallas_local")},
    {"gab_impl": "xla", "gab_impl_levels": ("inherit", "pallas_interpret",
                                            "pallas_level_interpret")},
    {"gab_impl": "xla", "local_impl": "gather", "attn_impl": "batched"},
    {"gab_impl": "pallas_local", "local_impl": "gather",
     "attn_impl": "batched"},
    {"gab_impl": "auto", "packed_channels": 64},
    {"gab_impl": "auto", "packed_channels": 16},
    {"gab_impl": "pallas_pbatch", "gab_pbatch_max_pack": 1,
     "gab_softmax_group": 2, "gab_tile_budget": 1024},
], ids=["levels-mix", "level-then-local", "levels-interpret",
        "xla-gather-batched", "local-gather-batched", "auto-packed64",
        "auto-packed16", "pbatch-ignored-knobs"])
def test_route_knobs_match_gastnet_forward(route_weights, fields):
    """``gab_impl_levels``, ``local_impl="gather"``, ``attn_impl="batched"``
    and the other knobs against the JAX forward of the same config (its
    XLA path computes ``gather`` and ``batched`` in their own layouts)."""
    params, state = route_weights
    cfg = dataclasses.replace(ROUTE_CFG, **fields)
    xla_cfg = dataclasses.replace(ROUTE_CFG, local_impl=cfg.local_impl,
                                  attn_impl=cfg.attn_impl)
    want = jax_forward(xla_cfg, params, state, ROUTE_X,
                       ("route", cfg.local_impl, cfg.attn_impl))
    model = port_model(cfg, params, state)
    for f in dataclasses.fields(cfg):
        if f.name in fields:
            assert getattr(model.cfg, f.name) == fields[f.name]
    assert_close(model(torch.from_numpy(ROUTE_X)), want)


@pytest.mark.parametrize("frames", [27, 81, 243])
def test_shipped_configs_match_gastnet_forward(frames):
    """``config_for_frames`` under both presets (``"auto"``) and with
    ``gab_impl=`` set, cut to 8 channels: 81f's ``storage_dtype_levels``
    and ``"auto"`` storage (float32 off a TPU, in both packages), and
    243f's preset fold at GAB 0, against the JAX forward (XLA:CPU computes
    every tier in float32, so all share one)."""
    preset = jm.TPU_MIXED_PRECISION_OVERRIDES
    configs = [dataclasses.replace(
        jm.config_for_frames(frames, precision_overrides=o, gab_impl=g),
        channels=8)
        for o, g in (((), "auto"), (preset, "auto"), ((), "pallas_level"),
                     (preset, "xla"))]
    assert configs[1].gab_kernel_form_levels == (
        ("fold",) if frames == 243 else ())
    assert configs[3].gab_kernel_form_levels == ()
    params, state = random_jax_tree(configs[0], seed=frames)
    x = inputs((1, frames + 2, 17, 2), frames + 1)
    want = jax_forward(configs[0], params, state, x, ("shipped", frames))
    for cfg in configs:
        model = port_model(cfg, params, state)
        assert model.cfg.storage_dtype == cfg.storage_dtype
        assert model.cfg.gab_kernel_form_levels == cfg.gab_kernel_form_levels
        assert_close(model(torch.from_numpy(x)), want)


FOLD_CFG = jm.GastNetConfig(filter_widths=(3,), channels=16, dropout=0.0,
                            gab_kernel_form="fold")


def test_fold_matches_the_jax_fold_kernel():
    """The fold form against JAX's interpret-mode fold kernel (one
    compile), through ``fused_level0`` (``"auto"``) and ``fused_gab``
    (``"pallas"``); the fold tables give I = 1 and unit score vectors."""
    params, state = random_jax_tree(FOLD_CFG, seed=42)
    x = inputs((3, 7, 17, 2), 43)
    want = jax_forward(dataclasses.replace(FOLD_CFG,
                                           gab_impl="pallas_interpret"),
                       params, state, x, "fold")
    for gab_impl in ("auto", "pallas", "pallas_level_interpret"):
        model = port_model(FOLD_CFG, params, state, gab_impl=gab_impl)
        assert_close(model(torch.from_numpy(x)), want)
    t = gab_tables(model.layers_graph_conv[0], model.statics, "fold")
    assert t.form == "fold" and t.proj_t.shape == (4, 1)
    assert torch.equal(t.proj_t, torch.ones(4, 1))
    assert t.w_proj.shape == (16, 4 * 16 + 2 * 4 + 16)


STORE_CFG = jm.GastNetConfig(filter_widths=(3, 3, 3, 3), channels=8,
                             dropout=0.0)


@pytest.fixture(scope="module")
def storage_case():
    params, state = random_jax_tree(STORE_CFG, seed=44)
    x = inputs((1, 83, 17, 2), 45)
    f32 = jax_forward(STORE_CFG, params, state, x, "store f32")
    return params, state, x, f32


@pytest.mark.parametrize("fields", [
    {"storage_dtype": "bfloat16"},
    {"storage_dtype": "bfloat16",
     "storage_dtype_levels": ("", "", "", "float32")},
    {"storage_dtype": "float32",
     "storage_dtype_levels": ("bfloat16", "", "bfloat16")},
], ids=["uniform", "81f-mixed", "mixed-f32-base"])
def test_bf16_storage_within_the_jax_gap(storage_case, fields):
    """bf16 storage, uniform and per level, against JAX's on the same
    storage, on the crossed route (``"xla"``) and the kernel route
    (``"auto"``): within JAX's own bf16-to-float32 gap; the output
    float32, the module's weights and BN statistics untouched."""
    params, state, x, f32 = storage_case
    cfg = dataclasses.replace(STORE_CFG, **fields)
    want = jax_forward(cfg, params, state, x, ("store", str(fields)))
    gap = np.abs(want - f32).max()
    for gab_impl in ("xla", "auto"):
        model = port_model(cfg, params, state, gab_impl=gab_impl)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        got = model(torch.from_numpy(x))
        assert got.dtype == torch.float32
        for k, v in model.state_dict().items():
            assert v.dtype == before[k].dtype and torch.equal(v, before[k])
        err = np.abs(got.numpy() - want).max()
        print(f"{fields} {gab_impl}: max|port - jax| {err:.3e}, JAX's bf16 "
              f"gap {gap:.3e}")
        assert 0 < err <= gap


def test_bf16_storage_train_and_auto_are_float32(storage_case):
    """Training ignores storage (the train forward bitwise the float32
    one), and ``"auto"`` storage is float32 bit for bit."""
    params, state, x, _ = storage_case
    xt = torch.from_numpy(x)
    f32 = port_model(STORE_CFG, params, state)
    bf16 = port_model(dataclasses.replace(STORE_CFG,
                                          storage_dtype="bfloat16"),
                      params, state)
    auto = port_model(dataclasses.replace(
        STORE_CFG, storage_dtype="auto",
        storage_dtype_levels=("", "", "", "float32")), params, state)
    assert torch.equal(auto(xt), f32(xt))
    assert not torch.equal(bf16(xt), f32(xt))
    f32.train()
    bf16.train()
    assert torch.equal(bf16(xt), f32(xt))


def test_bf16_storage_copy_is_cached_and_follows_the_weights(storage_case):
    """The bf16 copy is made once and rebuilt after a weight changes."""
    params, state, x, _ = storage_case
    model = port_model(dataclasses.replace(STORE_CFG,
                                           storage_dtype="bfloat16"),
                       params, state)
    xt = torch.from_numpy(x)
    y0 = model(xt)
    copy = model.storage_copy(torch.bfloat16)
    assert copy.shrink.weight.dtype == torch.bfloat16
    assert model.shrink.weight.dtype == torch.float32
    assert model.storage_copy(torch.bfloat16) is copy
    assert model.storage_copy(torch.float32) is model
    with torch.no_grad():
        model.shrink.weight.mul_(2.0)
    assert model.storage_copy(torch.bfloat16) is not copy
    assert torch.allclose(model(xt), 2.0 * y0, rtol=1e-2, atol=1e-3)


def test_bf16_storage_copy_follows_a_reassigned_config(route_weights):
    """A config reassigned after the bf16 copy was made reaches the copy's
    levels: the model then computes what one built with that config
    does (``"pallas_level"`` fuses bf16 levels, ``"auto"`` does not)."""
    params, state = route_weights
    cfg = dataclasses.replace(ROUTE_CFG, storage_dtype="bfloat16")
    xt = torch.from_numpy(ROUTE_X)
    model = port_model(cfg, params, state)
    y_auto = model(xt)
    fresh = port_model(cfg, params, state, gab_impl="pallas_level",
                       matmul_precision="high")
    model.cfg = fresh.cfg
    y = model(xt)
    assert not torch.equal(y, y_auto)
    assert torch.equal(y, fresh(xt))


IO_CFG = jm.GastNetConfig(filter_widths=(3,), channels=16, dropout=0.0,
                          gab_io_dtype="bfloat16")


def test_gab_io_dtype_within_the_jax_gap():
    """``gab_io_dtype="bfloat16"`` rounds the input and output of a GAB
    that reaches ``fused_gab`` on float32 activations (JAX's kernel route:
    its interpret mode, one compile), within JAX's own gap; where the
    level kernels take the GAB (``"auto"``) it changes nothing."""
    params, state = random_jax_tree(IO_CFG, seed=48)
    x = inputs((3, 7, 17, 2), 49)
    want = jax_forward(dataclasses.replace(IO_CFG,
                                           gab_impl="pallas_interpret"),
                       params, state, x, "io")
    f32 = jax_forward(dataclasses.replace(IO_CFG, gab_io_dtype="float32"),
                      params, state, x, "io f32")
    xt = torch.from_numpy(x)
    gap = np.abs(want - f32).max()
    for gab_impl in ("pallas", "pallas_interpret"):
        got = port_model(IO_CFG, params, state, gab_impl=gab_impl)(xt)
        err = np.abs(got.numpy() - want).max()
        print(f"gab_io_dtype {gab_impl}: max|port - jax| {err:.3e}, JAX's "
              f"gap {gap:.3e}")
        assert err <= gap and gap > 0
    # The level kernels ("auto") and the narrow entry point ("pallas_pbatch"
    # at C <= 64) take no bf16 boundary, as in JAX.
    for gab_impl in ("auto", "pallas_pbatch"):
        got = port_model(IO_CFG, params, state, gab_impl=gab_impl)(xt)
        assert torch.equal(got, port_model(IO_CFG, params, state,
                                           gab_impl=gab_impl,
                                           gab_io_dtype="float32")(xt))


def test_cast_floating_weights_across(storage_case):
    """JAX weights through ``params_from_jax``, ``cast_floating`` on both
    sides and ``bf16_inference_fn`` on both sides: within JAX's gap; and
    the port's wrapper is its ``storage_dtype="bfloat16"`` forward bit for
    bit."""
    params, state, x, f32 = storage_case
    want = np.asarray(j_bf16_inference_fn(
        lambda p, s, xx: jm.gastnet_forward(p, s, xx, STORE_CFG)[0])(
            *jax.tree_util.tree_map(jnp.asarray, (params, state)),
            jnp.asarray(x)))
    sd = params_from_jax(params, state, STORE_CFG)
    sd16 = cast_floating(sd, torch.bfloat16)
    assert sd16["shrink.weight"].dtype == torch.bfloat16
    assert sd16["expand_bn.num_batches_tracked"].dtype == torch.int64
    model16 = GastNet(torch_config(STORE_CFG)).to(torch.bfloat16).eval()
    model16.load_state_dict(sd16, strict=True)
    got16 = model16(torch.from_numpy(x))
    assert got16.dtype == torch.float32
    j16 = j_cast_floating(params, jnp.bfloat16)
    assert j16["shrink"]["w"].dtype == jnp.bfloat16
    err, gap = np.abs(got16.numpy() - want).max(), np.abs(want - f32).max()
    print(f"cast_floating: max|port - jax| {err:.3e}, JAX's gap {gap:.3e}")
    assert err <= gap
    model = port_model(STORE_CFG, params, state)
    wrapped = bf16_inference_fn(lambda m, xx: m(xx))(model,
                                                      torch.from_numpy(x))
    stored = port_model(dataclasses.replace(STORE_CFG,
                                            storage_dtype="bfloat16"),
                        params, state)(torch.from_numpy(x))
    assert wrapped.dtype == torch.float32 and torch.equal(wrapped, stored)
    assert torch.equal(got16, stored)


def test_bf16_io_plain_versions_are_upcast_then_rounded(route_weights):
    """Each bf16-I/O form's plain version (what the card's kernels are held
    to) is the float32 plain version on the upcast input, rounded to bf16:
    ``gemm_epilogue`` with bf16 pieces, residual and output, ``gab_narrow``
    and the chain (``fused_gab``), ``fused_level`` with bf16 x."""
    params, state = route_weights
    model = port_model(ROUTE_CFG, params, state)
    gen = torch.Generator().manual_seed(46)
    bf = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(bf)

    a, res = rand(40, 24), rand(20, 16)
    w, w2 = torch.randn(24, 16, generator=gen), torch.randn(16, 16,
                                                            generator=gen)
    b = torch.randn(40, 16, generator=gen)
    scale, shift = torch.rand(16, generator=gen), torch.rand(16, generator=gen)
    kw = dict(s_out=10, a_s_in=20, scale=scale, shift=shift, relu=True,
              res_s_in=10)
    pieces = [(a, w, 3), (b, w2, 0)]
    f32_pieces = [(a.float(), w, 3), (b, w2, 0)]
    for out_dtype in (torch.float32, bf):
        got = K.gemm_epilogue(pieces, 20, res=res, out_dtype=out_dtype, **kw)
        want = K.gemm_epilogue_plain(f32_pieces, 20, res=res.float(),
                                     **kw).to(out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, want)
    for i in (0, 1, 2):
        t = gab_tables(model.layers_graph_conv[i], model.statics)
        c = t.w_proj.shape[0]
        x = rand(2, 5, 17, c)
        for out_dtype in (None, torch.float32):
            got = fused_gab(x, t, out_dtype=out_dtype)
            want = fused_gab_plain(x.float(), t).to(out_dtype or bf)
            assert torch.equal(got, want), (c, out_dtype)
        if c in K.NARROW_WIDTHS:
            xs = x.reshape(-1, c)
            assert torch.equal(K.gab_narrow(xs, t),
                               K.gab_narrow_plain(xs.float(), t).to(bf))
            assert torch.equal(K.gab_narrow(xs.float(), t, bf),
                               K.gab_narrow_plain(xs.float(), t).to(bf))
    lt = level_tables(*model.level_modules(1))
    gt = gab_tables(model.layers_graph_conv[1], model.statics)
    x = rand(2, 9, 17, 64)
    got = fused_level(x, lt, gt, fw=3, dilation=3, res_off=3)
    want = fused_level_plain(x.float(), lt, gt, fw=3, dilation=3,
                             res_off=3).to(bf)
    assert got.dtype == bf and torch.equal(got, want)
    assert all(v == 0 for v in K.LAUNCHES.values())
    assert all(v == 0 for d in K.DTYPE_LAUNCHES.values() for v in d.values())


def test_bf16_only_where_a_form_exists(route_weights):
    """The wrappers take bf16 where a bf16-I/O form exists and raise
    elsewhere: ``fused_level0``, ``fused_local_branch``, ``sem_graph``,
    ``joint_attention``, bf16 weights, and ``gab_narrow`` on fold tables
    of a width its fold form has no instantiation for (C = 80; at C = 32
    it takes them)."""
    params, state = route_weights
    model = port_model(ROUTE_CFG, params, state)
    gab = model.layers_graph_conv[0]
    t = gab_tables(gab, model.statics)
    x = torch.zeros(1, 3, 17, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        fused_local_branch(x, local_tables(gab.local_graph_layer,
                                           model.statics))
    with pytest.raises(ValueError, match="float32"):
        fused_level0(torch.zeros(1, 5, 17, 2, dtype=torch.bfloat16),
                     level0_tables(model.init_bn, model.expand_conv,
                                   model.expand_bn), t)
    p = torch.zeros(51, t.w_proj.shape[1], dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        K.sem_graph(p, 32, t.w_self, t.w_nbr, t.col, t.sem_scale,
                    t.sem_shift)
    ki = t.proj_t.numel()
    with pytest.raises(ValueError, match="float32"):
        K.joint_attention(p[:, 128:128 + ki], p[:, 128 + ki:128 + 2 * ki],
                          p[:, 128 + 2 * ki:], t.proj_t, t.proj_p, t.c_k)
    with pytest.raises(ValueError, match="float32"):
        K.gemm_epilogue([(torch.zeros(4, 8), torch.zeros(
            8, 4, dtype=torch.bfloat16), 0)], 4)
    with pytest.raises(ValueError, match="out_dtype"):
        K.gemm_epilogue([(torch.zeros(4, 8), torch.zeros(8, 4), 0)], 4,
                        out_dtype=torch.float16)
    fold = gab_tables(gab, model.statics, "fold")
    got = K.gab_narrow(x.reshape(-1, 32), fold)
    assert got.dtype == torch.bfloat16 and torch.equal(
        got, K.gab_narrow_plain(x.reshape(-1, 32), fold))
    torch.manual_seed(80)
    wide = gab_tables(GraphAttentionBlock(80, model.statics).eval(),
                      model.statics, "fold")
    with pytest.raises(ValueError, match="fold form takes C"):
        K.gab_narrow(torch.zeros(51, 80, dtype=torch.bfloat16), wide)


def test_bf16_reduced_precision_reduction_is_refused():
    """Plain bf16 products on the card must sum in float32: PyTorch's
    default reduced-precision bf16 reduction raises (testable without a
    card: the check takes the device)."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            True
        with pytest.raises(RuntimeError, match="reduced_precision"):
            check_bf16_matmul("cuda")
        check_bf16_matmul("cpu")
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        check_bf16_matmul("cuda")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag


# Entry-point calls of one forward of ROUTE_CFG (C = 32, 64, 128) by
# route: the JAX gates, which parity cannot tell apart.
ROUTE_CALLS = [
    ({"gab_impl": "pallas_level"}, {"fused_level0": 1, "fused_level": 2}),
    ({"gab_impl": "pallas_pbatch"}, {"fused_gab": 3}),
    ({"gab_impl_levels": ("xla", "pallas_level", "pallas_local")},
     {"fused_level": 1, "fused_local_branch": 1}),
    ({"gab_impl": "auto", "packed_channels": 64},
     {"fused_gab_packed": 2, "fused_level": 1}),
    ({"gab_impl": "auto", "storage_dtype": "bfloat16"}, {"fused_gab": 3}),
    ({"gab_impl": "pallas_level", "storage_dtype": "bfloat16"},
     {"fused_gab": 1, "fused_level": 2}),
    ({"gab_impl": "pallas_local", "storage_dtype": "bfloat16"}, {}),
    ({"gab_impl": "auto", "storage_dtype_levels": ("bfloat16",)},
     {"fused_gab": 3}),
    ({"gab_impl": "auto", "gab_io_dtype": "bfloat16"},
     {"fused_level0": 1, "fused_level": 2}),
]


def test_new_routes_call_their_entry_points(route_weights, monkeypatch):
    """Which wrapper each new route reaches, and the dtype it is given."""
    import gastx_torch.models.gastnet as G

    calls, dtypes = collections.Counter(), collections.defaultdict(set)

    def spy(name):
        fn = getattr(G, name)

        def counted(x, *args, **kw):
            calls[name] += 1
            dtypes[name].add(x.dtype)
            return fn(x, *args, **kw)
        monkeypatch.setattr(G, name, counted)

    for name in ("fused_level0", "fused_level", "fused_gab",
                 "fused_gab_packed", "fused_local_branch", "head_attention"):
        spy(name)
    x = torch.from_numpy(inputs((1, 27, 17, 2), 47))
    for route, want in ROUTE_CALLS:
        calls.clear()
        dtypes.clear()
        port_model(ROUTE_CFG, *route_weights, **route)(x)
        assert dict(calls) == want, route
        bf16 = route.get("storage_dtype") == "bfloat16"
        if bf16:
            assert all(d == {torch.bfloat16} for d in dtypes.values()), route
