"""The port's matmul precision tiers against the JAX package's, on the CPU.

The tier arithmetic (``gastx_torch.ops.precision``) is held to eager
``kdot`` / ``kdot_general`` in their non-interpret branch, which emulates
each tier as bf16 passes on any backend (the one-pass tier against
``jnp.dot`` of bf16-cast operands: on the CPU ``kdot(..., "default")`` is a
float32 product). Both sides multiply bf16-valued operands exactly and sum
in float32, so only the order of the sums differs: rtol 1e-5 of the
largest reference value. The tier resolution, the config surface and the
trainval flag are compared as values. The model forward on the CPU runs
every tier in float32, as the JAX package's CPU path does, and is held to
``gastnet_forward`` at atol 2e-5 / rtol 1e-4 (one jit compile).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models as jm
import gastx.models.config as jc
from gastx.cli.trainval import build_config as jax_build_config
from gastx.ops.pallas.fused_gab import KERNEL_OPS as JAX_KERNEL_OPS
from gastx.ops.pallas.fused_level import LEVEL_OPS as JAX_LEVEL_OPS
from gastx.ops.pallas.global_attn import KERNEL_OPS as JAX_GLOBAL_OPS
from gastx.ops.pallas.precision import kdot, kdot_general, resolve_tiers
from gastx.ops.pallas.precision import tiers_from_pairs as jax_pairs
import gastx_torch.models.config as tc
from gastx_torch.cli import trainval
from gastx_torch.ops import precision as P
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.fused_gab import KERNEL_OPS
from gastx_torch.ops.cuda.fused_level import LEVEL_OPS
from gastx_torch.ops.cuda.global_attn import KERNEL_OPS as GLOBAL_OPS
from test_torch_common import assert_close, inputs, port_model, \
    random_jax_tree

RTOL = 1e-5
TIERS = ("default", "kdefault", "high_lhs", "high_rhs", "high")
PRESET = jc.TPU_MIXED_PRECISION_OVERRIDES


def _ref_dot(a, b, tier):
    """The JAX tier arithmetic of a 2-D (or batched) product."""
    a, b = jnp.asarray(a), jnp.asarray(b)
    if tier in ("default", "kdefault"):
        return np.asarray(jnp.matmul(a.astype(jnp.bfloat16),
                                     b.astype(jnp.bfloat16),
                                     preferred_element_type=jnp.float32))
    return np.asarray(kdot(a, b, tier))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("k", (6, 128, 256))
@pytest.mark.parametrize("tier", TIERS)
def test_tiered_mm_matches_kdot(tier, k):
    a, b = inputs((40, k), 1), inputs((k, 24), 2)
    got = P.tiered_mm(torch.from_numpy(a), torch.from_numpy(b), tier)
    _close(got, _ref_dot(a, b, tier))
    # The tier is visible: its product is not the float32 one.
    assert not torch.equal(got, torch.from_numpy(a) @ torch.from_numpy(b))


def test_split_bf16_matches_jax():
    from gastx.ops.pallas.precision import _split_bf16

    a = inputs((64, 33), 3)
    hi, lo = P.split_bf16(torch.from_numpy(a))
    jhi, jlo = _split_bf16(jnp.asarray(a))
    np.testing.assert_array_equal(hi.float().numpy(),
                                  np.asarray(jhi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.float().numpy(),
                                  np.asarray(jlo.astype(jnp.float32)))


@pytest.mark.parametrize("tier", TIERS + ("highest",))
def test_gemm_epilogue_plain_tiers(tier):
    """Three dilated taps with the row map, BN scale/shift, ReLU and a
    residual, each tap's product by the tier's kdot."""
    b, t_in, j, c, n, d = 2, 9, 5, 12, 20, 2
    t_out = t_in - 2 * d
    x = inputs((b * t_in * j, c), 4)
    w = [inputs((c, n), 10 + i) for i in range(3)]
    scale, shift = inputs((n,), 5) + 2.0, inputs((n,), 6)
    res = inputs((b * t_in * j, n), 7)
    m, s_out = b * t_out * j, t_out * j
    got = K.gemm_epilogue_plain(
        [(torch.from_numpy(x), torch.from_numpy(wk), k * d * j)
         for k, wk in enumerate(w)], m, s_out=s_out, a_s_in=t_in * j,
        scale=torch.from_numpy(scale), shift=torch.from_numpy(shift),
        relu=True, res=torch.from_numpy(res), res_s_in=t_in * j,
        res_off=d * j, tier=tier)
    r = np.arange(m)
    base = (r // s_out) * t_in * j + r % s_out
    acc = sum((_ref_dot(x[base + k * d * j], wk, tier) if tier != "highest"
               else np.asarray(kdot(jnp.asarray(x[base + k * d * j]),
                                    jnp.asarray(wk), "highest")))
              for k, wk in enumerate(w))
    want = np.maximum(acc * scale + shift, 0.0) + res[base + d * j]
    _close(got, want)


def _jax_global_branch(theta, phi, g, proj_t, proj_p, c_k, st, at):
    """The JAX kernel's global-branch arithmetic (gastx/ops/pallas/
    fused_gab.py `_global_branch`: per-head rank-1 score dots, LeakyReLU,
    softmax, +C_k, apply) with kdot / kdot_general at the two tiers."""
    k, inter = proj_t.shape
    j = c_k.shape[1]
    tm = theta.shape[0] // j
    g_ch = g.shape[1] // k

    def dot(a, b, tier):
        return jnp.asarray(_ref_dot(a, b, tier))

    def dotg(a, b, tier):
        dims = (((2,), (1,)), ((0,), (0,)))
        a, b = jnp.asarray(a), jnp.asarray(b)
        if tier in ("default", "kdefault"):
            return jax.lax.dot_general(
                a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), dims,
                preferred_element_type=jnp.float32)
        return kdot_general(a, b, dims, tier)

    outs = []
    for h in range(k):
        sa = dot(theta[:, h * inter:(h + 1) * inter], proj_t[h][:, None],
                 st).reshape(tm, j, 1)
        sb = dot(phi[:, h * inter:(h + 1) * inter], proj_p[h][:, None],
                 st).reshape(tm, j, 1)
        f = sa + jnp.swapaxes(sb, 1, 2)
        f = jnp.where(f > 0, f, 0.2 * f)
        f = f - jnp.max(f, axis=2, keepdims=True)
        ef = jnp.exp(f)
        attn = ef / jnp.sum(ef, axis=2, keepdims=True) + c_k[h]
        gk = g[:, h * g_ch:(h + 1) * g_ch].reshape(tm, j, g_ch)
        outs.append(dotg(attn, gk, at))
    return np.asarray(jnp.concatenate(outs, axis=2)).reshape(tm * j, -1)


@pytest.mark.parametrize("pair", (("default", "default"), ("high", "high"),
                                  ("high_lhs", "high_rhs"),
                                  ("highest", "kdefault")))
def test_joint_attention_plain_tiers(pair):
    k, inter, g_ch, j, frames = 2, 8, 8, 7, 3
    rows = frames * j
    theta, phi, g = (inputs((rows, k * inter), 20), inputs((rows, k * inter),
                                                           21),
                     inputs((rows, k * g_ch), 22))
    proj_t, proj_p = inputs((k, inter), 23), inputs((k, inter), 24)
    c_k = 0.1 * inputs((k, j, j), 25)
    t = [torch.from_numpy(v) for v in (theta, phi, g, proj_t, proj_p, c_k)]
    got = K.joint_attention_plain(*t, score_tier=pair[0],
                                  apply_tier=pair[1])
    want = _jax_global_branch(theta, phi, g, proj_t, proj_p, c_k, *pair)
    _close(got, want)


def _jax_site_tiers(cfg, tag, ops):
    """JAX's tiers at a kernel call site (gastx/models/gastnet.py:226-235
    level_prec under the ambient matmul_precision)."""
    def raw(op):
        v = cfg.precision_for(f"{tag}.{op}")
        return v if v is not None else cfg.precision_for(op)
    prec = lambda op: jc.xla_precision(raw(op))  # noqa: E731
    prec.kernel_raw = raw
    with jax.default_matmul_precision(cfg.matmul_precision):
        return jax_pairs(resolve_tiers(prec, ops), ops)


@pytest.mark.parametrize("frames", (27, 81, 243))
@pytest.mark.parametrize("preset", (True, False))
def test_tier_resolution_matches_jax(frames, preset):
    over = PRESET if preset else ()
    jcfg = jc.config_for_frames(frames, precision_overrides=over)
    pcfg = tc.config_for_frames(frames, precision_overrides=over,
                                matmul_precision="high")
    assert pcfg.matmul_precision == jcfg.matmul_precision == "high"
    assert pcfg.precision_overrides == jcfg.precision_overrides
    cuda = torch.device("cuda")  # the resolver reads only its type
    for i in range(pcfg.num_levels):
        for tag, ops, jops in ((f"gab{i}", KERNEL_OPS, JAX_KERNEL_OPS),
                               (f"lvl{i}", LEVEL_OPS, JAX_LEVEL_OPS),
                               (f"gab{i}", GLOBAL_OPS, JAX_GLOBAL_OPS)):
            assert ops == jops
            assert (P.resolve_tiers(pcfg, tag, ops, cuda)
                    == _jax_site_tiers(jcfg, tag, jops))
            assert (P.resolve_tiers(pcfg, tag, ops, torch.device("cpu"))
                    == {op: "highest" for op in ops})
    # Level 0's expand in the "temporal" slot (gastnet.py:264-272).
    with jax.default_matmul_precision(jcfg.matmul_precision):
        base = jax.config.jax_default_matmul_precision
    want = (jcfg.precision_for("lvl0.expand")
            or jcfg.precision_for("expand") or base)
    assert pcfg.tier_for("expand", "lvl0") == want
    for op in tc.OP_CLASSES:
        assert (tc.xla_precision(pcfg.precision_for(op))
                == jc.xla_precision(jcfg.precision_for(op)))
    # Level-qualified entries win over the bare class.
    q = tc.config_for_frames(27, matmul_precision="high",
                             precision_overrides=(("attn_proj", "default"),
                                                  ("gab1.attn_proj",
                                                   "high_lhs")))
    assert q.tier_for("attn_proj", "gab1") == "high_lhs"
    assert q.tier_for("attn_proj", "gab0") == "default"


@pytest.mark.parametrize("base", ("high", "default", "highest"))
def test_tiers_from_pairs_matches_jax(base):
    pairs = (("attn_score", "default"), ("gab_cat", "high_rhs"))
    with jax.default_matmul_precision(base):
        want = jax_pairs(pairs, JAX_KERNEL_OPS)
    assert P.tiers_from_pairs(pairs, KERNEL_OPS, base) == want


def test_config_surface_matches_jax():
    assert tc.TPU_MIXED_PRECISION_OVERRIDES == jc.TPU_MIXED_PRECISION_OVERRIDES
    assert tc.TPU_MIXED_SAFE_OVERRIDES == jc.TPU_MIXED_SAFE_OVERRIDES
    assert tc.KERNEL_ONLY_TIERS == jc.KERNEL_ONLY_TIERS
    for tier in P.TIERS:
        assert tc.xla_precision(tier) == jc.xla_precision(tier)
    for frames in (27, 81, 243):
        for over in (PRESET, (), (("attn_cat", "high"),)):
            got = tc.config_for_frames(frames, precision_overrides=over,
                                       matmul_precision="high")
            want = jc.config_for_frames(frames, precision_overrides=over)
            assert got.precision_overrides == want.precision_overrides
    # The port's defaults stay float32.
    assert tc.GastNetConfig().matmul_precision == "highest"
    assert tc.config_for_frames(27).precision_overrides == ()


@pytest.mark.parametrize("bad", (
    dict(matmul_precision="high_rhs"), dict(matmul_precision="kdefault"),
    dict(matmul_precision="bf16"),
    dict(precision_overrides=(("attn_proj", "fast"),)),
    dict(precision_overrides=(("attn_projection", "high"),)),
    dict(precision_overrides=(("gabx.attn_proj", "high"),))))
def test_bad_tiers_raise(bad):
    with pytest.raises(ValueError):
        tc.GastNetConfig(**bad)
    with pytest.raises(ValueError):
        P.tiered_mm(torch.ones(2, 2), torch.ones(2, 2), "fast")


CFG = jm.GastNetConfig(filter_widths=(3, 3), channels=16, dropout=0.0,
                       matmul_precision="high", precision_overrides=PRESET)


def test_cpu_forward_computes_float32_at_every_tier():
    """On the CPU the preset forward equals the float32 one bitwise (every
    site resolves to "highest"), and gastnet_forward under the same config
    (XLA's CPU tiers are float32) at the parity tolerance."""
    params, state = random_jax_tree(CFG, seed=60)
    x = inputs((2, 27, 17, 2), 61)
    tiered = port_model(CFG, params, state, gab_impl="auto",
                        matmul_precision="high", precision_overrides=PRESET)
    f32 = port_model(CFG, params, state, gab_impl="auto")
    y = tiered(torch.from_numpy(x))
    assert torch.equal(y, f32(torch.from_numpy(x)))
    assert torch.equal(y, tiered.plain_route_forward(torch.from_numpy(x)))
    want, _ = jm.gastnet_forward(params, state, jnp.asarray(x), CFG,
                                 train=False)
    assert_close(y, np.asarray(want))


class _Dataset:
    def skeleton(self):
        return self

    def num_joints(self):
        return 17


@pytest.mark.parametrize("tier", ("high", "mixed", "default"))
def test_trainval_precision_flag_matches_jax(tier):
    args = argparse.Namespace(architecture="3,3", channels=16, dropout=0.0,
                              causal=False, matmul_precision=tier)
    got = trainval.build_config(args, _Dataset())
    want = jax_build_config(args, _Dataset())
    assert got.matmul_precision == want.matmul_precision
    assert got.precision_overrides == want.precision_overrides


@pytest.mark.parametrize("c,float32_route,tiered_route", [
    (16, "gab_narrow", "gab_narrow"), (32, "gab_narrow", "gab_narrow"),
    (48, "gab_narrow", "gab_narrow"), (64, "gab_narrow", "gab_narrow"),
    (128, "chain", "chain")])
def test_gab_route_under_tiers(c, float32_route, tiered_route):
    """Where the chain's GEMMs run below "highest", gab_narrow (its tiered
    form) keeps only the widths where it beat the tiered chain on the
    card (since its redesign every width it is built for, C <= 64); tiers
    of the attention alone, beside GEMM classes at "highest", have no
    gab_narrow form and take the chain."""
    shape = (c, 4, c // 4, c // 4, 17, 4)
    preset = tc.config_for_frames(81, matmul_precision="high",
                                  precision_overrides=PRESET)
    tiers = {op: preset.tier_for(op, "gab0") for op in KERNEL_OPS}
    attn_only = {op: "highest" for op in KERNEL_OPS}
    attn_only.update(attn_score="default", attn_apply="default")
    assert K.gab_route(*shape) == float32_route
    assert K.gab_route(*shape, attn_only) == "chain"
    assert K.gab_route(*shape, tiers) == tiered_route
