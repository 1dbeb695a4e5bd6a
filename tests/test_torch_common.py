"""Shared helpers of the gastx_torch parity tests, and the port's own
contracts: no JAX import, the default device, the launch counters.

The parity tests feed the same numpy-seeded weights and inputs to the JAX
package and to the port on the CPU. Every weight is randomised, BN
statistics, edge logits ``e``, ``C_k`` and biases included, so a folding
or layout bug cannot hide behind the identity-BN / zero-bias defaults of
``init_gastnet``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gastx.models as jm
import gastx_torch.models as tm
from gastx_torch.io import params_from_jax
from gastx_torch.ops.cuda import kernels as K

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Both sides compute in float32; only the order of summation differs
# between XLA:CPU and ATen, so the port is held to the JAX output at
# atol 2e-5, rtol 1e-4.
ATOL, RTOL = 2e-5, 1e-4

_FAN_IN_LAST2 = ("theta_w", "phi_w", "g_w")


def _leaf_name(path):
    names = [p.key for p in path if isinstance(p, jax.tree_util.DictKey)]
    return names[-1]


def random_jax_tree(cfg, seed):
    """JAX (params, state) of ``cfg`` with every leaf drawn from a numpy
    seed, as numpy arrays. Only the tree's shapes are taken from
    ``init_gastnet`` (traced, not run)."""
    params, state = jax.eval_shape(
        lambda: jm.init_gastnet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        if name in ("var", "scale"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("mean", "bias", "theta_b", "phi_b", "g_b", "C_k"):
            v = 0.1 * rng.standard_normal(shape)
        elif name == "e":
            v = rng.standard_normal(shape)
        else:
            if name in _FAN_IN_LAST2:
                fan_in = shape[-2]
            elif name in ("proj_theta", "proj_phi"):
                fan_in = 2 * shape[-1]
            else:
                fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        return np.asarray(v, np.float32)

    with_path = jax.tree_util.tree_map_with_path
    return with_path(draw, params), with_path(draw, state)


# The JAX config's fields that do not cross: the precision tiers, whose
# defaults differ by design (the port's stay float32 until its own cert;
# every tier computes float32 on the CPU on both sides).
NOT_CROSSED = ("matmul_precision", "precision_overrides")


def torch_config(cfg):
    """The port's config of a JAX one, field for field: its structure,
    routes (the ``_interpret`` suffixes too: on the port they run every
    wrapper's plain version), forms and storage, all but ``NOT_CROSSED``.
    Values the port does not carry raise."""
    return tm.GastNetConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)
                               if f.name not in NOT_CROSSED})


def port_model(cfg, params, state, **route):
    """The port's GastNet on the CPU with the JAX weights loaded, on the
    route of ``cfg`` with the fields in ``route`` replaced. The port's
    kernel route is ``gab_impl="auto"``; a bare JAX config's default
    ``"xla"`` computes the same function."""
    model = tm.GastNet(dataclasses.replace(torch_config(cfg), **route))
    model.load_state_dict(params_from_jax(params, state, cfg), strict=True)
    return model.eval()


def inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_port_imports_neither_jax_nor_gastx():
    """A fresh process imports every module of gastx_torch and chip_smoke;
    neither jax nor any gastx module may then be loaded."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import gastx_torch\n"
        "for m in pkgutil.walk_packages(gastx_torch.__path__, "
        "'gastx_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'gastx_torch.infer.streaming' in sys.modules\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'gastx') or "
        "m.startswith(('jax.', 'gastx.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_raises_without_gpu(monkeypatch):
    from gastx_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        tm.build_gastnet(tm.config_for_frames(27))
    assert resolve_device("cpu") == torch.device("cpu")


ROUTES = ({"gab_impl": "auto"}, {"gab_impl": "pallas"},
          {"gab_impl": "pallas_local", "attn_impl": "pallas_head"},
          {"gab_impl": "xla", "attn_impl": "pallas_head"},
          {"gab_impl": "pallas", "packed_channels": 64})


def test_launch_counters_stay_zero_on_cpu():
    """On CPU tensors every wrapper takes its plain version, on every
    route and through every entry point called alone: no kernel is built
    or launched and no counter moves."""
    from gastx_torch.ops.cuda.fused_gab import (fused_gab_packed,
                                                fused_local_branch,
                                                gab_tables, local_tables)
    from gastx_torch.ops.cuda.global_attn import (fused_global_attention,
                                                  global_tables)

    cfg = jm.GastNetConfig(filter_widths=(3, 3), channels=32, dropout=0.0)
    params, state = random_jax_tree(cfg, 0)
    x = torch.from_numpy(inputs((2, 9, 17, 2), 1))
    K.reset_launches()
    for route in ROUTES:
        model = port_model(cfg, params, state, **route)
        model(x)
    gab = model.layers_graph_conv[0]
    h = torch.from_numpy(inputs((2, 3, 17, 32), 2))
    fused_local_branch(h, local_tables(gab.local_graph_layer, model.statics))
    fused_global_attention(h, global_tables(gab.global_graph_layer))
    fused_gab_packed(h.reshape(2, 3, -1), gab_tables(gab, model.statics), 17)
    assert set(K.ENTRY_LAUNCHES) == set(K.ENTRY_POINTS)
    assert all(v == 0 for v in K.LAUNCHES.values()), K.LAUNCHES
    assert all(v == 0 for v in K.ENTRY_LAUNCHES.values()), K.ENTRY_LAUNCHES


def test_torch_config_carries_the_routes():
    """Every JAX config crosses field for field, the shipped ones included
    (both presets, and each ``config_for_frames(gab_impl=)``); the port
    raises on the forms the JAX package ships no route for."""
    cfg = jm.GastNetConfig(filter_widths=(3, 3), channels=32,
                           gab_impl="pallas_interpret",
                           attn_impl="pallas_head_interpret",
                           packed_channels=64)
    t = torch_config(cfg)
    assert (t.gab_impl, t.attn_impl, t.packed_channels) == (
        "pallas_interpret", "pallas_head_interpret", 64)
    full = jm.GastNetConfig(
        filter_widths=(3, 3, 3), local_impl="gather", attn_impl="batched",
        gab_impl="pallas_pbatch_interpret",
        gab_impl_levels=("xla", "", "pallas_level"),
        gab_kernel_form="fold", gab_kernel_form_levels=("v1", "inherit"),
        storage_dtype="bfloat16", storage_dtype_levels=("", "float32"),
        gab_io_dtype="bfloat16", gab_softmax_group=2, gab_tile_budget=2048,
        gab_pbatch_max_pack=2)
    shipped = [jm.config_for_frames(f, j, precision_overrides=o,
                                    gab_impl=g)
               for f in (27, 81, 243) for j in (17, 16)
               for o in ((), jm.TPU_MIXED_PRECISION_OVERRIDES)
               for g in ("auto", "pallas", "xla")]
    for jc in [cfg, full] + shipped:
        t = torch_config(jc)
        for f in dataclasses.fields(jc):
            if f.name not in NOT_CROSSED:
                assert getattr(t, f.name) == getattr(jc, f.name), f.name
    for bad in ({"gab_kernel_form": "v2"},
                {"gab_kernel_form_levels": ("v2",)},
                {"gab_apply_block": True}, {"gab_score_block": True}):
        with pytest.raises(ValueError, match="queue 2 B3"):
            torch_config(jm.GastNetConfig(**bad))


def test_config_rejects_routes_the_port_lacks():
    """``"auto"`` is the default, here and in config_for_frames, and every
    JAX value is accepted; unknown values, the forms with no shipped route
    (``v2``, ``apply_block``, ``score_block``), ``gab_impl_levels`` with
    ``packed_channels`` and bad counts raise ValueError."""
    assert tm.GastNetConfig().gab_impl == "auto"
    assert tm.config_for_frames(243).gab_impl == "auto"
    for gab_impl in tm.config.VALID_GAB_IMPLS:
        tm.GastNetConfig(gab_impl=gab_impl, gab_impl_levels=(gab_impl,))
    for attn_impl in ("einsum", "batched", "pallas_head",
                      "pallas_head_interpret"):
        tm.GastNetConfig(attn_impl=attn_impl)
    for gab_impl in ("auto", "pallas", "pallas_local", "xla"):
        tm.GastNetConfig(gab_impl=gab_impl, packed_channels=64)
    tm.GastNetConfig(local_impl="gather", gab_kernel_form="fold",
                     gab_kernel_form_levels=("", "inherit", "v1"),
                     storage_dtype="auto", storage_dtype_levels=("bfloat16",),
                     gab_io_dtype="bfloat16", gab_softmax_group=1,
                     gab_tile_budget=1024, gab_pbatch_max_pack=4)
    bad = [{"gab_impl": v} for v in ("pallas_head", "")]
    bad += [{"attn_impl": v} for v in ("xla", "batched_interpret")]
    bad += [{"local_impl": "pallas"}, {"storage_dtype": "float16"},
            {"gab_io_dtype": "auto"}, {"gab_kernel_form": "v3"}]
    bad += [{"gab_impl_levels": ("pallas_head",)},
            {"gab_impl_levels": ("", "", "", "")},
            {"gab_kernel_form_levels": ("v3",)},
            {"storage_dtype_levels": ("float16",)},
            {"storage_dtype_levels": ["bfloat16"]}]
    bad += [{"gab_kernel_form": "v2"}, {"gab_kernel_form_levels": ("v2",)},
            {"gab_apply_block": True}, {"gab_score_block": True}]
    bad += [{"gab_impl": "pallas", "packed_channels": v}
            for v in (-1, 1.5, True)]
    bad += [{"gab_softmax_group": -1}, {"gab_tile_budget": 1.5},
            {"gab_pbatch_max_pack": True}]
    # As in JAX: the packed prefix routes off gab_impl alone.
    bad += [{"packed_channels": 64, "gab_impl_levels": ("pallas",)},
            {"packed_channels": 64, "storage_dtype_levels": ("bfloat16",)}]
    for kw in bad:
        with pytest.raises(ValueError):
            tm.GastNetConfig(**kw)


@pytest.mark.parametrize("frames,joints,causal,dense", [
    (27, 17, False, False), (27, 17, True, False), (81, 17, False, False),
    (243, 17, True, False), (27, 15, True, False), (81, 16, False, True),
    (243, 19, True, True), (27, 17, False, True)],
    ids=["27-False", "27-True", "81-False", "243-True", "27-J15-causal",
         "81-J16-dense", "243-J19-causal-dense", "27-dense"])
def test_config_geometry_matches_jax(frames, joints, causal, dense):
    """Pads, receptive field, shifts, widths and each level's temporal conv
    width (the JAX init's ``conv_t`` taps, dense or not) on every layout."""
    j = dataclasses.replace(jm.config_for_frames(frames, joints,
                                                 causal=causal), dense=dense)
    t = dataclasses.replace(tm.config_for_frames(frames, joints,
                                                 causal=causal), dense=dense)
    assert (t.filter_widths, t.channels, t.layout) == (
        j.filter_widths, j.channels, j.layout)
    assert t.pads() == j.pads()
    assert t.receptive_field() == j.receptive_field()
    for variant in ("dilated", "strided"):
        assert t.causal_shifts(variant) == j.causal_shifts(variant)
    assert [t.block_channels(i) for i in range(t.num_levels)] == [
        j.block_channels(i) for i in range(j.num_levels)]
    params = jax.eval_shape(lambda: jm.init_gastnet(jax.random.PRNGKey(0),
                                                    j))[0]
    assert [t.conv_width(i) for i in range(1, t.num_levels)] == [
        p["conv_t"]["w"].shape[0] for p in params["temporal"]]


@pytest.mark.parametrize("layout", ["h36m17", "h36m19", "sh16",
                                    "humaneva15"])
def test_graph_statics_match_jax(layout):
    js, ts = jm.graph_statics(layout), tm.graph_statics(layout)
    assert ts.num_joints == js.num_joints
    np.testing.assert_array_equal(ts.sym_idx, js.sym_idx)
    np.testing.assert_array_equal(ts.con_idx, js.con_idx)
