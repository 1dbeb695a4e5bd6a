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


def torch_config(cfg):
    """The port's config of a JAX one: its structure and its route knobs,
    the ``_interpret`` suffixes stripped (on the port the tensor's device
    picks kernel or plain version). Knobs the port does not carry yet
    raise."""
    if cfg.local_impl != "einsum" or cfg.gab_impl_levels:
        raise ValueError("the port carries neither local_impl nor "
                         "gab_impl_levels")
    return tm.GastNetConfig(
        num_joints_in=cfg.num_joints_in, num_joints_out=cfg.num_joints_out,
        filter_widths=cfg.filter_widths, channels=cfg.channels,
        causal=cfg.causal, dense=cfg.dense, layout=cfg.layout,
        gab_impl=cfg.gab_impl.removesuffix("_interpret"),
        attn_impl=cfg.attn_impl.removesuffix("_interpret"),
        packed_channels=cfg.packed_channels)


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
    """The route knobs cross with their JAX names, the _interpret suffixes
    stripped; knobs the port lacks raise."""
    cfg = jm.GastNetConfig(filter_widths=(3, 3), channels=32,
                           gab_impl="pallas_interpret",
                           attn_impl="pallas_head_interpret",
                           packed_channels=64)
    t = torch_config(cfg)
    assert (t.gab_impl, t.attn_impl, t.packed_channels) == (
        "pallas", "pallas_head", 64)
    assert torch_config(jm.GastNetConfig(
        gab_impl="pallas_local_interpret")).gab_impl == "pallas_local"
    for bad in ({"local_impl": "gather"}, {"gab_impl_levels": ("xla",)}):
        with pytest.raises(ValueError):
            torch_config(jm.GastNetConfig(**bad))


def test_config_rejects_routes_the_port_lacks():
    """``"auto"`` is the default, here and in config_for_frames; values
    with no port route, and packing off ``"pallas"``, raise ValueError,
    and JAX knobs the port does not carry are not fields."""
    assert tm.GastNetConfig().gab_impl == "auto"
    assert tm.config_for_frames(243).gab_impl == "auto"
    for gab_impl in ("auto", "pallas", "pallas_local", "xla"):
        tm.GastNetConfig(gab_impl=gab_impl)
    bad = [{"gab_impl": v} for v in (
        "pallas_interpret", "pallas_local_interpret", "pallas_level",
        "pallas_level_interpret", "pallas_pbatch", "pallas_pbatch_interpret",
        "")]
    bad += [{"attn_impl": v} for v in ("batched", "pallas_head_interpret")]
    bad += [{"gab_impl": "pallas", "packed_channels": v}
            for v in (-1, 1.5, True)]
    # Packing needs "pallas": the JAX package also packs under "auto" on a
    # TPU, which on Hopper would only take levels off the level kernels.
    bad += [{"gab_impl": v, "packed_channels": 64}
            for v in ("auto", "pallas_local", "xla")]
    for kw in bad:
        with pytest.raises(ValueError):
            tm.GastNetConfig(**kw)
    for kw in ({"local_impl": "gather"}, {"gab_impl_levels": ("pallas",)}):
        with pytest.raises(TypeError):
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
