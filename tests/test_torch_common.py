"""Shared helpers of the gastx_torch parity tests, and the port's own
contracts: no JAX import, the default device, the launch counters.

The parity tests feed the same numpy-seeded weights and inputs to the JAX
package and to the port on the CPU. Every weight is randomised, BN
statistics, edge logits ``e``, ``C_k`` and biases included, so a folding
or layout bug cannot hide behind the identity-BN / zero-bias defaults of
``init_gastnet``.
"""
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
    seed, as numpy arrays."""
    params, state = jm.init_gastnet(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = np.shape(leaf)
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
    return tm.GastNetConfig(
        num_joints_in=cfg.num_joints_in, num_joints_out=cfg.num_joints_out,
        filter_widths=cfg.filter_widths, channels=cfg.channels,
        causal=cfg.causal, layout=cfg.layout)


def port_model(cfg, params, state):
    """The port's GastNet on the CPU with the JAX weights loaded."""
    model = tm.GastNet(torch_config(cfg))
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


def test_launch_counters_stay_zero_on_cpu():
    """On CPU tensors every wrapper takes its plain version: no kernel is
    built or launched and no counter moves."""
    cfg = jm.GastNetConfig(filter_widths=(3, 3), channels=32, dropout=0.0)
    model = port_model(cfg, *random_jax_tree(cfg, 0))
    K.reset_launches()
    model(torch.from_numpy(inputs((2, 9, 17, 2), 1)))
    assert all(v == 0 for v in K.LAUNCHES.values()), K.LAUNCHES
    assert all(v == 0 for v in K.ENTRY_LAUNCHES.values()), K.ENTRY_LAUNCHES


@pytest.mark.parametrize("frames,causal", [(27, False), (27, True),
                                           (81, False), (243, True)])
def test_config_geometry_matches_jax(frames, causal):
    j = jm.config_for_frames(frames, causal=causal)
    t = tm.config_for_frames(frames, causal=causal)
    assert (t.filter_widths, t.channels, t.layout) == (
        j.filter_widths, j.channels, j.layout)
    assert t.pads() == j.pads()
    assert t.receptive_field() == j.receptive_field()
    for variant in ("dilated", "strided"):
        assert t.causal_shifts(variant) == j.causal_shifts(variant)
    assert [t.block_channels(i) for i in range(t.num_levels)] == [
        j.block_channels(i) for i in range(j.num_levels)]


@pytest.mark.parametrize("layout", ["h36m17", "h36m19", "sh16",
                                    "humaneva15"])
def test_graph_statics_match_jax(layout):
    js, ts = jm.graph_statics(layout), tm.graph_statics(layout)
    assert ts.num_joints == js.num_joints
    np.testing.assert_array_equal(ts.sym_idx, js.sym_idx)
    np.testing.assert_array_equal(ts.con_idx, js.con_idx)
