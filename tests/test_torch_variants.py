"""The port's strided and dense forwards and its 15/16/19-joint layouts
against the JAX package's ``gastnet_forward`` on the CPU, on numpy-seeded
weights and inputs, with the JAX side on its XLA route and on the routes
that run its Pallas kernels in interpret mode.

Tolerance: atol 2e-5, rtol 1e-4 (both sides float32; only the order of
summation differs).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models as jm
import gastx_torch.models as tm
from gastx_torch.io import params_from_jax
from test_torch_common import (assert_close, inputs, port_model,
                               random_jax_tree)


# The JAX forward, compiled once per config, variant and shape.
jax_forward = jax.jit(jm.gastnet_forward,
                      static_argnames=("cfg", "variant", "train"))


@functools.lru_cache(maxsize=None)
def _weights(cfg):
    """One weight draw per config for the whole module (configs are
    frozen dataclasses)."""
    params, state = random_jax_tree(cfg, seed=40)
    return params, state, port_model(cfg, params, state)


# channels=16: GABs at C = 16, 32 (gab_narrow's widths on the card);
# channels=128: C = 128, 256 (the chain).
STRIDED = {"C16": dict(filter_widths=(3, 3), channels=16),
           "C128": dict(filter_widths=(3, 3), channels=128)}
# The JAX routes the strided cases are held to: XLA; every GAB through
# fused_gab (interpret); and, at C=16 alone (it packs widths below 128),
# every GAB through fused_gab_pbatch, the TPU counterpart of gab_narrow
# (graph.py's pbatch route).
JAX_ROUTES = {"xla": "xla", "fused_gab": "pallas_interpret",
              "pbatch": "pallas_pbatch_interpret"}


@functools.lru_cache(maxsize=None)
def _strided_port(name, causal, windows):
    """The port's kernel-route and reference strided forwards (B=2) on T =
    ``windows`` receptive fields, with their input."""
    cfg = jm.GastNetConfig(**STRIDED[name], dropout=0.0, causal=causal)
    _, _, model = _weights(cfg)
    x = inputs((2, windows * cfg.receptive_field(), 17, 2), 41)
    xt = torch.from_numpy(x)
    return (cfg, x, model(xt, variant="strided"),
            model.reference_forward(xt, variant="strided"))


# (width, JAX route, windows of rf frames): the XLA route at T = rf and
# 2 rf, the interpret routes (several seconds a shape) at T = 2 rf.
STRIDED_CASES = [("C16", "xla", 1), ("C16", "xla", 2),
                 ("C16", "fused_gab", 2), ("C16", "pbatch", 2),
                 ("C128", "xla", 1), ("C128", "xla", 2),
                 ("C128", "fused_gab", 2)]


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
@pytest.mark.parametrize("name,route,windows", STRIDED_CASES, ids=[
    f"{n}-{r}-T={w}rf" for n, r, w in STRIDED_CASES])
def test_strided_forward_matches_gastnet_forward(name, route, windows,
                                                 causal):
    cfg, x, got, ref = _strided_port(name, causal, windows)
    params, state, _ = _weights(cfg)
    # Op by op, the interpret routes' compiled primitives are shared by
    # the causal and non-causal configs; under jit they would not be.
    fwd = jax_forward if route == "xla" else jm.gastnet_forward
    want, _ = fwd(params, state, jnp.asarray(x),
                  cfg=dataclasses.replace(cfg, gab_impl=JAX_ROUTES[route]),
                  variant="strided", train=False)
    assert got.shape == (2, windows, 17, 3)
    assert_close(got, want)
    assert_close(ref, want)


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_strided_input_lengths_match_gastnet_forward(causal):
    """T = 1, rf - 1, rf to rf + 3 and 2 rf - 1, 2 rf: the port's forward
    runs exactly where the JAX strided forward traces, with the same
    output length (its shapes from ``jax.eval_shape``), and raises
    ValueError elsewhere."""
    cfg = jm.GastNetConfig(filter_widths=(3, 3), channels=8, dropout=0.0,
                           causal=causal)
    params, state, model = _weights(cfg)
    rf = cfg.receptive_field()
    for t in (1, rf - 1, rf, rf + 1, rf + 2, rf + 3, 2 * rf - 1, 2 * rf):
        try:
            want = jax.eval_shape(
                lambda v: jm.gastnet_forward(params, state, v, cfg,
                                             variant="strided")[0],
                jax.ShapeDtypeStruct((1, t, 17, 2), jnp.float32)).shape
        except (TypeError, ValueError, AssertionError):
            want = None
        x = torch.from_numpy(inputs((1, t, 17, 2), t))
        if want is None or want[1] < 1:
            with pytest.raises(ValueError):
                model(x, variant="strided")
        else:
            assert tuple(model(x, variant="strided").shape) == want, t


# The dense config of the JAX package's own reference test
# (tests/test_ablations.py::test_dense_variant_matches_reference).
DENSE = dict(filter_widths=(3, 3), channels=32, dropout=0.0, dense=True)


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_dense_forward_matches_gastnet_forward(causal):
    cfg = jm.GastNetConfig(**DENSE, causal=causal)
    params, state, model = _weights(cfg)
    assert model.layers_conv[0].weight.shape[2] == 2 * cfg.pads()[1] + 1
    x = inputs((2, cfg.receptive_field() + 4, 17, 2), 42)
    want, _ = jax_forward(params, state, jnp.asarray(x), cfg=cfg,
                          variant="dilated", train=False)
    xt = torch.from_numpy(x)
    for route in ("auto", "pallas"):
        got = port_model(cfg, params, state, gab_impl=route)(xt)
        assert_close(got, want)
    assert_close(model.reference_forward(xt), want)
    with pytest.raises(ValueError):
        model(xt[:, :cfg.receptive_field()], variant="strided")


def test_build_gastnet_takes_the_jax_shapes():
    """``build_gastnet`` and ``params_from_jax`` give the same tensor
    shapes for a dense model on the 19-joint layout (its edge-logit
    counts and its dense conv widths)."""
    cfg = jm.GastNetConfig(num_joints_in=19, num_joints_out=19,
                           filter_widths=(3, 3, 3), channels=8, dense=True,
                           layout="h36m19")
    params, state = random_jax_tree(cfg, seed=43)
    sd = params_from_jax(params, state, cfg)
    built = tm.build_gastnet(dataclasses.replace(
        tm.config_for_frames(27, 19), channels=8, dense=True),
        device="cpu").state_dict()
    assert sorted(built) == sorted(sd)
    for key, value in sd.items():
        assert built[key].shape == value.shape, key


# Layouts: (layout, joints); 17 joints are every other test's. The JAX
# side runs its level kernels (fused_level0, fused_level) in interpret
# mode, the one CPU route they run on, at T short enough for their VMEM
# gate.
LAYOUTS = {"humaneva15": 15, "sh16": 16, "h36m19": 19}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_forward_matches_gastnet_forward(layout):
    j = LAYOUTS[layout]
    cfg = jm.GastNetConfig(num_joints_in=j, num_joints_out=j,
                           filter_widths=(3, 3), channels=32, dropout=0.0,
                           layout=layout)
    params, state, model = _weights(cfg)
    x = inputs((2, cfg.receptive_field() + 2, j, 2), 44)
    want, _ = jax_forward(
        params, state, jnp.asarray(x),
        cfg=dataclasses.replace(cfg, gab_impl="pallas_level_interpret"),
        variant="dilated", train=False)
    xt = torch.from_numpy(x)
    assert_close(model(xt), want)
    assert_close(model.reference_forward(xt), want)
    np.testing.assert_array_equal(model.statics.sym_idx,
                                  jm.graph_statics(layout).sym_idx)
