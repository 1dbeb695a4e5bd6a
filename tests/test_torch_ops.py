"""The port's plain ops (gastx_torch.ops) against the JAX package's XLA
path on the CPU, on numpy-seeded weights and inputs.

Tolerance: atol 2e-5, rtol 1e-4 (both sides float32; only the order of
summation differs between XLA:CPU and ATen).
"""
import jax.numpy as jnp
import pytest
import torch

import gastx.models as jm
from gastx.ops import graph as JG
from gastx.ops.batchnorm import batch_norm as j_batch_norm
from gastx.ops.temporal import pointwise as j_pointwise
from gastx.ops.temporal import temporal_conv as j_temporal_conv
from gastx_torch.ops import graph as TG
from gastx_torch.ops.batchnorm import batch_norm
from gastx_torch.ops.temporal import (pconv_weight, pointwise, tconv_weight,
                                      temporal_conv)
from test_torch_common import (assert_close, inputs, port_model,
                               random_jax_tree)

CFG = jm.GastNetConfig(filter_widths=(3, 3), channels=32, dropout=0.0)


@pytest.fixture(scope="module")
def weights():
    params, state = random_jax_tree(CFG, seed=7)
    return params, state, port_model(CFG, params, state)


def test_batch_norm_eval(weights):
    params, state, model = weights
    x = inputs((2, 5, 17, 32), 1)
    want, _ = j_batch_norm(jnp.asarray(x), params["expand_bn"],
                           state["expand_bn"], train=False)
    assert_close(batch_norm(torch.from_numpy(x), model.expand_bn), want)


@pytest.mark.parametrize("dilation", [1, 3])
def test_temporal_conv_dilated(weights, dilation):
    params, _, model = weights
    x = inputs((2, 11, 17, 64), 2)
    w = params["temporal"][0]["conv_t"]["w"]
    want = j_temporal_conv(jnp.asarray(x), jnp.asarray(w), dilation=dilation)
    got = temporal_conv(torch.from_numpy(x),
                        tconv_weight(model.layers_conv[0]), dilation=dilation)
    assert_close(got, want)


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("dilation", [1, 3])
@pytest.mark.parametrize("extra", [0, 5], ids=["T=span", "T=span+5"])
def test_temporal_conv_strided(weights, stride, dilation, extra):
    """The strided conv's length and taps against the JAX VALID conv: T the
    conv's span exactly (one frame out) and a T that leaves the last
    stride ragged."""
    params, _, model = weights
    span = 2 * dilation + 1
    x = inputs((2, span + extra, 17, 64), 4)
    w = params["temporal"][0]["conv_t"]["w"]
    want = j_temporal_conv(jnp.asarray(x), jnp.asarray(w), dilation=dilation,
                           stride=stride)
    got = temporal_conv(torch.from_numpy(x),
                        tconv_weight(model.layers_conv[0]), dilation=dilation,
                        stride=stride)
    assert got.shape == want.shape
    assert_close(got, want)


def test_pointwise(weights):
    params, _, model = weights
    x = inputs((2, 3, 17, 64), 3)
    want = j_pointwise(jnp.asarray(x),
                       jnp.asarray(params["temporal"][0]["conv_1"]["w"]))
    assert_close(pointwise(torch.from_numpy(x),
                           pconv_weight(model.layers_conv[1])), want)


@pytest.mark.parametrize("branch", ["sym", "con"])
def test_sem_ch_graph_conv(weights, branch):
    params, _, model = weights
    statics = jm.graph_statics(CFG.layout)
    idx = statics.sym_idx if branch == "sym" else statics.con_idx
    x = inputs((2, 3, 17, 32), 4)
    want = JG.sem_ch_graph_conv(jnp.asarray(x),
                                params["gabs"][0]["local"][branch], idx, 17)
    gcn = getattr(model.layers_graph_conv[0].local_graph_layer,
                  f"gcn_{branch}")
    assert_close(TG.sem_ch_graph_conv(torch.from_numpy(x), gcn.W, gcn.e,
                                      idx, 17), want)


def test_local_graph(weights):
    params, state, model = weights
    statics = jm.graph_statics(CFG.layout)
    x = inputs((2, 3, 17, 32), 5)
    want, _ = JG.local_graph(jnp.asarray(x), params["gabs"][0]["local"],
                             state["gabs"][0]["local"], statics, train=False,
                             dropout_rate=0.0)
    got = TG.local_graph(torch.from_numpy(x),
                         model.layers_graph_conv[0].local_graph_layer,
                         model.statics)
    assert_close(got, want)


@pytest.mark.parametrize("level", [0, 1])
def test_multi_global_graph(weights, level):
    params, state, model = weights
    c = CFG.block_channels(level)
    x = inputs((2, 3, 17, c), 6)
    want, _ = JG.multi_global_graph(
        jnp.asarray(x), params["gabs"][level]["global"],
        state["gabs"][level]["global"], train=False, dropout_rate=0.0)
    got = TG.multi_global_graph(
        torch.from_numpy(x),
        model.layers_graph_conv[level].global_graph_layer)
    assert_close(got, want)


@pytest.mark.parametrize("level", [0, 1])
def test_graph_attention_block(weights, level):
    params, state, model = weights
    c = CFG.block_channels(level)
    x = inputs((2, 4, 17, c), 8)
    want, _ = JG.graph_attention_block(
        jnp.asarray(x), params["gabs"][level], state["gabs"][level],
        jm.graph_statics(CFG.layout), train=False, dropout_rate=0.0)
    got = TG.graph_attention_block(torch.from_numpy(x),
                                   model.layers_graph_conv[level],
                                   model.statics)
    assert_close(got, want)
