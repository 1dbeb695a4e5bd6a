"""The port's StreamingLifter against the JAX package's on the CPU, on
numpy-seeded weights and keypoints, mirroring ``tests/test_streaming.py``
on its config (8 channels, filter widths (3, 3), 15 joints, causal).

Tolerance: atol 2e-5, rtol 1e-4 against JAX (both sides float32; only the
order of summation differs). Within the port: batched streams against
independent ones at atol 1e-6, push_async against push exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models as jm
from gastx.infer.streaming import StreamingLifter as JaxStreamingLifter
from gastx_torch.infer import StreamingLifter
from test_torch_common import (assert_close, inputs, port_model,
                               random_jax_tree)

CFG = jm.GastNetConfig(num_joints_in=15, num_joints_out=15,
                       filter_widths=(3, 3), channels=8, dropout=0.0,
                       causal=True, layout="humaneva15")
J = 15


@pytest.fixture(scope="module")
def weights():
    params, state = random_jax_tree(CFG, seed=50)
    return params, state, port_model(CFG, params, state)


def test_streaming_matches_jax_streaming_lifter(weights):
    """30 pushes: the port's lifter against the JAX lifter on the same
    weights, and both against the strided forward on the edge-padded
    windows lifted offline."""
    params, state, model = weights
    t = 30
    seq = inputs((t, J, 2), 51)
    lifter = StreamingLifter(model, num_person=1)
    jax_lifter = JaxStreamingLifter(params, state, CFG, num_person=1)
    got = np.stack([lifter.push(seq[i][None])[0] for i in range(t)])
    want = np.stack([jax_lifter.push(seq[i][None])[0] for i in range(t)])
    assert_close(got, want)

    rf = CFG.receptive_field()
    padded = np.concatenate([np.repeat(seq[:1], rf - 1, axis=0), seq])
    windows = np.stack([padded[i:i + rf] for i in range(t)])
    offline, _ = jm.gastnet_forward(params, state, jnp.asarray(windows), CFG,
                                    variant="strided", train=False)
    assert_close(got, np.asarray(offline)[:, 0])
    plain = model.reference_forward(torch.from_numpy(windows),
                                    variant="strided")[:, 0]
    assert_close(got, plain.numpy())


def test_streaming_multi_person(weights):
    params, state, model = weights
    lifter = StreamingLifter(model, num_person=2)
    jax_lifter = JaxStreamingLifter(params, state, CFG, num_person=2)
    for i in range(3):
        frame = inputs((2, J, 2), 52 + i)
        out = lifter.push(frame)
        assert out.shape == (2, J, 3)
        assert np.isfinite(out).all()
        assert_close(out, np.asarray(jax_lifter.push(frame)))


def test_streaming_batched_streams_equal_independent(weights):
    """Axis 0 of the window is a batch of independent streams: a batched
    lifter evolves as separate single-stream lifters do."""
    _, _, model = weights
    s, t = 3, 8
    frames = inputs((t, s, J, 2), 53)
    batched = StreamingLifter(model, num_person=s)
    singles = [StreamingLifter(model, num_person=1) for _ in range(s)]
    for i in range(t):
        out_b = batched.push(frames[i])
        out_s = np.concatenate([singles[k].push(frames[i, k][None])
                                for k in range(s)])
        np.testing.assert_allclose(out_b, out_s, atol=1e-6)


def test_push_async_matches_push(weights):
    """push_async returns the tensor on the model's device, and deferring
    the host copy leaves the window evolving as push does."""
    _, _, model = weights
    frames = inputs((6, 1, J, 2), 54)
    sync_lifter = StreamingLifter(model, num_person=1)
    async_lifter = StreamingLifter(model, num_person=1)
    sync_out = [sync_lifter.push(f) for f in frames]
    handles = [async_lifter.push_async(f) for f in frames]
    for a, b in zip(sync_out, handles):
        assert isinstance(b, torch.Tensor) and b.device == torch.device("cpu")
        np.testing.assert_array_equal(a, b.numpy())


def test_streaming_reset_starts_a_new_stream(weights):
    """After reset the next push edge-pads anew: the lifter gives what a
    fresh one gives."""
    _, _, model = weights
    frames = inputs((5, 1, J, 2), 55)
    lifter = StreamingLifter(model, num_person=1)
    for f in frames[:3]:
        lifter.push(f)
    lifter.reset()
    fresh = StreamingLifter(model, num_person=1)
    for f in frames[3:]:
        np.testing.assert_array_equal(lifter.push(f), fresh.push(f))
    with pytest.raises(ValueError):
        lifter.push(inputs((2, J, 2), 56))


def test_streaming_requires_causal(weights):
    params, state, _ = weights
    cfg = dataclasses.replace(CFG, causal=False)
    with pytest.raises(ValueError, match="causal"):
        StreamingLifter(port_model(cfg, params, state))
