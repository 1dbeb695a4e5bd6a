"""The port's model, weight bridge, lifting, geometry, data and CLI against
the JAX package on the CPU, on numpy-seeded weights and inputs.

Tolerance: atol 2e-5, rtol 1e-4 (both sides float32; only the order of
summation differs between XLA:CPU and ATen).
"""
import collections
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models as jm
from gastx.data import coco_h36m as j_coco_h36m
from gastx.geometry import camera_to_world as j_camera_to_world
from gastx.geometry import normalize_screen_coordinates as j_normalize
from gastx.infer import lift_sequences as j_lift_sequences
from gastx.infer import lift_to_world as j_lift_to_world
from gastx.io import state_dict_from_params
from gastx_torch.data import (coco_h36m, load_keypoints_json,
                              save_keypoints_json)
from gastx_torch.geometry import camera_to_world, normalize_screen_coordinates
from gastx_torch.infer import lift_sequences, lift_to_world
from gastx_torch.io import params_from_jax
from gastx_torch.models import GastNet
from test_torch_common import (assert_close, inputs, port_model,
                               random_jax_tree, torch_config)

SMALL = jm.GastNetConfig(filter_widths=(3, 3, 3), channels=16, dropout=0.0)


def test_params_from_jax_matches_state_dict_from_params():
    """The bridge gives the JAX package's own export, key for key and value
    for value, and it loads into GastNet with strict=True."""
    params, state = random_jax_tree(SMALL, seed=1)
    want = state_dict_from_params(params, state, SMALL)
    got = params_from_jax(params, state, SMALL)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert tuple(got[key].shape) == np.shape(value), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                      err_msg=key)
    model = GastNet(torch_config(SMALL))
    assert sorted(model.state_dict()) == sorted(want)
    model.load_state_dict(got, strict=True)


F81 = dict(filter_widths=(3, 3, 3, 3), channels=64, dropout=0.0)
F243 = dict(filter_widths=(3, 3, 3, 3, 3), channels=32, dropout=0.0)


@pytest.mark.parametrize("cfg,batch,extra", [
    (SMALL, 2, 4),
    (jm.GastNetConfig(filter_widths=(3, 3, 3), channels=16, dropout=0.0,
                      causal=True), 2, 4),
    (jm.GastNetConfig(dropout=0.0), 2, 4),
    (jm.GastNetConfig(**F81), 1, 2),
    (jm.GastNetConfig(**F81, causal=True), 1, 2),
    (jm.GastNetConfig(**F243), 1, 2),
], ids=["small", "small-causal", "27f-full-width", "81f-full-width",
        "81f-causal-full-width", "243f-full-width"])
def test_forward_matches_gastnet_forward(cfg, batch, extra):
    """Both of the port's forwards (the kernel route, which takes its plain
    versions on the CPU, and the unfused reference) against the JAX eval
    forward (XLA, float32), on ``batch`` windows of the receptive field
    plus ``extra`` frames."""
    params, state = random_jax_tree(cfg, seed=2)
    model = port_model(cfg, params, state, gab_impl="auto")
    x = inputs((batch, cfg.receptive_field() + extra, 17, 2), 3)
    want, _ = jm.gastnet_forward(params, state, jnp.asarray(x), cfg,
                                 variant="dilated", train=False)
    xt = torch.from_numpy(x)
    assert_close(model(xt), want)
    assert_close(model.reference_forward(xt), want)


ROUTE_CFG = jm.GastNetConfig(filter_widths=(3, 3, 3), channels=32,
                             dropout=0.0)


@pytest.fixture(scope="module")
def route_weights():
    return random_jax_tree(ROUTE_CFG, seed=20)


@pytest.mark.parametrize("port_route,jax_route", [
    ({"gab_impl": "pallas_local", "attn_impl": "pallas_head"},
     {"gab_impl": "pallas_local_interpret",
      "attn_impl": "pallas_head_interpret"}),
    ({"gab_impl": "xla", "attn_impl": "pallas_head"},
     {"gab_impl": "xla", "attn_impl": "pallas_head_interpret"}),
    ({"gab_impl": "pallas", "packed_channels": 32},
     {"gab_impl": "pallas_interpret", "packed_channels": 32}),
    ({"gab_impl": "pallas", "packed_channels": 64},
     {"gab_impl": "pallas_interpret", "packed_channels": 64}),
], ids=["hybrid-head", "xla-head", "packed32", "packed64"])
def test_route_forward_matches_gastnet_forward(route_weights, port_route,
                                               jax_route):
    """The port's other routes (widths C = 32, 64, 128) against the JAX
    forward on the same route, its Pallas kernels in interpret mode."""
    params, state = route_weights
    model = port_model(ROUTE_CFG, params, state, **port_route)
    x = inputs((2, 29, 17, 2), 21)
    want, _ = jm.gastnet_forward(
        params, state, jnp.asarray(x),
        dataclasses.replace(ROUTE_CFG, **jax_route), variant="dilated",
        train=False)
    assert_close(model(torch.from_numpy(x)), want)


# Entry-point calls of one forward of the C = 32, 64, 128 model, by route
# (the JAX package's gates: level kernels under "auto" only; packing
# under "pallas" alone, at the widths up to packed_channels; 4 heads).
ROUTE_CALLS = [
    ({"gab_impl": "auto"}, {"fused_level0": 1, "fused_level": 2}),
    ({"gab_impl": "pallas"}, {"fused_gab": 3}),
    ({"gab_impl": "pallas_local", "attn_impl": "pallas_head"},
     {"fused_local_branch": 3, "head_attention": 12}),
    ({"gab_impl": "pallas_local"}, {"fused_local_branch": 3}),
    ({"gab_impl": "xla", "attn_impl": "pallas_head"},
     {"head_attention": 12}),
    ({"gab_impl": "xla"}, {}),
    ({"gab_impl": "pallas", "packed_channels": 64},
     {"fused_gab_packed": 2, "fused_gab": 1}),
    ({"gab_impl": "pallas", "packed_channels": 32},
     {"fused_gab_packed": 1, "fused_gab": 2}),
    ({"gab_impl": "pallas", "packed_channels": 16}, {"fused_gab": 3}),
]


def test_routes_call_their_entry_points(route_weights, monkeypatch):
    """Which wrapper each route reaches: the parity tests cannot tell, as
    every route computes the same function."""
    import gastx_torch.models.gastnet as G

    calls = collections.Counter()

    def spy(mod, name):
        fn = getattr(mod, name)

        def counted(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, counted)

    for mod, name in ((G, "fused_level0"), (G, "fused_level"),
                      (G, "fused_gab"), (G, "fused_gab_packed"),
                      (G, "fused_local_branch"), (G, "head_attention")):
        spy(mod, name)
    x = torch.from_numpy(inputs((1, 27, 17, 2), 22))
    for route, want in ROUTE_CALLS:
        calls.clear()
        port_model(ROUTE_CFG, *route_weights, **route)(x)
        assert dict(calls) == want, route


@pytest.fixture(scope="module")
def lifting_weights():
    params, state = random_jax_tree(SMALL, seed=4)
    return params, state, port_model(SMALL, params, state, gab_impl="auto")


def test_lift_sequences_tta_ragged(lifting_weights):
    """Two ragged sequences in two length buckets, with flip TTA."""
    params, state, model = lifting_weights
    seqs = [inputs((30, 17, 2), 5), inputs((70, 17, 2), 6)]
    want = j_lift_sequences(params, state, seqs, SMALL, tta=True)
    got = lift_sequences(model, seqs, tta=True)
    for g, w, s in zip(got, want, seqs):
        assert g.shape == (s.shape[0], 17, 3)
        assert_close(g, w)


def test_lift_sequences_kps_lr(lifting_weights):
    """A 2D joint order whose mirror columns differ from the layout's."""
    params, state, model = lifting_weights
    seqs = [inputs((12, 17, 2), 7)]
    kps_lr = ([1, 2, 3, 4], [5, 6, 7, 8])
    want = j_lift_sequences(params, state, seqs, SMALL, kps_lr=kps_lr)
    assert_close(lift_sequences(model, seqs, kps_lr=kps_lr)[0], want[0])


def test_lift_to_world(lifting_weights):
    params, state, model = lifting_weights
    seqs = [inputs((20, 17, 2), 8)]
    want = j_lift_to_world(params, state, seqs, SMALL)
    assert_close(lift_to_world(model, seqs)[0], want[0])


def test_geometry_matches_jax():
    rng = np.random.default_rng(9)
    q = rng.standard_normal(4).astype(np.float32)
    q /= np.linalg.norm(q)
    pts = rng.standard_normal((5, 17, 3)).astype(np.float32)
    want = j_camera_to_world(pts, R=q, t=0.5)
    assert_close(camera_to_world(torch.from_numpy(pts), torch.from_numpy(q),
                                 0.5), want)
    px = rng.uniform(0, 1000, (5, 17, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        normalize_screen_coordinates(px, 1000, 1002),
        j_normalize(px, w=1000, h=1002))


def _coco_keypoints(t, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(100, 900, (1, t, 17, 2)).astype(np.float32)


def test_keypoints_json_round_trip_and_coco(tmp_path):
    kps = _coco_keypoints(12, 10)
    scores = np.ones(kps.shape[:3], np.float32)
    path = str(tmp_path / "kps.json")
    save_keypoints_json(path, kps, scores)
    got, got_scores, label, _ = load_keypoints_json(path, 17)
    np.testing.assert_array_equal(got[0], kps[0])
    np.testing.assert_array_equal(got_scores[0], scores[0])
    assert label == "unknown"
    h36m, valid = coco_h36m(got[0])
    j_h36m, j_valid = j_coco_h36m(got[0])
    np.testing.assert_array_equal(h36m, j_h36m)
    np.testing.assert_array_equal(valid, j_valid)


@pytest.mark.parametrize("frames", [27, 243])
def test_reconstruct_cli_on_cpu(tmp_path, frames):
    from gastx_torch.cli import reconstruct

    kps = _coco_keypoints(40, 11)
    kps[0, 5] = 0.0                       # one frame without a detection
    path = str(tmp_path / "kps.json")
    save_keypoints_json(path, kps, np.ones(kps.shape[:3], np.float32))
    with open(path) as f:
        assert len(json.load(f)["data"]) == 40
    out = reconstruct.reconstruct(reconstruct.parse_args(
        ["-k", path, "-f", str(frames), "--random-weights", "--no-render",
         "--device", "cpu", "-vo", str(tmp_path / "out" / "rec.mp4")]))
    assert out.shape == (40, 17, 3)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[5], 0.0)
    saved = np.load(tmp_path / "out" / "rec.npz")["reconstruction"]
    np.testing.assert_array_equal(saved, out)
