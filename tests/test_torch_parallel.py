"""The port's data parallelism (``gastx_torch.parallel``) on the CPU: two
gloo ranks, spawned once for the module (``torch_parallel_ranks.run``,
which imports torch only), against the JAX package's 2-device mesh and
against the port's one-process paths, and ``dryrun_multichip(2)``.

The JAX values are computed here, in the parent, where tests/conftest.py
gives JAX 8 virtual CPU devices. Tolerance: atol 2e-5, rtol 1e-4, as the
other parity tests (float32 on both sides; the ranks' sums over the
global batch run in another order than one process's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models as jm
from gastx.parallel import make_mesh as j_make_mesh
from gastx.parallel import shard_batch as j_shard_batch
from gastx_torch.infer import lift_sequences
from gastx_torch.io import params_from_jax
from gastx_torch.ops.batchnorm import batch_norm
from gastx_torch.parallel import Mesh, shard_batch, spawn
from gastx_torch.train import make_optimizer, train_step
from test_torch_common import ATOL, RTOL, random_jax_tree, torch_config

import torch_parallel_ranks

# tests/test_train.py's TINY: 15 joints, two levels, 8 channels.
TINY = jm.GastNetConfig(num_joints_in=15, num_joints_out=15,
                        filter_widths=(3, 3), channels=8, dropout=0.0,
                        layout="humaneva15")
DROPOUT = 0.05
BATCH = 8
LIFT = jm.GastNetConfig(filter_widths=(3, 3), channels=16, dropout=0.0)


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=name)


def _batches():
    """The full batch (unit weights), and the ragged one: three real rows
    and five zero-weight copies of the last, so that rank 1's four rows
    are all filler."""
    rng = np.random.default_rng(3)
    rf = TINY.receptive_field()
    x2d = rng.standard_normal((BATCH, rf, 15, 2)).astype(np.float32)
    x3d = rng.standard_normal((BATCH, 1, 15, 3)).astype(np.float32)
    full = (x2d, x3d, np.ones(BATCH, np.float32))
    r2, r3, w = x2d.copy(), x3d.copy(), np.zeros(BATCH, np.float32)
    r2[3:], r3[3:], w[:3] = x2d[2], x3d[2], 1.0
    return {"full": full, "ragged": (r2, r3, w)}


def _torch_cfg(dropout):
    return dataclasses.replace(torch_config(TINY), dropout=dropout)


@pytest.fixture(scope="module")
def weights():
    params, state = random_jax_tree(TINY, 21)
    return params, state, params_from_jax(params, state, TINY)


@pytest.fixture(scope="module")
def ranks(weights):
    """Both ranks' results of every case, from one spawned group."""
    _, _, sd = weights
    batches = _batches()
    steps = {name: {"cfg": _torch_cfg(0.0), "state_dict": sd,
                    "batch": batch, "seed": 0}
             for name, batch in batches.items()}
    steps["dropout"] = {"cfg": _torch_cfg(DROPOUT), "state_dict": sd,
                        "batch": batches["full"], "seed": 5}
    rng = np.random.default_rng(4)
    bn = (rng.standard_normal((BATCH, 5, 17, 16)).astype(np.float32) * 2
          + 0.5, rng.standard_normal((BATCH, 5, 17, 16)).astype(np.float32))
    lift_params, lift_state = random_jax_tree(LIFT, 22)
    lift = {"cfg": torch_config(LIFT),
            "state_dict": params_from_jax(lift_params, lift_state, LIFT),
            "sequences": [rng.standard_normal((t, 17, 2)).astype(np.float32)
                          for t in (21, 40, 21)]}
    cases = {"steps": steps, "bn": bn, "lift": lift}
    return cases, spawn(torch_parallel_ranks.run, 2, cases, timeout=300)


def _jax_loss(p, state, b2, b3, w):
    pred, new_state = jm.gastnet_forward(p, state, b2, TINY,
                                         variant="strided", train=True,
                                         rng=jax.random.PRNGKey(0))
    err = jnp.mean(jnp.linalg.norm(pred - b3.at[:, :, 0].set(0.0), axis=-1),
                   axis=(1, 2))
    return jnp.sum(err * w) / jnp.sum(w), new_state


_jax_grad = jax.jit(jax.value_and_grad(_jax_loss, has_aux=True))


def _jax_step(params, state, batch):
    """Loss, gradients and new BN state of one strided train step over the
    JAX package's 2-device mesh (global-batch BN, psum'd gradients)."""
    mesh = j_make_mesh(jax.devices()[:2])
    tree = jax.tree_util.tree_map(jnp.asarray, (params, state))
    with mesh:
        sharded, _ = j_shard_batch(mesh, *batch)
        (loss, new_state), grads = _jax_grad(*tree, *sharded)
    return float(loss), jax.device_get(grads), jax.device_get(new_state)


@pytest.mark.parametrize("case", ["full", "ragged"])
def test_dp_step_matches_the_jax_mesh(weights, ranks, case):
    """One DP strided step on two gloo ranks against the JAX
    ``shard_batch`` + ``value_and_grad`` over a 2-device mesh: the loss,
    every gradient (DDP's mean of the ranks') and the BN running
    statistics; on the ragged batch rank 1 holds only filler rows."""
    params, state, _ = weights
    _, results = ranks
    loss, grads, new_state = _jax_step(params, state, _batches()[case])
    want_grads = params_from_jax(grads, None, TINY)
    want_state = params_from_jax(params, new_state, TINY)
    got = results[0][case]
    _close(got["loss"], loss, "loss")
    assert got["grads"].keys() == want_grads.keys()
    for n, g in got["grads"].items():
        _close(g, want_grads[n], f"grad {n}")
    for n, b in got["buffers"].items():
        if "running" in n:
            _close(b, want_state[n], n)


def test_ranks_hold_the_same_state(ranks):
    """After each step both ranks hold the same loss, gradients,
    parameters and BN statistics, bit for bit (DDP's reduced gradients,
    the global-batch BN, no buffer broadcast)."""
    _, (r0, r1) = ranks
    for case in ("full", "ragged", "dropout"):
        assert float(r0[case]["loss"]) == float(r1[case]["loss"])
        for kind in ("grads", "params", "buffers"):
            for n, t in r0[case][kind].items():
                np.testing.assert_array_equal(t, r1[case][kind][n],
                                              err_msg=f"{case} {kind} {n}")


def test_replicate_takes_rank_0s_parameters_and_buffers(ranks):
    """``replicate`` gives every rank rank 0's parameters (DDP's broadcast)
    and buffers (its own, as DDP is built without buffer broadcasts)."""
    _, results = ranks
    assert [r["replicated"] for r in results] == [0.0, 0.0]


def _one_process_step(sd, cfg, batch, seed):
    from gastx_torch.models import GastNet

    model = GastNet(cfg)
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(model.parameters())
    loss = train_step(model, opt, *(torch.from_numpy(a) for a in batch),
                      1e-3, torch.Generator().manual_seed(seed), "strided")
    return loss, model


def test_dp_dropout_matches_the_one_process_step(weights, ranks):
    """Dropout 0.05: the ranks draw each mask at the global batch's shape
    and keep their rows, so the DP step is the port's one-process step on
    the global batch: the loss, every gradient, the BN statistics."""
    cases, results = ranks
    case = cases["steps"]["dropout"]
    loss, model = _one_process_step(weights[2], case["cfg"], case["batch"],
                                    case["seed"])
    got = results[0]["dropout"]
    _close(got["loss"], loss.numpy(), "loss")
    for n, p in model.named_parameters():
        _close(got["grads"][n], p.grad.numpy(), f"grad {n}")
    for n, b in model.named_buffers():
        if "running" in n:
            _close(got["buffers"][n], b.numpy(), n)


def test_global_bn_backward_matches_one_process(ranks):
    """The global-batch BN on each rank's rows against ``batch_norm`` on the
    whole batch in one process: the output and the input's gradient of
    each rank's rows, the scale's and bias's gradients summed over the
    ranks, and the running statistics (the global n in n / (n - 1))."""
    cases, results = ranks
    x, r = cases["bn"]
    bn = torch.nn.BatchNorm2d(x.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[-1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[-1]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = batch_norm(xt, bn, train=True)
    (y * torch.from_numpy(r)).sum().backward()
    half = x.shape[0] // 2
    for rank, got in enumerate(results):
        rows = slice(rank * half, (rank + 1) * half)
        got = got["bn"]
        _close(got["y"], y.detach()[rows], f"rank {rank} y")
        _close(got["dx"], xt.grad[rows], f"rank {rank} dx")
        _close(got["dscale"], bn.weight.grad, "dscale")
        _close(got["dbias"], bn.bias.grad, "dbias")
        _close(got["mean"], bn.running_mean, "running mean")
        _close(got["var"], bn.running_var, "running var")


@pytest.mark.parametrize("rows", [8, 5])
def test_shard_batch_matches_jax(rows):
    """Padding (the last row repeated up to a multiple of the ranks) and
    each rank's contiguous rows, against the JAX ``shard_batch``'s
    per-device shards over a 2-device mesh; None stays None."""
    rng = np.random.default_rng(rows)
    a = rng.standard_normal((rows, 3, 2)).astype(np.float32)
    w = np.arange(rows, dtype=np.float32)
    mesh = j_make_mesh(jax.devices()[:2])
    (ja, jw), j_true = j_shard_batch(mesh, a, w)
    for rank in range(2):
        (ta, tw, none), t_true = shard_batch(
            Mesh(None, 2, rank, torch.device("cpu")), a, w, None)
        assert none is None and t_true == j_true == rows
        for got, want in ((ta, ja), (tw, jw)):
            shard = next(s for s in want.addressable_shards
                         if s.device == mesh.devices[rank])
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


def test_sharded_lift_matches_one_process(ranks):
    """``lift_sequences(mesh=)`` with flip TTA on 3 sequences of two lengths
    (the bucket's batch padded to the ranks): every rank returns every
    sequence's one-process result."""
    cases, results = ranks
    lift = cases["lift"]
    from gastx_torch.models import GastNet

    model = GastNet(lift["cfg"])
    model.load_state_dict(lift["state_dict"], strict=True)
    want = lift_sequences(model.eval(), lift["sequences"], tta=True)
    for rank, got in enumerate(results):
        assert [a.shape for a in got["lift"]] == [a.shape for a in want]
        for a, b in zip(got["lift"], want):
            _close(a, b, f"rank {rank}")


def test_dryrun_multichip_two_ranks():
    """The port's ``dryrun_multichip(2)`` on gloo on the CPU: two DP train
    steps and the sharded TTA lift held to the one-rank lift."""
    from gastx_torch.entry import dryrun_multichip

    losses = dryrun_multichip(2, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
