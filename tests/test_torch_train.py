"""The port's training stack against the JAX package on the CPU: train-mode
BN and forward, the train step with its gradients, the dropout sites,
amsgrad, the metrics, the batchers and prefetching; and the guards that
keep training off the hand-written kernels. The convergence gate is in
``test_torch_train_convergence.py``, a file of its own so that the
parallel runner can give it a worker of its own.

Tolerance: atol 2e-5, rtol 1e-4, as the eval parity tests (both sides
float32; only the order of summation differs), for one step and for each
of three steps, which the amsgrad update does not widen at these sizes.
"""
import collections
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gastx.eval.metrics as JM
import gastx.models as jm
from gastx.data.generators import ChunkedBatcher as JChunked
from gastx.data.generators import UnchunkedBatcher as JUnchunked
from gastx.ops.batchnorm import batch_norm as j_batch_norm
from gastx.train import init_train_state, make_train_step, scale_by_amsgrad
from gastx_torch.data import synthetic
from gastx_torch.data.generators import ChunkedBatcher, UnchunkedBatcher
from gastx_torch.data.prefetch import prefetch_to_device
from gastx_torch.eval import metrics as TM
from gastx_torch.io import params_from_jax
from gastx_torch.models import build_gastnet
from gastx_torch.ops.batchnorm import batch_norm
from gastx_torch.train import make_optimizer, set_lr, train_step
from gastx_torch.train.loop import root_relative, weighted_loss
from test_torch_common import (ATOL, RTOL, assert_close, inputs, port_model,
                               random_jax_tree)

SMALL = jm.GastNetConfig(filter_widths=(3, 3), channels=16, dropout=0.0)


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=name)


def _assert_state_dict(model, want):
    """The model's tensors against ``want``'s (num_batches_tracked aside,
    which the JAX state lacks)."""
    sd = model.state_dict()
    for k in want:
        if "num_batches" not in k:
            _close(sd[k].detach(), want[k], k)


def _port_cfg(dropout):
    from gastx_torch.models import GastNetConfig
    return GastNetConfig(filter_widths=(3, 3), channels=16, dropout=dropout)


def test_batch_norm_train_matches_jax():
    """The output and the new running mean and (unbiased) variance."""
    params, state = random_jax_tree(SMALL, 0)
    model = port_model(SMALL, params, state, dropout=0.0)
    x = inputs((4, 5, 17, 16), 1) * 2.0 + 0.5
    want, new = j_batch_norm(jnp.asarray(x), params["expand_bn"],
                             state["expand_bn"], train=True)
    bn = model.expand_bn
    assert_close(batch_norm(torch.from_numpy(x), bn, train=True), want)
    _close(bn.running_mean, new["mean"])
    _close(bn.running_var, new["var"])
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("variant,frames", [("strided", 9), ("dilated", 13)])
def test_train_forward_matches_jax(variant, frames):
    """``model.train()`` forward (dropout 0) against
    ``gastnet_forward(train=True)``: the output and the new BN state."""
    params, state = random_jax_tree(SMALL, 2)
    model = port_model(SMALL, params, state, dropout=0.0).train()
    x = inputs((4, frames, 17, 2), 3)
    want, new_state = jm.gastnet_forward(params, state, jnp.asarray(x),
                                         SMALL, variant=variant, train=True)
    got = model(torch.from_numpy(x), variant)
    assert got.requires_grad
    assert_close(got, want)
    _assert_state_dict(model, params_from_jax(
        params, jax.device_get(new_state), SMALL))


def test_train_forward_reaches_no_kernel_wrapper(monkeypatch):
    """On the kernel route ("auto"), a train forward calls none of the
    hand-written kernels' entry points, as the JAX gates have it."""
    import gastx_torch.models.gastnet as G

    def refuse(*args, **kw):
        raise AssertionError("a kernel entry point was called")

    for name in ("fused_level0", "fused_level", "fused_gab",
                 "fused_gab_packed", "fused_local_branch", "head_attention"):
        monkeypatch.setattr(G, name, refuse)
    params, state = random_jax_tree(SMALL, 4)
    model = port_model(SMALL, params, state, dropout=0.0).train()
    for variant, frames in (("dilated", 11), ("strided", 9)):
        model(torch.from_numpy(inputs((2, frames, 17, 2), 5)),
              variant).sum().backward()


def test_train_mode_with_dropout_needs_a_generator():
    """As the JAX forward asserts an rng: a train forward with dropout > 0
    and no generator raises; eval mode needs none."""
    model = build_gastnet(_port_cfg(0.25), device="cpu")
    x = torch.from_numpy(inputs((2, 9, 17, 2), 6))
    model.train()
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x, "strided")
    model(x, "strided", generator=torch.Generator().manual_seed(0))
    model.eval()
    model(x, "strided")       # eval mode: no generator, no dropout


def test_kernel_entry_points_refuse_inputs_that_need_a_gradient():
    """A hand-written kernel's entry point raises on an input that requires
    a gradient while grad mode is on; under no_grad it runs."""
    from gastx_torch.ops.cuda import kernels as K
    from gastx_torch.ops.cuda.fused_gab import fused_gab, gab_tables

    model = build_gastnet(_port_cfg(0.0), device="cpu")
    t = gab_tables(model.layers_graph_conv[0], model.statics)
    x = torch.from_numpy(inputs((2, 3, 17, 16), 7)).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_gab(x, t)
    with pytest.raises(RuntimeError, match="no backward"):
        K.gemm_epilogue([(x.reshape(-1, 16), t.w_proj, 0)], 102)
    with torch.no_grad():
        assert fused_gab(x, t).shape == (2, 3, 17, 32)


# -- the train step -----------------------------------------------------------

def _grad_capturing_amsgrad():
    """``scale_by_amsgrad`` whose state also carries the step's gradients,
    so that ``make_train_step`` hands them back."""
    inner = scale_by_amsgrad()

    def init(params):
        return inner.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                          params)

    def update(grads, state, params=None):
        updates, s = inner.update(grads, state[0], params)
        return updates, (s, grads)

    return optax.GradientTransformation(init, update)


def _steps_batches(cfg, n_steps, batch, seed):
    """Fixed-size batches; the last has zero-weight filler rows (copies of
    its last real row), as trainval pads a ragged batch."""
    rng = np.random.default_rng(seed)
    rf = cfg.receptive_field()
    out = []
    for i in range(n_steps):
        x2d = rng.standard_normal((batch, rf, 17, 2)).astype(np.float32)
        x3d = rng.standard_normal((batch, 1, 17, 3)).astype(np.float32)
        w = np.ones(batch, np.float32)
        if i == n_steps - 1:
            real = batch - 3
            x2d[real:] = x2d[real - 1]
            x3d[real:] = x3d[real - 1]
            w[real:] = 0.0
        out.append((x2d, x3d, w))
    return out


# init_bn's bias reaches the loss only through the expand conv into
# expand_bn, whose train-mode batch mean removes any per-channel constant:
# its gradient is zero up to float32 rounding (~1e-8), and the amsgrad
# update lr * g / (|g| + 1e-8) of that rounding noise moves it by up to lr
# a step in either direction, in each package alike. So it is held to a
# gradient within atol of zero on both sides and a value within 2 lr of
# the JAX one, and then set to the JAX value, since expand_bn's running
# mean of the next step follows it.
ZERO_GRADIENT = ("init_bn.bias",)


def _assert_step(model, host, cfg, lr):
    """The port after a step against the JAX TrainState ``host`` whose
    optimizer state carries the step's gradients."""
    want_grads = params_from_jax(host.opt_state[1], host.bn_state, cfg)
    want = params_from_jax(host.params, host.bn_state, cfg)
    for n, p in model.named_parameters():
        if n in ZERO_GRADIENT:
            _close(p.grad, np.zeros(p.shape), n)
            _close(want_grads[n], np.zeros(p.shape), n)
            assert np.abs(p.detach().numpy() - want[n].numpy()).max() \
                <= 2 * lr, n
            with torch.no_grad():
                p.copy_(want[n])
            continue
        _close(p.grad, want_grads[n], f"grad {n}")
        _close(p.detach(), want[n], n)
    for n, b in model.named_buffers():
        if "running" in n:
            _close(b, want[n], n)


def test_three_train_steps_match_make_train_step():
    """Three strided steps (dropout 0, a decayed lr, the last batch with
    filler rows) against the JAX ``make_train_step`` from the same weights:
    after each, the loss, every gradient (JAX's through params_from_jax),
    every parameter and the BN running statistics."""
    params, state = random_jax_tree(SMALL, 8)
    ts = init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                          jax.tree_util.tree_map(jnp.asarray, state),
                          _grad_capturing_amsgrad())
    step = make_train_step(SMALL, "strided", tx=_grad_capturing_amsgrad())
    model = port_model(SMALL, params, state, dropout=0.0)
    opt = make_optimizer(model.parameters())
    for i, (x2d, x3d, w) in enumerate(_steps_batches(SMALL, 3, 8, 9)):
        lr = 1e-3 * 0.95**i
        ts, want_loss = step(ts, jnp.asarray(x2d), jnp.asarray(x3d),
                             jnp.asarray(w), jnp.float32(lr),
                             jax.random.PRNGKey(i))
        loss = train_step(model, opt, torch.from_numpy(x2d),
                          torch.from_numpy(x3d), torch.from_numpy(w), lr,
                          None, "strided")
        _close(loss, want_loss, f"loss {i}")
        _assert_step(model, jax.device_get(ts), SMALL, lr)


def _np_dropout(counter):
    """A dropout whose mask is drawn with numpy, keyed by call order and
    shape; the same for both packages."""
    def mask(shape, rate):
        counter[0] += 1
        rng = np.random.default_rng(1000 + counter[0])
        return rng.random(shape) >= rate
    return mask


def test_dropout_sites_match_jax(monkeypatch):
    """Dropout at the three sites (each GAB's local and global branch, each
    level's conv chain), masks from one numpy function in both packages:
    the train-mode loss and every gradient agree."""
    import gastx.models.gastnet as JG
    import gastx.ops.graph as JGraph
    import gastx_torch.models.gastnet as TG
    import gastx_torch.ops.graph as TGraph

    cfg = jm.GastNetConfig(filter_widths=(3, 3), channels=16, dropout=0.25)
    params, state = random_jax_tree(cfg, 10)
    x2d, x3d, w = _steps_batches(cfg, 1, 6, 11)[0]
    counter, shapes = [0], collections.defaultdict(list)
    mask = _np_dropout(counter)

    def j_dropout(x, rate, rng):
        keep = mask(x.shape, rate)
        shapes["jax"].append(tuple(x.shape))
        return jnp.where(keep, x / (1.0 - rate), 0.0)

    def t_dropout(x, rate, generator, mesh=None):
        assert mesh is None
        keep = torch.from_numpy(mask(tuple(x.shape), rate))
        shapes["torch"].append(tuple(x.shape))
        return torch.where(keep, x / (1.0 - rate), torch.zeros(()))

    monkeypatch.setattr(JGraph, "_dropout", j_dropout)
    monkeypatch.setattr(JG, "_dropout", j_dropout)
    monkeypatch.setattr(TGraph, "dropout", t_dropout)
    monkeypatch.setattr(TG, "dropout", t_dropout)

    def loss_fn(p):
        pred, _ = jm.gastnet_forward(p, state, jnp.asarray(x2d), cfg,
                                     variant="strided", train=True,
                                     rng=jax.random.PRNGKey(0))
        err = jnp.mean(jnp.linalg.norm(pred - jnp.asarray(x3d).at[
            :, :, 0].set(0.0), axis=-1), axis=(1, 2))
        return jnp.sum(err * w) / jnp.sum(w)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    counter[0] = 0
    model = port_model(cfg, params, state, dropout=0.25).train()
    loss = weighted_loss(
        model(torch.from_numpy(x2d), "strided",
              generator=torch.Generator()),
        root_relative(torch.from_numpy(x3d)), torch.from_numpy(w))
    loss.backward()
    # Level 0: local, global; level 1: conv chain, local, global.
    assert len(shapes["jax"]) == 5
    assert shapes["torch"] == shapes["jax"]
    _close(loss.detach(), want_loss)
    grads = params_from_jax(jax.device_get(want_grads), state, cfg)
    for n, p in model.named_parameters():
        _close(p.grad, grads[n], n)


def test_dropout_keeps_its_rate_and_scale():
    """The port's own dropout: the kept share is 1 - rate, kept values are
    scaled by 1 / (1 - rate), and a seeded generator repeats its mask."""
    from gastx_torch.ops.graph import dropout

    x = torch.ones(200_000)
    y = dropout(x, 0.25, torch.Generator().manual_seed(1))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 4 / 3))
    torch.testing.assert_close(
        y, dropout(x, 0.25, torch.Generator().manual_seed(1)))


def test_eval_step_matches_jax():
    """The eval forward's frame-weighted MPJPE sum and frame count; the
    model comes back in the mode it went in."""
    from gastx.train import eval_step as j_eval_step
    from gastx_torch.train import eval_step

    params, state = random_jax_tree(SMALL, 16)
    model = port_model(SMALL, params, state, dropout=0.0).train()
    x2d = inputs((3, 13, 17, 2), 17)
    x3d = inputs((3, 5, 17, 3), 18)
    want_sum, want_n = j_eval_step(params, state, jnp.asarray(x2d),
                                   jnp.asarray(x3d), SMALL)
    got_sum, got_n = eval_step(model, torch.from_numpy(x2d),
                               torch.from_numpy(x3d))
    assert model.training and got_n == int(want_n) == 15
    _close(got_sum, want_sum)


def test_lr_decay_matches_jax():
    from gastx.train import exponential_epoch_decay as j_decay
    from gastx_torch.train import exponential_epoch_decay

    for epoch in (0, 1, 10, 59):
        assert exponential_epoch_decay(1e-3, 0.95, epoch) == j_decay(
            1e-3, 0.95, epoch)


def test_amsgrad_matches_scale_by_amsgrad():
    """Five steps with a decayed lr set on the parameter group each step:
    the parameters and the three moments against ``scale_by_amsgrad``."""
    rng = np.random.default_rng(12)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    tx = scale_by_amsgrad()
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_optimizer(tp.values())
    for i, g in enumerate(grads):
        lr = 1e-2 * 0.95**i
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = {k: params[k] - lr * updates[k] for k in params}
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        set_lr(opt, lr)
        opt.step()
    for k, p in tp.items():
        _close(p.detach(), params[k], k)
        s = opt.state[p]
        _close(s["exp_avg"], state.m[k], f"m {k}")
        _close(s["exp_avg_sq"], state.v[k], f"v {k}")
        _close(s["max_exp_avg_sq"], state.vmax[k], f"vmax {k}")
        assert int(s["step"]) == int(state.count) == 5


def test_metrics_match_jax():
    rng = np.random.default_rng(13)
    pred = rng.standard_normal((6, 5, 17, 3)).astype(np.float32)
    target = rng.standard_normal((6, 5, 17, 3)).astype(np.float32)
    w = rng.random((6, 5, 17)).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    _close(TM.mpjpe(tp, tt), JM.mpjpe(pred, target))
    _close(TM.weighted_mpjpe(tp, tt, torch.from_numpy(w)),
           JM.weighted_mpjpe(pred, target, w))
    _close(TM.n_mpjpe(tp, tt), JM.n_mpjpe(pred, target))
    p2, t2 = pred[:, 0], target[:, 0]
    assert TM.p_mpjpe(p2, t2) == JM.p_mpjpe(p2, t2)
    np.testing.assert_array_equal(TM.euclidean_losses(p2 * 100, t2 * 100),
                                  JM.euclidean_losses(p2 * 100, t2 * 100))
    assert TM.pck(p2 * 100, t2 * 100) == JM.pck(p2 * 100, t2 * 100)
    assert TM.auc(p2 * 100, t2 * 100) == JM.auc(p2 * 100, t2 * 100)
    with pytest.raises(ValueError):
        TM.mpjpe(tp, tt[:1])


# -- data ----------------------------------------------------------------------

KPS_LEFT, KPS_RIGHT = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]


def _toy_sequences(seed=14):
    rng = np.random.default_rng(seed)
    lengths = [50, 31, 77]
    return ([rng.standard_normal(9).astype(np.float32) for _ in lengths],
            [rng.standard_normal((t, 17, 3)).astype(np.float32)
             for t in lengths],
            [rng.standard_normal((t, 17, 2)).astype(np.float32)
             for t in lengths])


@pytest.mark.parametrize("augment,chunk,pad,shift,endless", [
    (False, 1, 13, 0, False), (True, 1, 13, 0, False),
    (True, 3, 13, 13, False), (True, 1, 4, 0, True)])
def test_chunked_batcher_matches_jax(augment, chunk, pad, shift, endless):
    """The same seed gives the same batches, shuffle and flips included,
    over two epochs; the RandomState carries across set_random_state."""
    cams, p3, p2 = _toy_sequences()
    kw = dict(chunk_length=chunk, pad=pad, causal_shift=shift, shuffle=True,
              augment=augment, kps_left=KPS_LEFT, kps_right=KPS_RIGHT,
              joints_left=KPS_LEFT, joints_right=KPS_RIGHT, endless=endless)
    got = ChunkedBatcher(8, cams, p3, p2, **kw)
    want = JChunked(8, cams, p3, p2, **kw)
    assert got.num_batches == want.num_batches
    assert got.num_frames() == want.num_frames()
    n = 2 * got.num_batches
    gen_g, gen_w = got.next_epoch(), want.next_epoch()
    for _ in range(n if endless else 1):
        if not endless:
            pairs = list(zip(gen_g, gen_w))
            assert len(pairs) == got.num_batches
        else:
            pairs = [(next(gen_g), next(gen_w))]
        for g, w in pairs:
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.random_state().permutation(50),
                                  want.random_state().permutation(50))


def test_unchunked_batcher_matches_jax():
    cams, p3, p2 = _toy_sequences(15)
    for augment in (False, True):
        kw = dict(pad=13, causal_shift=4, augment=augment,
                  kps_left=KPS_LEFT, kps_right=KPS_RIGHT,
                  joints_left=KPS_LEFT, joints_right=KPS_RIGHT)
        got = UnchunkedBatcher(cams, p3, p2, **kw)
        want = JUnchunked(cams, p3, p2, **kw)
        assert got.num_frames() == want.num_frames()
        for g, w in zip(got.next_epoch(), want.next_epoch()):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_prefetch_preserves_order_and_values():
    items = list(range(20))
    assert list(prefetch_to_device(iter(items), lambda x: x * 2)) == [
        x * 2 for x in items]


def test_prefetch_overlaps_producer_and_consumer():
    def slow_source():
        for i in range(6):
            time.sleep(0.05)
            yield i

    t0 = time.perf_counter()
    for _ in prefetch_to_device(slow_source(), lambda x: x):
        time.sleep(0.05)
    # Serial would take ~0.6 s, overlapped ~0.35 s.
    assert time.perf_counter() - t0 < 0.57


def test_prefetch_propagates_exceptions():
    def bad_source():
        yield 1
        raise ValueError("boom")

    it = prefetch_to_device(bad_source(), lambda x: x)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_prefetch_early_stop_ends_the_producer():
    produced = []
    started = threading.active_count()

    def source():
        for i in range(1000):
            produced.append(i)
            yield i

    gen = prefetch_to_device(source(), lambda x: x, depth=2)
    for x in gen:
        if x == 3:
            break
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > started and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= started
    assert len(produced) < 1000


def test_synthetic_task_matches_jax():
    from gastx.data import synthetic as js

    got = synthetic.wellposed_batch(np.random.default_rng(7), 16, 9)
    want = js.wellposed_batch(np.random.default_rng(7), 16, 9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert [synthetic.convergence_lr(i) for i in (0, 199, 200, 359, 360)] \
        == [js.convergence_lr(i) for i in (0, 199, 200, 359, 360)]
    assert (synthetic.CONVERGENCE_STEPS, synthetic.CONVERGENCE_BATCH,
            synthetic.CONVERGENCE_GATE_MM) == (
        js.CONVERGENCE_STEPS, js.CONVERGENCE_BATCH, js.CONVERGENCE_GATE_MM)
