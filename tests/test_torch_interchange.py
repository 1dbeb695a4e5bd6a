"""Checkpoint interchange: the JAX package's ``.ckpt`` read by the port
(``gastx_torch.io.jax_checkpoint``), on the CPU, against the JAX package.

The ``.ckpt`` files are written by ``gastx.train.save_checkpoint`` from
``random_jax_tree`` weights and seeded non-zero amsgrad moments (no JAX
compile). The committed fixture ``tests/data/jax_train_state_arc33_ch8.ckpt``
is one of them: the ``-arc 3,3 -ch 8`` model of the synthetic H36M set,
``count`` 7, epoch 1; ``python tests/test_torch_interchange.py`` writes
it again from its seed. Weights and moments are held bitwise (the same
float32 numbers through the same transposes); one resumed train step at
atol 2e-5 / rtol 1e-4 (``tests/test_torch_train.py``); the protocol
errors at atol 2e-2 mm.
"""
import dataclasses
import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gastx.models as jm
from gastx.train import load_checkpoint as j_load_checkpoint
from gastx.train import make_train_step
from gastx.train import save_checkpoint as j_save_checkpoint
from gastx.train.loop import TrainState as JTrainState
from gastx.train.optimizer import AmsgradState as JAmsgradState
from gastx_torch.cli import reconstruct, trainval
from gastx_torch.data import coco_h36m, save_keypoints_json
from gastx_torch.io import (adam_state_dict, load_jax_checkpoint,
                            params_from_jax)
from gastx_torch.models import GastNet
from gastx_torch.train import (load_checkpoint, make_optimizer,
                               restore_batcher_random_state, save_checkpoint,
                               train_step)
from test_torch_common import REPO, RTOL, random_jax_tree, torch_config
from test_torch_train import _close, _grad_capturing_amsgrad, _steps_batches
from test_torch_trainval import _argv, _p1, synthetic_h36m  # noqa: F401

FIXTURE = os.path.join(REPO, "tests", "data", "jax_train_state_arc33_ch8.ckpt")
FIXTURE_SEED = 13
# trainval's -arc 3,3 -ch 8 on the 17-joint synthetic set.
FIXTURE_CFG = jm.GastNetConfig(filter_widths=(3, 3), channels=8)
FIXTURE_ARGS = ("-arc", "3,3", "-ch", "8")
MOMENTS = {"m": "exp_avg", "v": "exp_avg_sq", "vmax": "max_exp_avg_sq"}


def seeded_train_state(cfg, seed, count=7):
    """A JAX TrainState of ``cfg``: ``random_jax_tree``'s weights and
    amsgrad moments from the seed, 0 < v <= vmax, at step ``count``."""
    params, state = random_jax_tree(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    tree_map = jax.tree_util.tree_map

    def draw(fn):
        return tree_map(lambda p: fn(p.shape).astype(np.float32), params)

    m = draw(lambda s: 1e-3 * rng.standard_normal(s))
    v = draw(lambda s: 1e-6 * rng.uniform(0.5, 1.5, s))
    vmax = tree_map(lambda a: (a + 1e-6 * rng.uniform(0.0, 1.0, a.shape))
                    .astype(np.float32), v)
    return JTrainState(params, state,
                       JAmsgradState(np.asarray(count, np.int32), m, v, vmax))


def fixture_contents(cfg, seed):
    """What ``write_jax_ckpt`` saves: epoch 1, its lr, the TrainState and
    a batcher RandomState that has drawn one permutation."""
    rs = np.random.RandomState(seed)
    rs.permutation(10)
    return dict(epoch=1, lr=1e-3 * 0.95,
                train_state=seeded_train_state(cfg, seed),
                batcher_random_state=rs)


def write_jax_ckpt(path, cfg, seed):
    j_save_checkpoint(path, **fixture_contents(cfg, seed))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_fixture_regenerates_from_its_seed():
    """The committed .ckpt holds what its seed gives, array by array."""
    assert os.path.getsize(FIXTURE) < 256 * 1024
    blob = j_load_checkpoint(FIXTURE)
    want = fixture_contents(FIXTURE_CFG, FIXTURE_SEED)
    assert (blob["epoch"], blob["lr"]) == (want["epoch"], want["lr"])
    got_leaves = _leaves(blob["train_state"])
    want_leaves = _leaves(want["train_state"])
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert int(blob["train_state"].opt_state.count) == 7
    for a, b in zip(blob["random_state"],
                    want["batcher_random_state"].get_state()):
        np.testing.assert_array_equal(a, b)


def test_reader_matches_params_from_jax(tmp_path):
    """The reader's state_dict is params_from_jax of the TrainState, and
    each moment the params-only mapping of the same tree, bitwise; epoch,
    lr and the batcher RNG as saved."""
    cfg = jm.GastNetConfig(filter_widths=(3, 3), channels=16)
    path = str(tmp_path / "e.ckpt")
    want = fixture_contents(cfg, 3)
    ts = want["train_state"]
    # From JAX arrays, as trainval saves: the pickled leaves are read-only.
    j_save_checkpoint(path, **{**want, "train_state": jax.tree_util.tree_map(
        jnp.asarray, ts)})
    got = load_jax_checkpoint(path, torch_config(cfg))
    assert (got["epoch"], got["lr"]) == (1, 1e-3 * 0.95)

    sd = params_from_jax(ts.params, ts.bn_state, cfg)
    assert got["model"].keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got["model"][k], v), k
    model = GastNet(torch_config(cfg))
    model.load_state_dict(got["model"], strict=True)

    names = {n for n, _ in model.named_parameters()}
    moments = got["optimizer"]
    assert moments["step"].dtype == torch.float32
    assert moments["step"].device.type == "cpu"
    assert float(moments["step"]) == 7.0
    for field, key in MOMENTS.items():
        want_m = params_from_jax(getattr(ts.opt_state, field), None, cfg)
        assert set(moments[key]) == set(want_m) == names
        for n, t in want_m.items():
            assert torch.equal(moments[key][n], t), (key, n)
            assert moments[key][n].numpy().flags.writeable, (key, n)
    np.testing.assert_array_equal(
        restore_batcher_random_state(got).permutation(100),
        want["batcher_random_state"].permutation(100))


def test_moments_land_on_their_parameters():
    """adam_state_dict places each moment on the parameter of its name in
    an Adam over model.parameters(), whose own order is not the
    mapping's; an optimizer over other parameters is refused."""
    got = load_jax_checkpoint(FIXTURE, torch_config(FIXTURE_CFG))
    model = GastNet(torch_config(FIXTURE_CFG))
    model.load_state_dict(got["model"], strict=True)
    opt = make_optimizer(model.parameters(), got["lr"])
    opt.load_state_dict(adam_state_dict(got["optimizer"], model, opt))
    moments = got["optimizer"]
    assert list(moments["exp_avg"]) != [n for n, _ in
                                        model.named_parameters()]
    for n, p in model.named_parameters():
        state = opt.state[p]
        assert float(state["step"]) == 7.0, n
        assert state["step"].dtype == torch.float32
        for key in MOMENTS.values():
            assert state[key].shape == p.shape, (n, key)
            assert torch.equal(state[key], moments[key][n]), (n, key)
        assert bool((state["max_exp_avg_sq"] >= state["exp_avg_sq"]).all())
    other = make_optimizer(list(model.parameters())[1:])
    with pytest.raises(ValueError, match="one group"):
        adam_state_dict(moments, model, other)


def test_one_resumed_step_matches_make_train_step():
    """One strided step from the fixture (dropout 0) by the port, its
    model and Adam from the reader, against make_train_step from the same
    TrainState (its optimizer state carrying the step's gradients): the
    loss, every gradient and parameter, the BN statistics, and the amsgrad
    moments after the step."""
    cfg = dataclasses.replace(FIXTURE_CFG, dropout=0.0)
    tcfg = torch_config(cfg)
    got = load_jax_checkpoint(FIXTURE, tcfg)
    model = GastNet(dataclasses.replace(tcfg, dropout=0.0))
    model.load_state_dict(got["model"], strict=True)
    opt = make_optimizer(model.parameters(), got["lr"])
    opt.load_state_dict(adam_state_dict(got["optimizer"], model, opt))
    x2d, x3d, w = _steps_batches(cfg, 1, 8, 21)[0]
    lr = got["lr"]
    loss = train_step(model, opt, torch.from_numpy(x2d),
                      torch.from_numpy(x3d), torch.from_numpy(w), lr, None,
                      "strided")

    ts = j_load_checkpoint(FIXTURE)["train_state"]
    on_device = jax.tree_util.tree_map(jnp.asarray, ts)
    grads = jax.tree_util.tree_map(jnp.zeros_like, on_device.params)
    jts = JTrainState(on_device.params, on_device.bn_state,
                      (on_device.opt_state, grads))
    step = make_train_step(cfg, "strided", tx=_grad_capturing_amsgrad())
    jts, want_loss = step(jts, jnp.asarray(x2d), jnp.asarray(x3d),
                          jnp.asarray(w), jnp.float32(lr),
                          jax.random.PRNGKey(0))
    host = jax.device_get(jts)
    amsgrad, want_grads = host.opt_state

    _close(loss, want_loss, "loss")
    want_grads = params_from_jax(want_grads, None, cfg)
    want = params_from_jax(host.params, host.bn_state, cfg)
    for n, p in model.named_parameters():
        _close(p.grad, want_grads[n], f"grad {n}")
        _close(p.detach(), want[n], n)
        assert float(opt.state[p]["step"]) == int(amsgrad.count) == 8
    for n, b in model.named_buffers():
        if "running" in n:
            _close(b, want[n], n)
    for field, key in MOMENTS.items():
        want_m = params_from_jax(getattr(amsgrad, field), None, cfg)
        for n, p in model.named_parameters():
            _close(opt.state[p][key], want_m[n], f"{key} {n}")


class _Calls:
    """A pickled object whose unpickling calls ``fn(*args)``."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("target", ["os.system", "builtins.eval",
                                    "numpy.load",
                                    "gastx.train.loop.make_train_step"])
def test_reader_refuses_classes_outside_the_allow_list(tmp_path, target):
    """A pickle that names anything but the two gastx NamedTuples and
    numpy's reconstructors is refused before it is called."""
    import importlib

    module, name = target.rsplit(".", 1)
    fn = getattr(importlib.import_module(module), name)
    marker = tmp_path / "called"
    path = str(tmp_path / "evil.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"format": "gastx-checkpoint-v1", "epoch": 1,
                     "train_state": _Calls(fn, (f"touch {marker}",))}, f)
    with pytest.raises(pickle.UnpicklingError,
                       match=re.escape(f".{fn.__name__} is refused")):
        load_jax_checkpoint(path, torch_config(FIXTURE_CFG))
    assert not marker.exists()


def test_reader_imports_neither_jax_nor_gastx():
    """Reading the fixture in a fresh process loads no module of jax or
    gastx: the reader names the gastx classes only as strings."""
    code = (
        "import sys\n"
        "from gastx_torch.io import load_jax_checkpoint\n"
        "from gastx_torch.models import GastNet, GastNetConfig\n"
        "cfg = GastNetConfig(filter_widths=(3, 3), channels=8)\n"
        f"blob = load_jax_checkpoint({FIXTURE!r}, cfg)\n"
        "GastNet(cfg).load_state_dict(blob['model'], strict=True)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'gastx') or "
        "m.startswith(('jax.', 'gastx.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_reconstruct_takes_ckpt_pt_and_bin(tmp_path):
    """reconstruct -w with the same weights as a JAX .ckpt, the port's .pt
    and an upstream .bin gives the output of the model loaded by hand."""
    from gastx_torch.geometry import normalize_screen_coordinates
    from gastx_torch.infer import lift_to_world
    from gastx_torch.models import config_for_frames

    jcfg = jm.config_for_frames(27)
    ts = seeded_train_state(jcfg, 5)
    ckpt = str(tmp_path / "w.ckpt")
    j_save_checkpoint(ckpt, epoch=3, lr=1e-3, train_state=ts)
    model = GastNet(config_for_frames(27))
    model.load_state_dict(params_from_jax(ts.params, ts.bn_state, jcfg),
                          strict=True)
    model.eval()
    save_checkpoint(str(tmp_path / "w.pt"), epoch=3, lr=1e-3, model=model)
    torch.save({"model_pos": {f"module.{k}": v
                              for k, v in model.state_dict().items()}},
               str(tmp_path / "w.bin"))

    rng = np.random.default_rng(6)
    kps = (rng.random((1, 12, 17, 2)) * 900 + 50).astype(np.float32)
    path = str(tmp_path / "kps.json")
    save_keypoints_json(path, kps, np.ones(kps.shape[:3], np.float32))
    h36m, _ = coco_h36m(kps[0])
    seq = normalize_screen_coordinates(h36m, w=reconstruct.WIDTH,
                                       h=reconstruct.HEIGHT)
    want = lift_to_world(model, [seq.astype(np.float32)], tta=True)[0]
    want[:, :, 2] -= np.min(want[:, :, 2])

    for ext in (".ckpt", ".pt", ".bin"):
        got = reconstruct.reconstruct(reconstruct.parse_args(
            ["-k", path, "-w", str(tmp_path / f"w{ext}"), "--no-render",
             "--device", "cpu", "-vi", str(tmp_path / "missing.mp4"),
             "-vo", str(tmp_path / f"out{ext}.mp4")]))
        np.testing.assert_array_equal(got, want, err_msg=ext)


@pytest.mark.parametrize("weight", ["missing.ckpt", "w.pth"])
def test_reconstruct_names_the_weight_formats(tmp_path, weight):
    """A missing file or one of another format stops with the formats."""
    (tmp_path / "w.pth").write_bytes(b"")
    path = str(tmp_path / "kps.json")
    kps = np.ones((1, 3, 17, 2), np.float32)
    save_keypoints_json(path, kps, np.ones(kps.shape[:3], np.float32))
    with pytest.raises(SystemExit, match=r"\.bin.*\.pt.*\.ckpt"):
        reconstruct.reconstruct(reconstruct.parse_args(
            ["-k", path, "-w", str(tmp_path / weight), "--no-render",
             "--device", "cpu"]))


def _fixture_argv(tmp, ckpt, *extra):
    """trainval's test flags with the fixture's model (later flags win)."""
    return [*_argv(tmp, ckpt), *FIXTURE_ARGS, *extra]


def test_trainval_evaluates_a_jax_ckpt(synthetic_h36m, capsys):  # noqa: F811
    """trainval --evaluate on the fixture gives the JAX trainval's
    Protocol #1 and #2 errors on the same checkpoint."""
    from gastx.cli.trainval import main as j_main

    tmp = synthetic_h36m
    trainval.main(_fixture_argv(tmp, "ckpt", "--evaluate", FIXTURE))
    out = capsys.readouterr().out
    j_main(["-b", "32", "--downsample", "1", *FIXTURE_ARGS, "--checkpoint",
            str(tmp / "jckpt"), "--data-dir", str(tmp / "data"),
            "--evaluate", FIXTURE])
    j_out = capsys.readouterr().out
    p2 = r"Protocol #2 Error \(P-MPJPE\): (\S+) mm"
    assert len(_p1(out)) == 1
    np.testing.assert_allclose(_p1(out), _p1(j_out), atol=2e-2, rtol=RTOL)
    np.testing.assert_allclose([float(v) for v in re.findall(p2, out)],
                               [float(v) for v in re.findall(p2, j_out)],
                               atol=2e-2, rtol=RTOL)


def test_trainval_resumes_a_jax_ckpt(synthetic_h36m, capsys):  # noqa: F811
    """trainval --resume on the fixture trains epoch 2 at the fixture's
    lr, its Adam starting from the fixture's step and moments."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    first = []

    def capture(optimizer, args, kwargs):
        if not first:
            first.append([{k: v.clone() for k, v in optimizer.state[p].items()}
                          for p in optimizer.param_groups[0]["params"]])

    tmp = synthetic_h36m
    handle = register_optimizer_step_pre_hook(capture)
    try:
        model = trainval.main(_fixture_argv(
            tmp, "resumed", "-e", "2", "--no-eval", "--checkpoint-frequency",
            "1", "-r", FIXTURE))
    finally:
        handle.remove()
    out = capsys.readouterr().out
    assert "[2] time" in out and "[1] time" not in out
    assert "lr 0.000950" in out
    want = load_jax_checkpoint(FIXTURE, torch_config(FIXTURE_CFG))["optimizer"]
    for (n, _), state in zip(model.named_parameters(), first[0]):
        assert float(state["step"]) == 7.0, n
        for key in MOMENTS.values():
            assert torch.equal(state[key], want[key][n]), (n, key)
    saved = load_checkpoint(str(tmp / "resumed" / "epoch_2.pt"))
    assert saved["epoch"] == 2
    steps = {float(s["step"]) for s in saved["optimizer"]["state"].values()}
    assert len(steps) == 1 and steps.pop() > 7.0


if __name__ == "__main__":  # PYTHONPATH=. python tests/test_torch_interchange.py
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    write_jax_ckpt(FIXTURE, FIXTURE_CFG, FIXTURE_SEED)
    print("wrote", FIXTURE, os.path.getsize(FIXTURE), "bytes")
