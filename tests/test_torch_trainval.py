"""The port's data harness, protocol evaluation, checkpoints and trainval
CLI on the CPU, against the JAX package where it has a counterpart.

The synthetic H36M-format dataset is the fixture of
tests/test_trainval_cli.py: seven subjects, one action, 40 frames, four
cameras of 17-joint detections. Tolerance: atol 2e-5, rtol 1e-4 on
arrays; the protocol errors are in mm, so atol 2e-2 mm (the 2e-5 m of the
poses they average).
"""
import os
import pickle
import re

import numpy as np
import pytest
import torch

import gastx.models as jm
from gastx.data.harness import group_actions_by_name as j_group
from gastx.data.harness import load_data as j_load_data
from gastx.eval.protocol import run_evaluation as j_run_evaluation
from gastx.geometry import image_coordinates as j_image_coordinates
from gastx.geometry import world_to_camera as j_world_to_camera
from gastx_torch.cli import trainval
from gastx_torch.data.harness import group_actions_by_name, load_data
from gastx_torch.eval import run_evaluation
from gastx_torch.geometry import image_coordinates, world_to_camera
from gastx_torch.train import (load_checkpoint, restore_batcher_random_state,
                               save_checkpoint)
from test_torch_common import ATOL, RTOL, port_model, random_jax_tree

SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]
CFG = jm.GastNetConfig(filter_widths=(3, 3), channels=16, dropout=0.0)


@pytest.fixture()
def synthetic_h36m(tmp_path):
    rng = np.random.default_rng(0)
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    positions_3d, positions_2d = {}, {}
    for s in SUBJECTS:
        t = 40
        positions_3d[s] = {"Walking 1": rng.standard_normal(
            (t, 32, 3)).astype(np.float32)}
        positions_2d[s] = {"Walking 1": [
            (rng.random((t, 17, 2)) * 1000).astype(np.float32)
            for _ in range(4)]}
    np.savez_compressed(data_dir / "data_3d_h36m.npz",
                        positions_3d=positions_3d)
    metadata = {"layout_name": "h36m", "num_joints": 17,
                "keypoints_symmetry": [[4, 5, 6, 11, 12, 13],
                                       [1, 2, 3, 14, 15, 16]]}
    np.savez_compressed(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz",
                        positions_2d=positions_2d, metadata=metadata)
    return tmp_path


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=name)


def test_geometry_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal(4).astype(np.float32)
    q /= np.linalg.norm(q)
    pts = rng.standard_normal((6, 17, 3)).astype(np.float32)
    t = rng.standard_normal(3).astype(np.float32)
    _close(world_to_camera(pts, R=q, t=t), j_world_to_camera(pts, R=q, t=t))
    px = rng.standard_normal((6, 17, 2)).astype(np.float32)
    _close(image_coordinates(px, 1000, 1002),
           j_image_coordinates(px, w=1000, h=1002))


def test_load_data_matches_jax(synthetic_h36m):
    """The port's harness loads what the JAX package's loads: the
    normalized 2D keypoints, the per-camera root-relative 3D poses, the
    symmetries and the skeleton."""
    data_dir = str(synthetic_h36m / "data")
    got = load_data("h36m", "cpn_ft_h36m_dbb", data_dir)
    want = j_load_data("h36m", "cpn_ft_h36m_dbb", data_dir)
    assert got[3:] == want[3:]        # kps_left/right, joints_left/right
    assert got[1].skeleton().num_joints() == want[1].skeleton().num_joints()
    np.testing.assert_array_equal(got[1].skeleton().parents(),
                                  want[1].skeleton().parents())
    for s in SUBJECTS:
        for cam in range(4):
            _close(got[0][s]["Walking 1"][cam], want[0][s]["Walking 1"][cam])
            _close(got[1][s]["Walking 1"]["positions_3d"][cam],
                   want[1][s]["Walking 1"]["positions_3d"][cam])
    assert group_actions_by_name(got[1], SUBJECTS) == j_group(want[1],
                                                              SUBJECTS)


def test_run_evaluation_matches_jax(synthetic_h36m):
    """Action-wise P1 and P2 with flip TTA from the same weights; the
    model comes back in the mode it went in."""
    data_dir = str(synthetic_h36m / "data")
    params, state = random_jax_tree(CFG, 2)
    model = port_model(CFG, params, state, dropout=0.0).train()
    kps, ds, _, kl, kr, _, _ = load_data("h36m", "cpn_ft_h36m_dbb", data_dir)
    jkps, jds, _, _, _, _, _ = j_load_data("h36m", "cpn_ft_h36m_dbb",
                                           data_dir)
    logs = []
    got = run_evaluation(model, group_actions_by_name(ds, ["S9", "S11"])[0],
                         ds, kps, downsample=1, kps_lr=(kl, kr),
                         log=logs.append)
    assert model.training
    want = j_run_evaluation(params, state, j_group(jds, ["S9", "S11"])[0],
                            jds, jkps, CFG, downsample=1, kps_lr=(kl, kr),
                            log=lambda *_: None)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=RTOL)
    assert any("Protocol #2" in line for line in logs)


def test_checkpoint_round_trip_and_refuses_jax_ckpt(tmp_path):
    from gastx_torch.models import GastNetConfig, build_gastnet
    from gastx_torch.train import make_optimizer

    model = build_gastnet(GastNetConfig(filter_widths=(3, 3), channels=16),
                          device="cpu")
    opt = make_optimizer(model.parameters())
    model(torch.zeros(1, 9, 17, 2)).sum()      # eval forward: no grad
    rs = np.random.RandomState(1234)
    rs.permutation(10)
    path = str(tmp_path / "c.pt")
    save_checkpoint(path, epoch=7, lr=4.2e-4, model=model, optimizer=opt,
                    batcher_random_state=rs, extra={"note": "x"})
    blob = load_checkpoint(path)
    assert (blob["epoch"], blob["lr"], blob["extra"]) == (7, 4.2e-4,
                                                          {"note": "x"})
    for k, v in model.state_dict().items():
        assert torch.equal(blob["model"][k], v), k
    np.testing.assert_array_equal(
        restore_batcher_random_state(blob).permutation(100),
        rs.permutation(100))
    jax_ckpt = str(tmp_path / "epoch_1.ckpt")
    with open(jax_ckpt, "wb") as f:
        pickle.dump({"format": "gastx-checkpoint-v1", "epoch": 1}, f)
    with pytest.raises(ValueError, match="cannot be read"):
        load_checkpoint(jax_ckpt)


def _argv(tmp, ckpt, *extra):
    return ["-arc", "3,3", "-ch", "16", "-b", "32", "--downsample", "1",
            "--checkpoint", str(tmp / ckpt), "--device", "cpu",
            "--data-dir", str(tmp / "data"), *extra]


def _p1(out):
    return [float(v) for v in re.findall(
        r"Protocol #1 Error \(MPJPE\): (\S+) mm", out)]


def test_trainval_end_to_end_on_cpu(synthetic_h36m, capsys):
    """Train one epoch with evaluation, checkpoint, evaluate the
    checkpoint, and evaluate the same weights as an upstream .bin (by
    subject): the P1 numbers agree."""
    import json

    tmp = synthetic_h36m
    log_file = str(tmp / "metrics.jsonl")
    trainval.main(_argv(tmp, "ckpt", "-e", "1", "--checkpoint-frequency",
                        "1", "--log-file", log_file))
    out = capsys.readouterr().out
    assert "Receptive field: 9 frames" in out
    assert "running on cpu" in out
    assert "3d_valid" in out and "action-wise average" in out
    assert os.path.exists(tmp / "ckpt" / "epoch_1.pt")
    with open(log_file) as f:
        record = json.loads(f.readline())
    assert record["step"] == 1 and record["train_frames"] > 0
    assert np.isfinite(record["train_mpjpe_mm"])

    trainval.main(_argv(tmp, "ckpt", "--evaluate", "epoch_1.pt"))
    out_pt = capsys.readouterr().out
    assert "Protocol #1" in out_pt and "Protocol #2" in out_pt

    sd = load_checkpoint(str(tmp / "ckpt" / "epoch_1.pt"))["model"]
    torch.save({"epoch": 1, "model_pos": {f"module.{k}": v
                                          for k, v in sd.items()}},
               str(tmp / "ckpt" / "upstream.bin"))
    trainval.main(_argv(tmp, "ckpt", "--evaluate", "upstream.bin",
                        "--by-subject"))
    out_bin = capsys.readouterr().out
    assert "Evaluating on subject S9" in out_bin
    assert "Evaluating on subject S11" in out_bin
    # By subject, the two subjects' errors average to the whole run's.
    p1_pt, p1_bin = _p1(out_pt), _p1(out_bin)
    assert len(p1_pt) == 1 and len(p1_bin) == 2
    np.testing.assert_allclose(np.mean(p1_bin), p1_pt[0], rtol=1e-5)


def test_resume_is_bitwise_on_cpu(synthetic_h36m):
    """Two epochs straight against one epoch, a checkpoint and a resume:
    every tensor of the model and the optimizer, the epoch and the lr are
    equal bit for bit (dropout on: each step seeds its own masks)."""
    tmp = synthetic_h36m
    common = ("--no-eval", "--checkpoint-frequency", "1")
    trainval.main(_argv(tmp, "straight", "-e", "2", *common))
    trainval.main(_argv(tmp, "resumed", "-e", "1", *common))
    trainval.main(_argv(tmp, "resumed", "-e", "2", "-r", "epoch_1.pt",
                        *common))
    a = load_checkpoint(str(tmp / "straight" / "epoch_2.pt"))
    b = load_checkpoint(str(tmp / "resumed" / "epoch_2.pt"))
    assert a["epoch"] == b["epoch"] == 2 and a["lr"] == b["lr"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(v, sb[i][k]), (i, k)
    assert a["random_state"]["pos"] == b["random_state"]["pos"]
    assert torch.equal(a["random_state"]["keys"], b["random_state"]["keys"])


@pytest.mark.parametrize("flag,item", [
    (["--render"], "item 6"), (["--profile-dir", "prof"], "item 8"),
    (["--matmul-precision", "mixed"], "item 2")])
def test_trainval_refuses_flags_not_ported(synthetic_h36m, capsys, flag,
                                           item):
    """No flag is refused any more: --render (item 6, rendering;
    test_torch_viz_data runs it) and --matmul-precision (item 2, the
    precision tiers; test_torch_precision holds its mapping to JAX's)
    parse, and --profile-dir (item 8, profiling) writes a torch.profiler
    trace of the first epoch that names each train step."""
    if item == "item 2":
        args = trainval.parse_args(_argv(synthetic_h36m, "ckpt", *flag))
        assert args.matmul_precision == "mixed"
        return
    if item == "item 6":
        assert trainval.parse_args(_argv(synthetic_h36m, "ckpt", *flag)).render
        return
    prof = synthetic_h36m / flag[1]
    trainval.main(_argv(synthetic_h36m, "ckpt", flag[0], str(prof), "-e",
                        "1", "--no-eval", "-b", "400"))
    assert "error" not in capsys.readouterr().err
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert '"train_step"' in traces[0].read_text()


def test_trainval_two_gloo_ranks_match_one_process(synthetic_h36m):
    """trainval's loop under ``torch.distributed.run`` with two gloo ranks
    on the CPU, on an epoch whose last batch is ragged (100 real rows of
    500: rank 1 holds only filler rows), gives the one-process epoch loss
    (the port's counterpart of tests/test_train.py's data-parallel
    equivalence); only rank 0 logs and writes the checkpoint, which holds
    the bare model's state."""
    import json
    import subprocess
    import sys

    from gastx_torch.parallel.mesh import free_port

    tmp = synthetic_h36m
    common = ("-e", "1", "--no-eval", "--checkpoint-frequency", "1",
              "-b", "500")

    def argv(name):
        return [*_argv(tmp, name, *common), "--log-file",
                str(tmp / f"{name}.jsonl")]

    trainval.main(argv("one"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port",
         str(free_port()), "-m", "gastx_torch.cli.trainval", *argv("two")],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "process group of 2 rank(s)" in run.stdout
    assert run.stdout.count("Training on 2000 frames") == 1

    def logged(name):
        with open(tmp / f"{name}.jsonl") as f:
            records = [json.loads(line) for line in f]
        assert len(records) == 1
        return records[0]

    one, two = logged("one"), logged("two")
    assert one["train_frames"] == two["train_frames"] == 1600
    np.testing.assert_allclose(two["train_mpjpe_mm"] / 1000,
                               one["train_mpjpe_mm"] / 1000, atol=ATOL,
                               rtol=RTOL)
    assert sorted(os.listdir(tmp / "two")) == ["epoch_1.pt"]
    sd = load_checkpoint(str(tmp / "two" / "epoch_1.pt"))["model"]
    assert not any(k.startswith("module.") for k in sd)
    trainval.main(_argv(tmp, "two", "--evaluate", "epoch_1.pt"))


def test_trainval_runs_on_cuda_by_default(synthetic_h36m, monkeypatch):
    """No --device and no GPU: it raises instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(synthetic_h36m, "ckpt") if a not in
            ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainval.main(argv)


def test_training_curves_need_matplotlib(tmp_path, monkeypatch):
    import sys

    from gastx_torch.utils import export_training_curves

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        export_training_curves(str(tmp_path / "c.png"), [1.0] * 5,
                               [1.0] * 5, [1.0] * 5)
