"""End-to-end learning demo on synthetic mocap, on the GPU (the port of
``examples/train_synthetic.py``).

Generates smooth random 3D joint motion on the H36M-17 skeleton, projects
it through a real Human3.6M camera (full distortion model), and trains
GastNet to invert the projection: the supervised task of the real recipe,
with data the license allows us to ship. It shows that the training
stack (batcher -> train step -> BN/amsgrad/lr decay -> evaluation on the
hand-written kernels) learns::

    python -m gastx_torch.examples.train_synthetic --steps 300 -arc 3,3 -ch 32

Prints each epoch's train loss and held-out MPJPE; exits non-zero if the
final held-out MPJPE is not at least 3x better than the untrained
model's. The synthetic task plateaus (joints move independently, so depth
along the camera ray has no learnable prior). It runs on ``cuda`` unless
``--device`` names another device.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def make_synthetic_sequences(rng, n_seqs, length, num_joints=17):
    """Smooth sinusoidal joint motion around a rough body template (meters)."""
    template = np.array(
        [[0, 0, 0], [0.13, 0, 0], [0.15, 0, -0.45], [0.17, 0, -0.9],
         [-0.13, 0, 0], [-0.15, 0, -0.45], [-0.17, 0, -0.9],
         [0, -0.03, 0.25], [0, -0.05, 0.5], [0, 0.0, 0.65], [0, 0.05, 0.75],
         [-0.2, -0.04, 0.48], [-0.45, 0, 0.3], [-0.7, 0.05, 0.15],
         [0.2, -0.04, 0.48], [0.45, 0, 0.3], [0.7, 0.05, 0.15]],
        dtype=np.float32)

    sequences = []
    for _ in range(n_seqs):
        t = np.arange(length, dtype=np.float32)[:, None, None]
        freq = rng.uniform(0.02, 0.12, (1, num_joints, 3)).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, (1, num_joints, 3)).astype(
            np.float32)
        amp = rng.uniform(0.02, 0.2, (1, num_joints, 3)).astype(np.float32)
        motion = amp * np.sin(2 * np.pi * freq * t + phase)
        root = np.cumsum(
            rng.standard_normal((length, 1, 3)).astype(np.float32) * 0.004,
            axis=0)
        seq = template[None] + motion + root
        seq[..., 2] += 1.0  # stand on the floor, roughly world origin
        sequences.append(seq.astype(np.float32))
    return sequences


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300,
                        help="approximate number of optimizer steps")
    parser.add_argument("-arc", "--architecture", default="3,3")
    parser.add_argument("-ch", "--channels", type=int, default=32)
    parser.add_argument("-b", "--batch-size", type=int, default=128)
    parser.add_argument("--seqs", type=int, default=24)
    parser.add_argument("--length", type=int, default=180)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    import torch

    from gastx_torch.cli.trainval import step_seed
    from gastx_torch.data.generators import ChunkedBatcher
    from gastx_torch.data.h36m import h36m_cameras
    from gastx_torch.data.prefetch import stage
    from gastx_torch.device import resolve_device
    from gastx_torch.eval.protocol import evaluate_sequences
    from gastx_torch.geometry import (normalize_screen_coordinates,
                                      project_to_2d, world_to_camera)
    from gastx_torch.models import GastNetConfig, build_gastnet
    from gastx_torch.skeleton import H36M_17
    from gastx_torch.train import make_optimizer, train_step

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    cam = h36m_cameras()["S1"][0]

    world = make_synthetic_sequences(rng, args.seqs + 4, args.length)
    poses_3d, poses_2d = [], []
    for seq in world:
        cam_3d = world_to_camera(seq, R=cam["orientation"],
                                 t=cam["translation"])
        px = project_to_2d(torch.from_numpy(cam_3d).reshape(1, -1, 3),
                           torch.from_numpy(cam["intrinsic"][None])).numpy()
        px = px.reshape(seq.shape[0], 17, 2)
        cam_3d[:, 1:] -= cam_3d[:, :1]  # root-relative, trajectory at joint 0
        poses_3d.append(cam_3d.astype(np.float32))
        poses_2d.append(normalize_screen_coordinates(
            px, w=cam["res_w"], h=cam["res_h"]).astype(np.float32))

    train_3d, train_2d = poses_3d[:args.seqs], poses_2d[:args.seqs]
    test_3d, test_2d = poses_3d[args.seqs:], poses_2d[args.seqs:]

    fw = tuple(int(x) for x in args.architecture.split(","))
    cfg = GastNetConfig(filter_widths=fw, channels=args.channels,
                        dropout=0.05)
    pad = (cfg.receptive_field() - 1) // 2
    model = build_gastnet(cfg, seed=0, device=device)

    e0, _ = evaluate_sequences(model, test_2d, test_3d, tta=False,
                               compute_p2=False)
    print(f"untrained held-out MPJPE: {e0:.1f} mm")

    jl, jr = list(H36M_17.joints_left), list(H36M_17.joints_right)
    batcher = ChunkedBatcher(args.batch_size, None, train_3d, train_2d, 1,
                             pad=pad, shuffle=True, augment=True,
                             kps_left=jl, kps_right=jr, joints_left=jl,
                             joints_right=jr)

    opt = make_optimizer(model.parameters())
    generator = torch.Generator(device=device)
    lr = 1e-3
    steps_done = 0
    epoch = 0
    t0 = time.time()
    while steps_done < args.steps:
        losses = []
        for bi, (_, b3, b2) in enumerate(batcher.next_epoch()):
            b = b2.shape[0]
            w = np.zeros(args.batch_size, np.float32)
            w[:b] = 1.0
            if b < args.batch_size:
                reps = args.batch_size - b
                b2 = np.concatenate([b2, np.repeat(b2[-1:], reps, 0)])
                b3 = np.concatenate([b3, np.repeat(b3[-1:], reps, 0)])
            generator.manual_seed(step_seed(epoch, bi))
            loss = train_step(model, opt, stage(b2.astype(np.float32), device),
                              stage(b3.astype(np.float32), device),
                              stage(w, device), lr, generator)
            losses.append(loss)
            steps_done += 1
            if steps_done >= args.steps:
                break
        epoch += 1
        lr *= 0.95
        e, _ = evaluate_sequences(model, test_2d, test_3d, tta=False,
                                  compute_p2=False)
        train_mm = float(torch.stack(losses).mean()) * 1000
        print(f"epoch {epoch} ({steps_done} steps, "
              f"{time.time() - t0:.0f}s): train {train_mm:.1f}"
              f" mm  held-out {e:.1f} mm")

    improvement = e0 / e
    print(f"improvement over untrained: {improvement:.1f}x")
    if improvement < 3:
        print("FAIL: expected at least 3x improvement")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
