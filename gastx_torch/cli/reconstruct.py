"""Offline 3D reconstruction from a 2D keypoints JSON file, on the GPU.

The port of ``gastx.cli.reconstruct``'s ``--no-render`` path: load the
skeleton-JSON keypoints, convert the layout to Human3.6M, normalize to
screen coordinates, lift with edge padding and flip TTA, rotate into world
coordinates, rebase the height and write the poses as npz::

    python -m gastx_torch.cli.reconstruct -k baseball.json --random-weights \\
        --no-render -vo out/baseball

Rendering and reading the video's resolution are not ported yet: the
screen normalization uses 1000x1002, the JAX CLI's size when no video is
given. Weights come from an upstream ``.bin`` or, with
``--random-weights``, from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

WIDTH, HEIGHT = 1000, 1002


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="gastx_torch reconstruction")
    parser.add_argument("-f", "--frames", type=int, default=27,
                        help="receptive field (27/81/243)")
    parser.add_argument("-ca", "--causal", action="store_true",
                        help="use the causal real-time model")
    parser.add_argument("-w", "--weight", type=str,
                        default="27_frame_model.bin",
                        help="upstream .bin weight file")
    parser.add_argument("-n", "--num-joints", type=int, default=17,
                        help="number of joints")
    parser.add_argument("-k", "--keypoints-file", type=str,
                        default="./data/keypoints/baseball.json")
    parser.add_argument("-vo", "--viz-output", type=str,
                        default="./output/baseball.mp4",
                        help="output path; the npz goes beside its stem")
    parser.add_argument("-kf", "--kpts-format", type=str, default="coco",
                        choices=["coco", "h36m"],
                        help="2D layout of the file (the MPII, OpenPose and "
                             "wholebody converters are not ported yet)")
    parser.add_argument("--checkpoint-dir", type=str,
                        default="./checkpoint/gastnet")
    parser.add_argument("--no-render", action="store_true",
                        help="save the 3D poses to npz (the only mode "
                             "ported so far)")
    parser.add_argument("--random-weights", action="store_true",
                        help="run with seeded random weights")
    parser.add_argument("--seed", type=int, default=0,
                        help="torch.Generator seed of --random-weights")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    return parser.parse_args(argv)


def _to_h36m(keypoints: np.ndarray, kpts_format: str):
    from gastx_torch.data import coco_h36m

    if kpts_format == "coco":
        return coco_h36m(keypoints)
    flat = keypoints.reshape(keypoints.shape[0], -1)
    return keypoints, np.where(np.sum(flat, axis=1) != 0)[0]


def load_model(args):
    from gastx_torch.device import resolve_device
    from gastx_torch.io import load_torch_checkpoint
    from gastx_torch.models import GastNet, build_gastnet, config_for_frames

    cfg = config_for_frames(args.frames, args.num_joints, causal=args.causal)
    device = resolve_device(args.device)
    if args.random_weights:
        return build_gastnet(cfg, seed=args.seed, device=device)
    chk = (args.weight if os.path.exists(args.weight)
           else os.path.join(args.checkpoint_dir, args.weight))
    if not chk.endswith(".bin") or not os.path.exists(chk):
        raise SystemExit(f"error: upstream .bin checkpoint not found: {chk} "
                         f"(pass --random-weights for a smoke test)")
    print("Loading checkpoint", chk)
    model = GastNet(cfg)
    model.load_state_dict(load_torch_checkpoint(chk), strict=True)
    return model.to(device).eval()


def reconstruct(args) -> np.ndarray:
    from gastx_torch.data import load_keypoints_json
    from gastx_torch.geometry import normalize_screen_coordinates
    from gastx_torch.infer import lift_to_world

    if not args.no_render:
        raise SystemExit("error: rendering is not ported yet; pass "
                         "--no-render")
    if not os.path.exists(args.keypoints_file):
        raise SystemExit(f"error: keypoints file not found: "
                         f"{args.keypoints_file}")
    model = load_model(args)
    keypoints, _, _, _ = load_keypoints_json(args.keypoints_file,
                                             args.num_joints)
    keypoints, valid_frames = _to_h36m(keypoints[0], args.kpts_format)
    if len(valid_frames) == 0:
        raise SystemExit("error: the keypoints file holds no valid frame")
    norm_kpts = normalize_screen_coordinates(
        keypoints[..., :2], w=WIDTH, h=HEIGHT).astype(np.float32)

    prediction = lift_to_world(model, [norm_kpts[valid_frames]], tta=True)[0]
    prediction[:, :, 2] -= np.min(prediction[:, :, 2])  # rebase height

    prediction_full = np.zeros((keypoints.shape[0], args.num_joints, 3),
                               dtype=np.float32)
    prediction_full[valid_frames] = prediction
    out = os.path.splitext(args.viz_output)[0] + ".npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, reconstruction=prediction_full)
    print("Saved 3D poses to", out)
    return prediction_full


def main(argv=None):
    reconstruct(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
