"""Offline 3D reconstruction from a 2D keypoints JSON file, on the GPU.

The port of ``gastx.cli.reconstruct``: load the skeleton-JSON keypoints,
convert the layout to Human3.6M (``-kf coco|mpii|openpose|wholebody|h36m``),
normalize to screen coordinates at the video's resolution (``-vi``; where
the file is missing, 1000x1002 as the JAX CLI falls back), lift with edge
padding and flip TTA on the device, rotate into world coordinates, rebase
the height, and render the animation on the host (``-vo``: mp4 or gif) or,
with ``--no-render``, write the poses as npz::

    python -m gastx_torch.cli.reconstruct -w epoch_60.ckpt -k baseball.json \\
        -vi baseball.mp4 -vo out/baseball.mp4
    python -m gastx_torch.cli.reconstruct -k baseball.json --random-weights \\
        --no-render -vo out/baseball

Weights (``-w``) come from an upstream ``.bin``, the port's ``.pt``
(``gastx_torch.train.save_checkpoint``) or the JAX package's ``.ckpt``
(``gastx_torch.io.load_jax_checkpoint``), or with ``--random-weights`` from
a seeded ``torch.Generator``. The lift runs on ``cuda`` unless
``--device`` names another device; rendering needs matplotlib, and a
``-vi`` video cv2 or ffmpeg.

``-kf wholebody`` gives the 19-joint layout (``-n 19``), the others 17
joints. The JAX CLI reads every file with 17 joints a pose (133 at
``-n 19``), so its ``-kf mpii`` and ``-kf openpose`` cannot load a 16- or
18-joint file; the port reads each format's own count (``FILE_JOINTS``).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# The size the screen normalization takes where the -vi video is missing.
WIDTH, HEIGHT = 1000, 1002

# The joints of one pose in a keypoints file of each format (wholebody:
# COCO-WholeBody's 133, of which the body and feet are kept), and the
# joints of the model its conversion feeds; -kf h36m takes -n for both.
FILE_JOINTS = {"coco": 17, "mpii": 16, "openpose": 18, "wholebody": 133}
MODEL_JOINTS = {"coco": 17, "mpii": 17, "openpose": 17, "wholebody": 19}

# -w's formats: an upstream checkpoint, the port's own, the JAX package's.
WEIGHT_FORMATS = (".bin", ".pt", ".ckpt")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="gastx_torch reconstruction")
    parser.add_argument("-f", "--frames", type=int, default=27,
                        help="receptive field (27/81/243)")
    parser.add_argument("-ca", "--causal", action="store_true",
                        help="use the causal real-time model")
    parser.add_argument("-w", "--weight", type=str,
                        default="27_frame_model.bin",
                        help="weight file: an upstream .bin, a gastx_torch "
                             ".pt or a gastx (JAX) .ckpt")
    parser.add_argument("-n", "--num-joints", type=int, default=17,
                        help="number of joints (17, or 19 with -kf "
                             "wholebody)")
    parser.add_argument("-k", "--keypoints-file", type=str,
                        default="./data/keypoints/baseball.json")
    parser.add_argument("-vi", "--video-path", type=str,
                        default="./data/video/baseball.mp4",
                        help="the video: its resolution normalizes the "
                             "keypoints and its frames are rendered behind "
                             "them (1000x1002 and a blank frame where it is "
                             "missing)")
    parser.add_argument("-vo", "--viz-output", type=str,
                        default="./output/baseball.mp4",
                        help="the animation (.mp4 or .gif); with "
                             "--no-render the npz goes beside its stem")
    parser.add_argument("-kf", "--kpts-format", type=str, default="coco",
                        choices=["coco", "mpii", "openpose", "wholebody",
                                 "h36m"],
                        help="2D layout of the file: COCO-17, MPII-16, "
                             "OpenPose-18, COCO-WholeBody (to the 19-joint "
                             "layout) or Human3.6M")
    parser.add_argument("--checkpoint-dir", type=str,
                        default="./checkpoint/gastnet")
    parser.add_argument("--no-render", action="store_true",
                        help="skip the animation; save the 3D poses to npz")
    parser.add_argument("--random-weights", action="store_true",
                        help="run with seeded random weights")
    parser.add_argument("--seed", type=int, default=0,
                        help="torch.Generator seed of --random-weights")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    return parser.parse_args(argv)


def _to_h36m(keypoints: np.ndarray, kpts_format: str):
    from gastx_torch.data import (coco_h36m, coco_h36m_toe_format, mpii_h36m,
                                  openpose_to_coco)

    if kpts_format == "coco":
        return coco_h36m(keypoints)
    if kpts_format == "mpii":
        return mpii_h36m(keypoints)
    if kpts_format == "openpose":
        return coco_h36m(openpose_to_coco(keypoints))
    if kpts_format == "wholebody":
        return coco_h36m_toe_format(keypoints)
    flat = keypoints.reshape(keypoints.shape[0], -1)  # h36m
    return keypoints, np.where(np.sum(flat, axis=1) != 0)[0]


def _video(path: str):
    """The -vi video's path and (width, height), or None and the
    fallback size where it is missing."""
    if path and os.path.exists(path):
        from gastx_torch.viz import get_resolution
        return path, get_resolution(path)
    return None, (WIDTH, HEIGHT)


def load_weights(cfg, chk: str, device,
                 random_flag: str = "--random-weights") -> "GastNet":
    """A GastNet of ``cfg`` with the weights of ``chk`` (an upstream
    ``.bin``, the port's ``.pt`` or the JAX package's ``.ckpt``), in eval
    mode on ``device``; any other or missing file stops naming the three
    and the CLI's ``random_flag``."""
    from gastx_torch.io import load_jax_checkpoint, load_torch_checkpoint
    from gastx_torch.models import GastNet
    from gastx_torch.train import load_checkpoint

    ext = os.path.splitext(chk)[1]
    if ext not in WEIGHT_FORMATS or not os.path.exists(chk):
        raise SystemExit(
            f"error: no weight file {chk} of a known format: -w takes an "
            f"upstream .bin, a gastx_torch .pt or a gastx (JAX) .ckpt "
            f"(pass {random_flag} for a smoke test)")
    print("Loading checkpoint", chk)
    if ext == ".bin":
        state_dict = load_torch_checkpoint(chk)
    elif ext == ".pt":
        state_dict = load_checkpoint(chk)["model"]
    else:
        state_dict = load_jax_checkpoint(chk, cfg)["model"]
    model = GastNet(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


def load_model(args):
    from gastx_torch.device import resolve_device
    from gastx_torch.models import build_gastnet, config_for_frames

    cfg = config_for_frames(args.frames, args.num_joints, causal=args.causal)
    device = resolve_device(args.device)
    if args.random_weights:
        return build_gastnet(cfg, seed=args.seed, device=device)
    chk = (args.weight if os.path.exists(args.weight)
           else os.path.join(args.checkpoint_dir, args.weight))
    return load_weights(cfg, chk, device)


def reconstruct(args) -> np.ndarray:
    from gastx_torch.data import load_keypoints_json
    from gastx_torch.geometry import normalize_screen_coordinates
    from gastx_torch.infer import lift_to_world

    if not os.path.exists(args.keypoints_file):
        raise SystemExit(f"error: keypoints file not found: "
                         f"{args.keypoints_file}")
    joints = MODEL_JOINTS.get(args.kpts_format, args.num_joints)
    if args.num_joints != joints:
        raise SystemExit(f"error: -kf {args.kpts_format} gives {joints} "
                         f"joints; pass -n {joints}")
    model = load_model(args)
    keypoints, _, _, _ = load_keypoints_json(
        args.keypoints_file, args.num_joints,
        raw_joints=FILE_JOINTS.get(args.kpts_format, args.num_joints))
    keypoints, valid_frames = _to_h36m(keypoints[0], args.kpts_format)
    if len(valid_frames) == 0:
        raise SystemExit("error: the keypoints file holds no valid frame")
    video, (width, height) = _video(args.video_path)
    norm_kpts = normalize_screen_coordinates(
        keypoints[..., :2], w=width, h=height).astype(np.float32)

    prediction = lift_to_world(model, [norm_kpts[valid_frames]], tta=True)[0]
    prediction[:, :, 2] -= np.min(prediction[:, :, 2])  # rebase height

    prediction_full = np.zeros((keypoints.shape[0], args.num_joints, 3),
                               dtype=np.float32)
    prediction_full[valid_frames] = prediction
    if args.no_render:
        out = os.path.splitext(args.viz_output)[0] + ".npz"
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        np.savez_compressed(out, reconstruction=prediction_full)
        print("Saved 3D poses to", out)
        return prediction_full

    from gastx_torch.skeleton import get_layout
    from gastx_torch.viz import render_animation

    print("Rendering ...")
    layout = get_layout(args.num_joints)
    keypoints_metadata = {
        "keypoints_symmetry": (list(layout.joints_left),
                               list(layout.joints_right)),
        "layout_name": "Human3.6M",
        "num_joints": args.num_joints,
    }
    os.makedirs(os.path.dirname(args.viz_output) or ".", exist_ok=True)
    render_animation(
        keypoints, keypoints_metadata, {"Reconstruction": prediction_full},
        layout.skeleton(), 25, 3000, np.float32(70.0), args.viz_output,
        viewport=(width, height), limit=-1, downsample=1, size=5,
        input_video_path=video, input_video_skip=0)
    return prediction_full


def main(argv=None):
    reconstruct(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
