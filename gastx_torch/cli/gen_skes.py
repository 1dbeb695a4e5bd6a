"""In-the-wild video -> 3D skeletons on the GPU: the full pipeline CLI (the
port of ``gastx.cli.gen_skes``).

Parity target: reference ``gen_skes.py`` — YOLOv3 person detection -> SORT
tracking -> HRNet 2D pose -> COCO->H36M conversion + low-confidence revision
-> GAST-Net lifting with TTA -> pseudo-trajectory / two-person placement ->
animation or compressed npz output.

Usage (mirrors gen_skes.py:163-180)::

    python -m gastx_torch.cli.gen_skes -v baseball.mp4 -np 1 --animation \\
        --yolo-weights checkpoint/yolov3/yolov3.weights \\
        --hrnet-weights checkpoint/hrnet/pose_hrnet_w48_384x288.pth \\
        -w checkpoint/gastnet/27_frame_model.bin

Model weights are the same published files the reference uses; ``-w`` also
takes the port's ``.pt`` and the JAX package's ``.ckpt``. Everything runs
on ``cuda`` unless ``--device`` names another device. Decoding and the
animation run on the host (OpenCV or ffmpeg; matplotlib);
:func:`skeletons_from_frames` is the same pipeline on frames already
decoded.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="gastx_torch in-the-wild 3D pose")
    parser.add_argument("-v", "--video", type=str, required=True,
                        help="input video path")
    parser.add_argument("-np", "--num-person", type=int, default=1,
                        help="number of people to estimate (1 or 2)")
    parser.add_argument("-f", "--frames", type=int, default=27,
                        help="lifting receptive field (27/81/243)")
    parser.add_argument("-ca", "--causal", action="store_true",
                        help="causal (real-time) lifting model")
    parser.add_argument("-w", "--weight", type=str,
                        default="./checkpoint/gastnet/27_frame_model.bin",
                        help="GAST-Net weights (.bin, .pt or .ckpt)")
    parser.add_argument("--yolo-weights", type=str,
                        default="./checkpoint/yolov3/yolov3.weights")
    parser.add_argument("--yolo-cfg", type=str, default=None,
                        help="optional darknet cfg (built-in YOLOv3 spec "
                             "used when omitted)")
    parser.add_argument("--hrnet-weights", type=str,
                        default="./checkpoint/hrnet/pose_hrnet_w48_384x288.pth")
    parser.add_argument("-a", "--animation", action="store_true",
                        help="render an output animation")
    parser.add_argument("-o", "--output-dir", type=str, default="./output")
    parser.add_argument("--random-lifter-weights", action="store_true",
                        help="random GAST-Net weights (pipeline smoke test)")
    parser.add_argument("--det-batch", type=int, default=1,
                        help="frames per batched 2D-pipeline pass (YOLO "
                             "once + HRNet once per chunk; default 1 = the "
                             "reference's per-frame loop)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    return parser.parse_args(argv)


def load_lifter(args, causal: bool):
    """The GAST-Net of ``-f`` on the device: ``-w``'s weights, or with
    ``--random-lifter-weights`` the port's init from seed 0."""
    from gastx_torch.cli.reconstruct import load_weights
    from gastx_torch.device import resolve_device
    from gastx_torch.models import build_gastnet, config_for_frames

    cfg = config_for_frames(args.frames, 17, causal=causal, dropout=0.05)
    device = resolve_device(args.device)
    if args.random_lifter_weights:
        return build_gastnet(cfg, seed=0, device=device)
    return load_weights(cfg, args.weight, device,
                        random_flag="--random-lifter-weights")


def skeletons_from_frames(args, frames, width: int, height: int,
                          estimator=None):
    """The pipeline on an iterable of BGR uint8 frames of ``width`` x
    ``height``: 2D keypoints, revision, lifting with TTA, placement.
    Returns the (M, T, 17, 3) world poses and the (M, T, 17, 2) revised 2D
    keypoints; writes nothing. ``estimator``:
    a :class:`Pose2DEstimator` to reuse (built from the flags if None)."""
    import torch

    from gastx_torch.geometry import normalize_screen_coordinates
    from gastx_torch.infer import lift_to_world
    from gastx_torch.pipeline import (h36m_coco_format, revise_kpts,
                                      revise_skes)
    from gastx_torch.pipeline import video_pose2d as vp

    keypoints, scores = vp.kpts_from_frames(
        frames, args.yolo_weights, args.hrnet_weights,
        num_person=args.num_person, yolo_cfg=args.yolo_cfg,
        estimator=estimator, batch_size=args.det_batch, device=args.device)
    h36m_kpts, h36m_scores, valid_frames = h36m_coco_format(keypoints,
                                                            scores)
    re_kpts = revise_kpts(h36m_kpts, h36m_scores, valid_frames)
    print(f"INFO: detected {len(re_kpts)} person(s)")

    model = load_lifter(args, args.causal)
    print("Generating 3D human pose ...")
    norm_seqs = [
        np.asarray(normalize_screen_coordinates(
            re_kpts[i, frames], w=width, h=height), dtype=np.float32)
        for i, frames in enumerate(valid_frames)
    ]
    with torch.profiler.record_function("gastx_torch.lift"):
        predictions = lift_to_world(model, norm_seqs, tta=True)

    # Pseudo-trajectory + inter-person placement only for 2-person scenes;
    # single-person output just rebases the height (gen_skes.py:133-138).
    if len(predictions) == 2:
        return revise_skes(predictions, re_kpts, valid_frames), re_kpts
    full_pred = np.zeros((len(predictions), re_kpts.shape[1], 17, 3),
                         dtype=np.float32)
    for i, frames in enumerate(valid_frames):
        pred = predictions[i]
        pred[:, :, 2] -= np.amin(pred[:, :, 2])
        full_pred[i, frames] = pred
    return full_pred, re_kpts


def generate_skeletons(args) -> np.ndarray:
    """Decode ``-v`` on the host, run :func:`skeletons_from_frames`, then
    render the animation (``--animation``) or write ``<video>_3d.npz``
    under ``-o``. Returns the (M, T, 17, 3) world poses."""
    from gastx_torch.viz.video_io import get_resolution, read_video

    width, height = get_resolution(args.video)
    full_pred, re_kpts = skeletons_from_frames(
        args, read_video(args.video, bgr=True), width, height)

    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.video))[0]
    if args.animation:
        from gastx_torch.skeleton import H36M_17
        from gastx_torch.viz import render_animation_multiperson

        keypoints_metadata = {
            "keypoints_symmetry": (list(H36M_17.joints_left),
                                   list(H36M_17.joints_right)),
            "layout_name": "Human3.6M", "num_joints": 17}
        out = os.path.join(args.output_dir, base + "_3d.mp4")
        print("Rendering animation to", out)
        render_animation_multiperson(
            re_kpts, keypoints_metadata, list(full_pred), H36M_17.skeleton(),
            25, 3000, np.float32(70.0), out, viewport=(width, height),
            input_video_path=args.video)
    else:
        out = os.path.join(args.output_dir, base + "_3d.npz")
        np.savez_compressed(out, reconstruction=full_pred)
        print("Saved 3D skeletons to", out)
    return full_pred


def main(argv=None):
    import torch

    torch.backends.cudnn.allow_tf32 = False  # float32 convolutions
    generate_skeletons(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
