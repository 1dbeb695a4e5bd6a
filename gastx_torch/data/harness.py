"""Data-loading harness (a copy of ``gastx.data.harness``): dataset
assembly, subject/action selection, downsampling and the deterministic
subset reduction.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gastx_torch.geometry import normalize_screen_coordinates, world_to_camera

# Mask-RCNN COCO-17 detections -> HumanEva-15 joint synthesis
# (main.py:79-98): rows = humaneva joint, entries = coco sources averaged.
_HUMANEVA15_FROM_COCO = [
    (11, 12), (5, 6), (5,), (7,), (9,), (6,), (8,), (10,),
    (11,), (13,), (15,), (12,), (14,), (16,), (0,),
]


def deterministic_random(min_value: int, max_value: int, data: str) -> int:
    """Stable pseudo-random int in [min, max) keyed by a string."""
    digest = hashlib.sha256(data.encode()).digest()
    raw = int.from_bytes(digest[:4], byteorder="little", signed=False)
    return int(raw / (2**32 - 1) * (max_value - min_value) + min_value)


def coco17_to_humaneva15(kps: np.ndarray) -> np.ndarray:
    """(T, 17, C) COCO detections -> (T, 15, C) HumanEva layout."""
    out = np.zeros((kps.shape[0], 15, kps.shape[2]), dtype=np.float32)
    for j, sources in enumerate(_HUMANEVA15_FROM_COCO):
        out[:, j] = np.mean(kps[:, list(sources)], axis=1) if len(sources) > 1 \
            else kps[:, sources[0]]
    return out


def load_data(dataset_name: str, keypoints_name: str, data_dir: str = "data"):
    """Load 3D mocap + 2D detections; split world 3D into per-camera
    root-relative 3D (trajectory kept at joint 0); normalize 2D to unit
    screen coords.

    Returns (keypoints, dataset, keypoints_metadata, kps_left, kps_right,
    joints_left, joints_right) as in main.py:12-104.
    """
    dataset_path = f"{data_dir}/data_3d_{dataset_name}.npz"
    if dataset_name == "h36m":
        from gastx_torch.data.h36m import Human36mDataset
        dataset = Human36mDataset(dataset_path, keypoints_name)
    elif dataset_name.startswith("humaneva"):
        from gastx_torch.data.humaneva import HumanEvaDataset
        dataset = HumanEvaDataset(dataset_path)
    else:
        raise KeyError(f"Invalid dataset {dataset_name!r}")

    # World -> per-camera 3D with root-preserving offset removal.
    for subject in dataset.subjects():
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            if "positions" in anim and anim["positions"] is not None:
                positions_3d = []
                for cam in anim["cameras"]:
                    if "orientation" not in cam:
                        continue
                    pos_3d = world_to_camera(
                        anim["positions"], R=cam["orientation"],
                        t=cam["translation"])
                    pos_3d[:, 1:] -= pos_3d[:, :1]
                    positions_3d.append(pos_3d)
                anim["positions_3d"] = positions_3d

    blob = np.load(f"{data_dir}/data_2d_{dataset_name}_{keypoints_name}.npz",
                   allow_pickle=True)
    keypoints_metadata = blob["metadata"].item()
    keypoints_metadata.update({"layout_name": "h36m"})
    keypoints_symmetry = keypoints_metadata["keypoints_symmetry"]

    if dataset_name.startswith("humaneva"):
        kps_left, kps_right = [2, 3, 4, 8, 9, 10], [5, 6, 7, 11, 12, 13]
    else:
        kps_left = list(keypoints_symmetry[0])
        kps_right = list(keypoints_symmetry[1])
    joints_left = list(dataset.skeleton().joints_left())
    joints_right = list(dataset.skeleton().joints_right())

    keypoints = blob["positions_2d"].item()

    # Trim 2D detections to mocap length (extra frames exist in some videos).
    for subject in dataset.subjects():
        assert subject in keypoints, f"Subject {subject} missing from 2D data"
        for action in dataset[subject].keys():
            assert action in keypoints[subject], (
                f"Action {action} of {subject} missing from 2D data")
            if "positions_3d" not in dataset[subject][action]:
                continue
            for cam_idx in range(len(keypoints[subject][action])):
                mocap_len = dataset[subject][action]["positions_3d"][
                    cam_idx].shape[0]
                assert keypoints[subject][action][cam_idx].shape[0] >= mocap_len
                if keypoints[subject][action][cam_idx].shape[0] > mocap_len:
                    keypoints[subject][action][cam_idx] = \
                        keypoints[subject][action][cam_idx][:mocap_len]
            assert len(keypoints[subject][action]) == len(
                dataset[subject][action]["positions_3d"])

    # Normalize 2D to unit screen coordinates (HumanEva: remap COCO-17 -> 15
    # first, main.py:79-101).
    for subject in keypoints.keys():
        for action in keypoints[subject]:
            for cam_idx, kps in enumerate(keypoints[subject][action]):
                cam = dataset.cameras()[subject][cam_idx]
                if dataset_name.startswith("humaneva"):
                    kps = coco17_to_humaneva15(kps)
                kps = np.array(kps, dtype=np.float32)
                kps[..., :2] = np.asarray(normalize_screen_coordinates(
                    kps[..., :2], w=cam["res_w"], h=cam["res_h"]))
                keypoints[subject][action][cam_idx] = kps

    return (keypoints, dataset, keypoints_metadata, kps_left, kps_right,
            joints_left, joints_right)


def fetch(subjects: Sequence[str], action_filter: Optional[Sequence[str]],
          dataset, keypoints: Dict, downsample: int = 5, subset: float = 1,
          parse_3d_poses: bool = True):
    """Collect per-(subject, action, camera) 2D/3D pose lists + intrinsics
    with optional frame-rate downsampling and deterministic subset reduction
    (main.py:107-159)."""
    out_poses_3d: List[np.ndarray] = []
    out_poses_2d: List[np.ndarray] = []
    out_camera_params: List[np.ndarray] = []
    for subject in subjects:
        for action in keypoints[subject].keys():
            if action_filter is not None:
                if not any(action.startswith(a) for a in action_filter):
                    continue

            poses_2d = keypoints[subject][action]
            out_poses_2d.extend(poses_2d)

            if subject in dataset.cameras():
                cams = dataset.cameras()[subject]
                assert len(cams) == len(poses_2d), "Camera count mismatch"
                for cam in cams:
                    if "intrinsic" in cam:
                        out_camera_params.append(cam["intrinsic"])

            if parse_3d_poses and "positions_3d" in dataset[subject][action]:
                poses_3d = dataset[subject][action]["positions_3d"]
                assert len(poses_3d) == len(poses_2d), "Camera count mismatch"
                out_poses_3d.extend(poses_3d)

    cams_out = out_camera_params if out_camera_params else None
    poses_3d_out = out_poses_3d if out_poses_3d else None

    stride = downsample
    if subset < 1:
        for i in range(len(out_poses_2d)):
            n_frames = int(round(len(out_poses_2d[i]) // stride * subset)
                           * stride)
            start = deterministic_random(
                0, len(out_poses_2d[i]) - n_frames + 1,
                str(len(out_poses_2d[i])))
            out_poses_2d[i] = out_poses_2d[i][start:start + n_frames:stride]
            if poses_3d_out is not None:
                poses_3d_out[i] = poses_3d_out[i][start:start + n_frames:stride]
    elif stride > 1:
        for i in range(len(out_poses_2d)):
            out_poses_2d[i] = out_poses_2d[i][::stride]
            if poses_3d_out is not None:
                poses_3d_out[i] = poses_3d_out[i][::stride]

    return cams_out, poses_3d_out, out_poses_2d


def fetch_actions(actions: Sequence[Tuple[str, str]], dataset,
                  keypoints: Dict, downsample: int = 5):
    """Per-action pose collection for protocol evaluation
    (trainval.py:281-301)."""
    out_poses_3d: List[np.ndarray] = []
    out_poses_2d: List[np.ndarray] = []
    for subject, action in actions:
        poses_2d = keypoints[subject][action]
        out_poses_2d.extend(poses_2d)
        poses_3d = dataset[subject][action]["positions_3d"]
        assert len(poses_3d) == len(poses_2d), "Camera count mismatch"
        out_poses_3d.extend(poses_3d)

    if downsample > 1:
        out_poses_2d = [p[::downsample] for p in out_poses_2d]
        out_poses_3d = [p[::downsample] for p in out_poses_3d]
    return out_poses_3d, out_poses_2d


def group_actions_by_name(dataset, subjects: Sequence[str]):
    """{action_name: [(subject, action)]} + per-subject variant
    (trainval.py:263-276)."""
    all_actions: Dict[str, list] = {}
    by_subject: Dict[str, Dict[str, list]] = {}
    for subject in subjects:
        by_subject.setdefault(subject, {})
        for action in dataset[subject].keys():
            action_name = action.split(" ")[0]
            all_actions.setdefault(action_name, []).append((subject, action))
            by_subject[subject].setdefault(action_name, []).append(
                (subject, action))
    return all_actions, by_subject
