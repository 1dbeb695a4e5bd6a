"""Skeleton-JSON 2D keypoint loader.

Parity target: ``reconstruction.py:105-145`` (load_json) and the writer format
produced by lib/pose/hrnet/pose_estimation/gen_kpts.py:278-358: a dict with
``label``, ``label_index`` and per-frame ``data`` entries holding per-person
``pose`` (J, 2), ``score`` (J,) and ``bbox`` lists. Wholebody files carry 133
joints (body 17 + feet 6 + hands/face); the 19-joint toe pipeline keeps the
first 23 (body+feet).
"""
from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np


def load_keypoints_json(
    file_path: str, num_joints: int, num_person: int = 2,
    raw_joints: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, str, int]:
    """Returns (keypoints (M, T, J, 2), scores (M, T, J), label, label_index).

    ``raw_joints``: the joints of each pose in the file; by default 133
    (wholebody) for ``num_joints`` 19, else 17 (COCO), as the JAX loader
    reads every file. The 16-joint MPII and 18-joint OpenPose files need
    theirs.
    """
    with open(file_path, "r") as fr:
        video_info = json.load(fr)

    num_joints_raw = raw_joints or (133 if num_joints == 19 else 17)

    label = video_info.get("label", "")
    label_index = video_info.get("label_index", -1)

    num_frames = video_info["data"][-1]["frame_index"]
    keypoints = np.zeros((num_person, num_frames, num_joints_raw, 2),
                         dtype=np.float32)
    scores = np.zeros((num_person, num_frames, num_joints_raw),
                      dtype=np.float32)

    for frame_info in video_info["data"]:
        frame_index = frame_info["frame_index"]
        for index, skeleton_info in enumerate(frame_info["skeleton"]):
            if len(skeleton_info.get("bbox", [])) == 0 or index >= num_person:
                continue
            pose = np.asarray(skeleton_info["pose"], dtype=np.float32)
            score = np.asarray(skeleton_info["score"],
                               dtype=np.float32).reshape(-1)
            keypoints[index, frame_index - 1] = pose
            scores[index, frame_index - 1] = score

    if num_joints != num_joints_raw:
        # body(17) + foot(6) = 23 joints feed the toe converter
        return keypoints[:, :, :23], scores[:, :, :23], label, label_index
    return keypoints, scores, label, label_index


def save_keypoints_json(file_path: str, keypoints: np.ndarray,
                        scores: np.ndarray, label: str = "unknown",
                        label_index: int = -1) -> None:
    """Write (M, T, J, 2) keypoints back to the skeleton-JSON format."""
    num_person, num_frames = keypoints.shape[:2]
    data = []
    for t in range(num_frames):
        skeletons = []
        for m in range(num_person):
            if np.all(keypoints[m, t] == 0):
                continue
            skeletons.append({
                "pose": keypoints[m, t].tolist(),
                "score": scores[m, t].tolist(),
                "bbox": [0.0, 0.0, 0.0, 0.0],
            })
        data.append({"frame_index": t + 1, "skeleton": skeletons})
    with open(file_path, "w") as fw:
        json.dump({"label": label, "label_index": label_index, "data": data},
                  fw)
