"""HumanEva-I dataset preparation (the port's copy of
``gastx.data.prepare_humaneva``; host numpy, scipy imported inside).

Parity target: reference ``data/prepare_data_humaneva.py`` — parse the
processed HumanEva .mat files, split corrupted mocap streams into contiguous
"chunk" actions (:150-168), apply per-video camera sync offsets (:72-95,
:209-212), label the unlabeled segments (:216-231), and emit
``data_3d_humaneva15.npz`` / ``data_2d_humaneva15_*.npz``.
"""
from __future__ import annotations

import os
import re
from glob import glob
from itertools import groupby
from typing import Dict, Optional, Tuple

import numpy as np

from gastx_torch.data.prepare import (check, suggest_metadata,
                                      suggest_pose_importer)

SUBJECTS = ["Train/S1", "Train/S2", "Train/S3",
            "Validate/S1", "Validate/S2", "Validate/S3"]

CAM_MAP = {"C1": 0, "C2": 1, "C3": 2}

# Train/test frame ranges [start, end) per (subject, action).
FRAME_INDEX = {
    "Train/S1": {"Walking 1": (590, 1203), "Jog 1": (367, 740),
                 "ThrowCatch 1": (473, 945), "Gestures 1": (395, 801),
                 "Box 1": (385, 789)},
    "Train/S2": {"Walking 1": (438, 876), "Jog 1": (398, 795),
                 "ThrowCatch 1": (550, 1128), "Gestures 1": (500, 901),
                 "Box 1": (382, 734)},
    "Train/S3": {"Walking 1": (448, 939), "Jog 1": (401, 842),
                 "ThrowCatch 1": (493, 1027), "Gestures 1": (533, 1102),
                 "Box 1": (512, 1021)},
    "Validate/S1": {"Walking 1": (5, 590), "Jog 1": (5, 367),
                    "ThrowCatch 1": (5, 473), "Gestures 1": (5, 395),
                    "Box 1": (5, 385)},
    "Validate/S2": {"Walking 1": (5, 438), "Jog 1": (5, 398),
                    "ThrowCatch 1": (5, 550), "Gestures 1": (5, 500),
                    "Box 1": (5, 382)},
    "Validate/S3": {"Walking 1": (5, 448), "Jog 1": (5, 401),
                    "ThrowCatch 1": (5, 493), "Gestures 1": (5, 533),
                    "Box 1": (5, 512)},
}

# Per-video frames to skip for camera synchronization (C1, C2, C3).
SYNC_DATA = {
    "S1": {"Walking 1": (82, 81, 82), "Jog 1": (51, 51, 50),
           "ThrowCatch 1": (61, 61, 60), "Gestures 1": (45, 45, 44),
           "Box 1": (57, 57, 56)},
    "S2": {"Walking 1": (115, 115, 114), "Jog 1": (100, 100, 99),
           "ThrowCatch 1": (127, 127, 127), "Gestures 1": (122, 122, 121),
           "Box 1": (119, 119, 117)},
    "S3": {"Walking 1": (80, 80, 80), "Jog 1": (65, 65, 65),
           "ThrowCatch 1": (79, 79, 79), "Gestures 1": (83, 83, 82),
           "Box 1": (1, 1, 1)},
    "S4": {},
}


def parse_humaneva_mat(path: str):
    """Parse processed .mat files into (3D chunks, GT-2D chunks,
    frame_mapping) with corrupted-stream splitting."""
    from scipy.io import loadmat

    output: Dict = {}
    output_2d: Dict = {}
    frame_mapping: Dict = {}
    num_joints = None

    for subject in SUBJECTS:
        output[subject] = {}
        output_2d[subject] = {}
        split, subject_name = subject.split("/")
        frame_mapping.setdefault(subject_name, {})

        for f in glob(f"{path}/{subject}/*.mat"):
            action = os.path.splitext(os.path.basename(f))[0]
            canonical = action.replace("_", " ")

            hf = loadmat(f)
            positions = hf["poses_3d"]
            positions_2d = hf["poses_2d"].transpose(1, 0, 2, 3)
            check(positions.shape[0] == positions_2d.shape[0]
                  and positions.shape[1] == positions_2d.shape[2],
                  f"{f}: poses_3d and poses_2d disagree")
            check(num_joints is None or num_joints == positions.shape[1],
                  f"{f}: another joint count")
            num_joints = positions.shape[1]
            check(positions.shape[0] == (
                FRAME_INDEX[subject][canonical][1]
                - FRAME_INDEX[subject][canonical][0]),
                f"{f}: not the frame count of {subject} {canonical}")

            # Split corrupted (non-finite) stream segments into chunks.
            all_chunks = [list(v) for _, v in groupby(
                positions, lambda x: np.isfinite(x).all())]
            all_chunks_2d = [list(v) for _, v in groupby(
                positions_2d, lambda x: np.isfinite(x).all())]
            check(len(all_chunks) == len(all_chunks_2d),
                  f"{f}: the 3D and 2D poses are not finite alike")

            current = FRAME_INDEX[subject][canonical][0]
            chunk_indices = []
            for i, chunk in enumerate(all_chunks):
                next_index = current + len(chunk)
                name = f"{canonical} chunk{i}"
                finite = np.isfinite(chunk).all()
                if finite:
                    output[subject][name] = (
                        np.array(chunk, dtype="float32") / 1000)
                    output_2d[subject][name] = list(np.array(
                        all_chunks_2d[i],
                        dtype="float32").transpose(1, 0, 2, 3))
                chunk_indices.append((current, next_index, finite, split,
                                      name))
                current = next_index
            assert current == FRAME_INDEX[subject][canonical][1]
            frame_mapping[subject_name].setdefault(canonical, [])
            frame_mapping[subject_name][canonical] += chunk_indices

    return output, output_2d, frame_mapping, num_joints


def prepare_humaneva_3d(path: str) -> Tuple[str, Dict]:
    """Emit data_3d_humaneva<J>.npz + GT 2D npz; returns (3d path, mapping)."""
    output, output_2d, frame_mapping, num_joints = parse_humaneva_mat(path)
    metadata = suggest_metadata("humaneva" + str(num_joints))
    base = "data_3d_" + metadata["layout_name"]
    np.savez_compressed(base, positions_3d=output)
    np.savez_compressed(
        "data_2d_" + metadata["layout_name"] + "_gt",
        positions_2d=output_2d, metadata=metadata)
    return base + ".npz", frame_mapping


def prepare_humaneva_2d(detections_path: str, output_suffix: str,
                        frame_mapping: Optional[Dict] = None,
                        layout_name: str = "humaneva15") -> str:
    """Convert user-supplied 2D detections (``S*/<action> (<cam>).avi.npz``)
    with sync offsets + chunk alignment."""
    import_func = suggest_pose_importer(output_suffix)
    metadata = suggest_metadata(output_suffix)
    frame_mapping = frame_mapping or {}

    output: Dict = {}
    for f in glob(detections_path + "/S*/*.avi.npz"):
        path_dir, fname = os.path.split(f)
        subject = os.path.basename(path_dir)
        check(subject.startswith("S"), f"{f}: not under a subject S*")

        m = re.search(r"(.*) \((.*)\)", fname.replace("_", " "))
        action, camera = m.group(1), m.group(2)
        camera_idx = CAM_MAP[camera]

        keypoints = import_func(f)
        check(keypoints.shape[1] == metadata["num_joints"],
              f"{f}: not {metadata['num_joints']} joints")

        sync_offset = (SYNC_DATA[subject][action][camera_idx] - 1
                       if action in SYNC_DATA.get(subject, {}) else 0)

        if subject in frame_mapping and action in frame_mapping[subject]:
            for (start, end, labeled, split, name) in \
                    frame_mapping[subject][action]:
                canonical_subject = f"{split}/{subject}"
                if not labeled:
                    canonical_subject = "Unlabeled/" + canonical_subject
                output.setdefault(canonical_subject, {})
                kps = keypoints[start + sync_offset:end + sync_offset]
                check(len(kps) == end - start,
                      f"{f}: too few frames for {name}")
                output[canonical_subject].setdefault(name, [None, None, None])
                output[canonical_subject][name][camera_idx] = \
                    kps.astype("float32")
        else:
            canonical_subject = "Unlabeled/" + subject
            output.setdefault(canonical_subject, {})
            output[canonical_subject].setdefault(action, [None, None, None])
            output[canonical_subject][action][camera_idx] = \
                keypoints.astype("float32")

    out = f"data_2d_{layout_name}_{output_suffix}"
    np.savez_compressed(out, positions_2d=output, metadata=metadata)
    return out + ".npz"
