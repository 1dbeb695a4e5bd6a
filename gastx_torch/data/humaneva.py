"""HumanEva-I dataset (a copy of ``gastx.data.humaneva``): 15-joint
skeleton, 3 cameras at 640x480, 60 fps. Camera extrinsics are replicated
across the ``Train/``, ``Validate/`` and ``Unlabeled/`` subject prefixes.
"""
from __future__ import annotations

import numpy as np

from gastx_torch.data.mocap import MocapDataset
from gastx_torch.skeleton import HUMANEVA_15

HUMANEVA_NAMES = [
    "Hip", "Thorax", "LShoulder", "LElbow", "LWrist", "RShoulder", "RElbow",
    "RWrist", "LHip", "LKnee", "LAnkle", "RHip", "RKnee", "RAnkle",
    "Neck/Nose",
]

CAMERA_IDS = ("C1", "C2", "C3")
CAMERA_AZIMUTH = (0, -90, 90)  # visualization only
_RES = (640, 480)

# orientation wxyz + translation (mm), rows = C1..C3 per subject.
_EXTRINSICS = {
    "S1": np.array([
        [0.424207, -0.4983646, -0.5802981, 0.4847012,
         4062.227, 663.2477, 1528.397],
        [0.6503354, -0.7481602, -0.0919284, 0.0941766,
         844.8131, -3805.2092, 1504.9929],
        [0.0664734, -0.0690535, 0.7416416, -0.6639132,
         -797.67377, 3916.3174, 1433.6602],
    ], dtype=np.float32),
    "S2": np.array([
        [0.4214752, -0.4961493, -0.5838273, 0.4851187,
         4112.9121, 626.4929, 1545.2988],
        [0.6501393, -0.7476588, -0.0954617, 0.0959808,
         923.5740, -3877.9243, 1504.5518],
        [0.0699353, -0.0712403, 0.7421637, -0.662742,
         -781.4915, 3838.8853, 1444.9929],
    ], dtype=np.float32),
    # S3 shares S1's calibration in the published release.
    "S3": np.array([
        [0.424207, -0.4983646, -0.5802981, 0.4847012,
         4062.2271, 663.2477, 1528.3970],
        [0.6503354, -0.7481602, -0.0919284, 0.0941766,
         844.8131, -3805.2092, 1504.9929],
        [0.0664734, -0.0690535, 0.7416416, -0.6639132,
         -797.6738, 3916.3174, 1433.6602],
    ], dtype=np.float32),
}

_SUBJECT_PREFIXES = ("Train/", "Validate/", "Unlabeled/Train/",
                     "Unlabeled/Validate/", "Unlabeled/")


def humaneva_cameras() -> dict:
    cameras = {}
    for subject, ext in _EXTRINSICS.items():
        cams = []
        for i in range(len(CAMERA_IDS)):
            cams.append({
                "id": CAMERA_IDS[i],
                "res_w": _RES[0],
                "res_h": _RES[1],
                "azimuth": CAMERA_AZIMUTH[i],
                "orientation": ext[i, :4].copy(),
                "translation": (ext[i, 4:] / 1000.0).astype(np.float32),
            })
        cameras[subject] = cams
    # S4 exists in the dataset without published calibration.
    cameras["S4"] = [
        {"id": CAMERA_IDS[i], "res_w": _RES[0], "res_h": _RES[1],
         "azimuth": CAMERA_AZIMUTH[i]} for i in range(len(CAMERA_IDS))
    ]
    # Replicate across split prefixes used by the serialized dataset.
    prefixed = {}
    for subject, cams in cameras.items():
        for prefix in _SUBJECT_PREFIXES:
            prefixed[prefix + subject] = cams
    return prefixed


class HumanEvaDataset(MocapDataset):
    def __init__(self, path: str):
        super().__init__(fps=60, skeleton=HUMANEVA_15.skeleton())
        self._cameras = humaneva_cameras()

        data = np.load(path, allow_pickle=True)["positions_3d"].item()
        self._data = {}
        for subject, actions in data.items():
            self._data[subject] = {}
            for action_name, positions in actions.items():
                self._data[subject][action_name] = {
                    "positions": positions,
                    "cameras": self._cameras[subject],
                }
