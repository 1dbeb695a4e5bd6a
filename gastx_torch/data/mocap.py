"""Motion-capture dataset container (a copy of ``gastx.data.mocap``): a
dict-like store ``data[subject][action] = {positions, cameras}`` with the
skeleton and fps, and joint removal that reaches every position array.
"""
from __future__ import annotations

from typing import Dict, Sequence

from gastx_torch.skeleton import Skeleton


class MocapDataset:
    def __init__(self, fps: int, skeleton: Skeleton):
        self._skeleton = skeleton
        self._fps = fps
        self._data: Dict = {}
        self._cameras: Dict = {}

    def remove_joints(self, joints_to_remove: Sequence[int]) -> None:
        kept_joints = self._skeleton.remove_joints(joints_to_remove)
        for subject in self._data:
            for action in self._data[subject]:
                entry = self._data[subject][action]
                if "positions" in entry and entry["positions"] is not None:
                    entry["positions"] = entry["positions"][:, kept_joints]

    def __getitem__(self, key):
        return self._data[key]

    def subjects(self):
        return self._data.keys()

    def fps(self) -> int:
        return self._fps

    def skeleton(self) -> Skeleton:
        return self._skeleton

    def cameras(self) -> Dict:
        return self._cameras
