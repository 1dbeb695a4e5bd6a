"""Joint-layout registry.

Centralizes every joint-count-specific table that the reference scatters across
files: the skeleton definitions (reference ``reconstruction.py:86-102``,
``model/gast_net.py:261-267``, ``common/humaneva_dataset.py:7-9``), the
distal/left/right tables keyed by joint count (``model/local_attention.py:66-87``)
and the 2D-keypoint metadata blocks (``reconstruction.py:29-55``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from gastx_torch.skeleton.skeleton import Skeleton


@dataclass(frozen=True)
class JointLayout:
    """Static description of a joint layout used by the lifting model."""

    name: str
    num_joints: int
    parents: Tuple[int, ...]
    joints_left: Tuple[int, ...]
    joints_right: Tuple[int, ...]
    distal_joints: Tuple[int, ...]

    def skeleton(self) -> Skeleton:
        return Skeleton(list(self.parents), list(self.joints_left),
                        list(self.joints_right))


# Human3.6M 17-joint body layout (reconstruction.py:96-100).
H36M_17 = JointLayout(
    name="h36m17",
    num_joints=17,
    parents=(-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15),
    joints_left=(4, 5, 6, 11, 12, 13),
    joints_right=(1, 2, 3, 14, 15, 16),
    distal_joints=(3, 6, 10, 13, 16),  # model/local_attention.py:67
)

# Human3.6M 16-joint layout as detected by Stacked Hourglass
# (derived in common/h36m_dataset.py:281-285 by removing joint 9 and
# reparenting the shoulders; distal table at model/local_attention.py:72-75).
SH_16 = JointLayout(
    name="sh16",
    num_joints=16,
    parents=(-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 8, 10, 11, 8, 13, 14),
    joints_left=(4, 5, 6, 10, 11, 12),
    joints_right=(1, 2, 3, 13, 14, 15),
    distal_joints=(3, 6, 9, 12, 15),
)

# HumanEva-I 15-joint layout (common/humaneva_dataset.py:7-9,
# distal table at model/local_attention.py:78-81).
HUMANEVA_15 = JointLayout(
    name="humaneva15",
    num_joints=15,
    parents=(-1, 0, 1, 2, 3, 1, 5, 6, 0, 8, 9, 0, 11, 12, 1),
    joints_left=(2, 3, 4, 8, 9, 10),
    joints_right=(5, 6, 7, 11, 12, 13),
    distal_joints=(4, 7, 10, 13),
)

# Human3.6M 19-joint body+toe layout (reconstruction.py:88-93,
# distal table at model/local_attention.py:84-87).
H36M_19 = JointLayout(
    name="h36m19",
    num_joints=19,
    parents=(-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 10, 13, 14, 10, 16, 17),
    joints_left=(5, 6, 7, 8, 13, 14, 15),
    joints_right=(1, 2, 3, 4, 16, 17, 18),
    distal_joints=(3, 4, 7, 8, 12, 15, 18),
)

LAYOUTS: Dict[str, JointLayout] = {
    layout.name: layout for layout in (H36M_17, SH_16, HUMANEVA_15, H36M_19)
}

_BY_COUNT: Dict[int, JointLayout] = {
    17: H36M_17, 16: SH_16, 15: HUMANEVA_15, 19: H36M_19,
}


def get_layout(name_or_count) -> JointLayout:
    """Look up a layout by registry name or by joint count (the reference keys
    its tables by joint count, model/local_attention.py:66-90)."""
    if isinstance(name_or_count, str):
        return LAYOUTS[name_or_count]
    try:
        return _BY_COUNT[int(name_or_count)]
    except KeyError:
        raise KeyError(f"No joint layout for {name_or_count!r}") from None


# --- 2D keypoint metadata (input formats), reference reconstruction.py:29-55 ---

KEYPOINT_METADATA = {
    "mpii": {
        "layout_name": "mpii",
        "num_joints": 16,
        "keypoints_symmetry": [[3, 4, 5, 13, 14, 15], [0, 1, 2, 10, 11, 12]],
    },
    "coco": {
        "layout_name": "coco",
        "num_joints": 17,
        "keypoints_symmetry": [
            [1, 3, 5, 7, 9, 11, 13, 15],
            [2, 4, 6, 8, 10, 12, 14, 16],
        ],
    },
    "h36m": {
        "layout_name": "h36m",
        "num_joints": 17,
        "keypoints_symmetry": [[4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]],
    },
}
