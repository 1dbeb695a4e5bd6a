"""Skeleton topology container.

Parity target: reference ``common/skeleton.py:4-81`` (parents array, left/right
joint lists, joint removal with parent rewiring). Pure numpy / host-side.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


class Skeleton:
    """Kinematic tree described by a parents array plus left/right joint lists."""

    def __init__(self, parents: Sequence[int], joints_left: Sequence[int],
                 joints_right: Sequence[int]):
        assert len(joints_left) == len(joints_right)
        self._parents = np.array(parents, dtype=np.int64)
        self._joints_left = list(joints_left)
        self._joints_right = list(joints_right)
        self._compute_metadata()

    def num_joints(self) -> int:
        return len(self._parents)

    def parents(self) -> np.ndarray:
        return self._parents

    def has_children(self) -> np.ndarray:
        return self._has_children

    def children(self) -> List[List[int]]:
        return self._children

    def joints_left(self) -> List[int]:
        return self._joints_left

    def joints_right(self) -> List[int]:
        return self._joints_right

    def remove_joints(self, joints_to_remove: Sequence[int]) -> List[int]:
        """Remove joints, rewiring children to the nearest kept ancestor.

        Returns the list of kept original indices. Mirrors the reindexing
        semantics of common/skeleton.py:24-63 (left/right lists remapped, any
        removed entries dropped).
        """
        joints_to_remove = set(int(j) for j in joints_to_remove)
        valid_joints = [j for j in range(len(self._parents))
                        if j not in joints_to_remove]

        parents = list(self._parents)
        for i in range(len(parents)):
            while parents[i] in joints_to_remove:
                parents[i] = parents[parents[i]]

        index_offsets = np.zeros(len(parents), dtype=np.int64)
        new_parents = []
        for i, parent in enumerate(parents):
            if i not in joints_to_remove:
                new_parents.append(parent - index_offsets[parent])
            else:
                index_offsets[i:] += 1
        self._parents = np.array(new_parents, dtype=np.int64)

        self._joints_left = [j - int(index_offsets[j]) for j in self._joints_left
                             if j in valid_joints]
        self._joints_right = [j - int(index_offsets[j]) for j in self._joints_right
                              if j in valid_joints]

        self._compute_metadata()
        return valid_joints

    def _compute_metadata(self) -> None:
        self._has_children = np.zeros(len(self._parents), dtype=bool)
        self._children: List[List[int]] = [[] for _ in self._parents]
        for i, parent in enumerate(self._parents):
            if parent != -1:
                self._has_children[parent] = True
                self._children[parent].append(i)
