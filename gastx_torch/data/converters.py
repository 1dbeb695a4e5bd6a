"""2D keypoint layout converter: COCO -> Human3.6M order.

Behavioral parity target: reference ``tools/mpii_coco_h36m.py:20-75``. The
synthesized joints (head, thorax, pelvis, spine) use the exact same affine
combinations of detected joints so lifted outputs match the reference
bit-for-bit. (Note: the reference tree carries a *second*, divergent copy of
the COCO converter with a 0.3 spine-x factor at
lib/pose/hrnet/lib/utils/coco_h36m.py:29; the lifting path uses the 2x copy
reproduced here — SURVEY.md §2.8 "known reference bugs".)

The port's copy of ``gastx.data.converters.coco_h36m`` (the MPII, wholebody
and OpenPose converters wait for the slices that need them). Vectorized
over time; returns ``(kpts_h36m, valid_frames)`` where valid frames are
those with any nonzero keypoint.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# Index maps between layouts (tools/mpii_coco_h36m.py:7-17).
_H36M_COCO_ORDER = [9, 11, 14, 12, 15, 13, 16, 4, 1, 5, 2, 6, 3]
_COCO_ORDER = [0, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_SYNTH_KEYPOINTS = [10, 8, 0, 7]  # head, thorax, pelvis, spine targets


def _valid_frames(kpts: np.ndarray) -> np.ndarray:
    flat = kpts.reshape(kpts.shape[0], -1)
    return np.where(np.sum(flat, axis=1) != 0)[0]


def coco_h36m(keypoints: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """COCO-17 -> H36M-17 keypoints, (T, 17, 2).

    Head/thorax/pelvis/spine are synthesized from facial/shoulder/hip joints
    (tools/mpii_coco_h36m.py:26-39), then post-adjusted.
    """
    t = keypoints.shape[0]
    out = np.zeros_like(keypoints, dtype=np.float32)
    synth = np.zeros((t, 4, 2), dtype=np.float32)

    # head, thorax, pelvis, spine
    synth[:, 0, 0] = np.mean(keypoints[:, 1:5, 0], axis=1, dtype=np.float32)
    synth[:, 0, 1] = (np.sum(keypoints[:, 1:3, 1], axis=1, dtype=np.float32)
                      - keypoints[:, 0, 1])
    synth[:, 1] = np.mean(keypoints[:, 5:7], axis=1, dtype=np.float32)
    synth[:, 1] += (keypoints[:, 0] - synth[:, 1]) / 3
    synth[:, 2] = np.mean(keypoints[:, 11:13], axis=1, dtype=np.float32)
    synth[:, 3] = np.mean(keypoints[:, [5, 6, 11, 12]], axis=1,
                          dtype=np.float32)

    out[:, _SYNTH_KEYPOINTS] = synth
    out[:, _H36M_COCO_ORDER] = keypoints[:, _COCO_ORDER]

    out[:, 9] -= (out[:, 9] - np.mean(keypoints[:, 5:7], axis=1,
                                      dtype=np.float32)) / 4
    out[:, 7, 0] += 2 * (out[:, 7, 0] - np.mean(out[:, [0, 8], 0], axis=1,
                                                dtype=np.float32))
    out[:, 8, 1] -= (np.mean(keypoints[:, 1:3, 1], axis=1, dtype=np.float32)
                     - keypoints[:, 0, 1]) * 2 / 3

    return out, _valid_frames(out)
