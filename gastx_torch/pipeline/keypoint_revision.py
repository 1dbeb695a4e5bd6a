"""Detected-keypoint post-processing for the in-the-wild pipeline (the
port's copy of ``gastx.pipeline.keypoint_revision``).

Behavioral parity target: reference ``tools/preprocess.py``:
  * ``h36m_coco_format`` (:47-75) — per-person COCO->H36M conversion with
    confidence-score synthesis for the derived joints.
  * ``revise_kpts`` (:78-112) — low-confidence (<0.3) knee/ankle joints are
    substituted by their parent hip/knee positions via a fixed case table.
  * ``revise_skes`` (:123-155) — re-injects a per-person pseudo-trajectory
    from 2D pelvis/hip motion (ratio 2D:3D = 500) and, for 2-person scenes,
    an inter-person offset; rebases the global height.
  * ``revise_skes_real_time`` (:158-172) — streaming single-frame variant.

All host-side numpy: these operate on ragged per-person valid-frame lists
that never cross to the device (SURVEY.md §7 "ragged real-world
sequences").
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gastx_torch.data.converters import (
    _COCO_ORDER,
    _H36M_COCO_ORDER,
    _SYNTH_KEYPOINTS,
    coco_h36m,
)
RATIO_2D_3D = 500.0
# hips + shoulders: the anchor joints for trajectory estimation
_ANCHOR_JOINTS = [1, 4, 11, 14]

# Substitution table for low-confidence leg joints: {sorted joint subset
# below threshold -> replacement source joints} (tools/preprocess.py:96-108).
_REVISION_CASES = [
    ([2, 3, 5, 6], [1, 1, 4, 4]),
    ([2, 3, 6], [1, 1, 5]),
    ([3, 5, 6], [2, 4, 4]),
    ([3, 6], [2, 5]),
    ([3], [2]),
    ([6], [5]),
]


def h36m_coco_format(keypoints: np.ndarray, scores: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """(M, T, 17, 2) COCO keypoints + (M, T, 17) scores -> H36M order.

    Returns (kpts (M', T, 17, 2), scores (M', T, 17), valid_frames per
    person); persons with all-zero detections are dropped.
    """
    assert keypoints.ndim == 4 and scores.ndim == 3

    h36m_kpts, h36m_scores, valid_frames = [], [], []
    for person_kpts, person_scores in zip(keypoints, scores):
        if np.sum(person_kpts) == 0.0:
            continue
        kpts, valid = coco_h36m(person_kpts)
        h36m_kpts.append(kpts)
        valid_frames.append(valid)

        new_score = np.zeros_like(person_scores, dtype=np.float32)
        new_score[:, _H36M_COCO_ORDER] = person_scores[:, _COCO_ORDER]
        new_score[:, 0] = np.mean(person_scores[:, [11, 12]], axis=1,
                                  dtype=np.float32)
        new_score[:, 8] = np.mean(person_scores[:, [5, 6]], axis=1,
                                  dtype=np.float32)
        new_score[:, 7] = np.mean(new_score[:, [0, 8]], axis=1,
                                  dtype=np.float32)
        new_score[:, 10] = np.mean(person_scores[:, [1, 2, 3, 4]], axis=1,
                                   dtype=np.float32)
        h36m_scores.append(new_score)

    return (np.asarray(h36m_kpts, dtype=np.float32),
            np.asarray(h36m_scores, dtype=np.float32), valid_frames)


def revise_kpts(h36m_kpts: np.ndarray, h36m_scores: np.ndarray,
                valid_frames: List[np.ndarray]) -> np.ndarray:
    """Substitute low-confidence knee/ankle joints with parent positions."""
    new_kpts = np.zeros_like(h36m_kpts)
    for index, frames in enumerate(valid_frames):
        kpts = h36m_kpts[index, frames].copy()
        score = h36m_scores[index, frames]

        for frame in np.where(np.sum(score < 0.3, axis=1) > 0)[0]:
            low = set(np.where(score[frame] < 0.3)[0].tolist())
            intersect = [j for j in [2, 3, 5, 6] if j in low]
            for targets, sources in _REVISION_CASES:
                if intersect == targets:
                    kpts[frame, targets] = kpts[frame, sources]
                    break

        new_kpts[index, frames] = kpts
    return new_kpts


def revise_skes(prediction: List[np.ndarray], re_kpts: np.ndarray,
                valid_frames: List[np.ndarray]) -> np.ndarray:
    """Re-inject pseudo-trajectory + inter-person placement into root-relative
    3D predictions; returns (M, T, J, 3) full-timeline world poses."""
    new_prediction = np.zeros((*re_kpts.shape[:-1], 3), dtype=np.float32)
    for i, frames in enumerate(valid_frames):
        new_prediction[i, frames] = prediction[i]

        # 2D anchor-joint displacement from the first valid frame drives the
        # horizontal trajectory (image y is inverted vs world y).
        distance = re_kpts[i, frames[1:], :, :2] - re_kpts[i, frames[:1], :, :2]
        distance = np.mean(distance[:, _ANCHOR_JOINTS], axis=-2,
                           keepdims=True)
        new_prediction[i, frames[1:], :, 0] -= distance[..., 0] / RATIO_2D_3D
        new_prediction[i, frames[1:], :, 1] += distance[..., 1] / RATIO_2D_3D

    if len(valid_frames) == 2:
        # Relative placement of a 2-person scene from their first common frame
        common = [f for f in valid_frames[0] if f in set(valid_frames[1])]
        offset = re_kpts[0, common[:1], :, :2] - re_kpts[1, common[:1], :, :2]
        offset = np.mean(offset[:, _ANCHOR_JOINTS], axis=-2,
                         keepdims=True) / 2.0

        new_prediction[0, valid_frames[0], :, 0] -= offset[..., 0] / RATIO_2D_3D
        new_prediction[0, valid_frames[0], :, 1] += offset[..., 1] / RATIO_2D_3D
        new_prediction[1, valid_frames[1], :, 0] += offset[..., 0] / RATIO_2D_3D
        new_prediction[1, valid_frames[1], :, 1] -= offset[..., 1] / RATIO_2D_3D

    new_prediction[:, :, :, 2] -= np.amin(new_prediction[:, :, :, 2])
    return new_prediction


def coco_h36m_frame(keypoints: np.ndarray) -> np.ndarray:
    """Single-frame COCO-17 -> H36M-17 converter used by the reference's
    REAL-TIME path (tools/utils.py:107-130 / the hrnet-side copy at
    lib/pose/hrnet/lib/utils/coco_h36m.py).

    NOTE: deliberately uses the 0.3 spine-x factor of that copy — the
    offline lifting path uses the 2x copy in :mod:`gastx_torch.data.converters`
    (SURVEY.md §7 "known reference bugs": two divergent copies exist
    upstream; behavior is preserved per call-site).
    """
    out = np.zeros_like(keypoints, dtype=np.float32)
    synth = np.zeros((4, 2), dtype=np.float32)

    synth[0, 0] = np.mean(keypoints[1:5, 0], dtype=np.float32)
    synth[0, 1] = np.sum(keypoints[1:3, 1], dtype=np.float32) - keypoints[0, 1]
    synth[1] = np.mean(keypoints[5:7], axis=0, dtype=np.float32)
    synth[1] += (keypoints[0] - synth[1]) / 3
    synth[2] = np.mean(keypoints[11:13], axis=0, dtype=np.float32)
    synth[3] = np.mean(keypoints[[5, 6, 11, 12]], axis=0, dtype=np.float32)

    out[_SYNTH_KEYPOINTS] = synth
    out[_H36M_COCO_ORDER] = keypoints[_COCO_ORDER]

    out[9] -= (out[9] - np.mean(keypoints[5:7], axis=0,
                                dtype=np.float32)) / 4
    out[7, 0] += 0.3 * (out[7, 0] - np.mean(out[[0, 8], 0],
                                            dtype=np.float32))
    out[8, 1] -= (np.mean(keypoints[1:3, 1], dtype=np.float32)
                  - keypoints[0, 1]) * 2 / 3
    return out


def h36m_coco_kpts(keypoints: np.ndarray, scores: np.ndarray
                   ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-frame multi-person converter + low-confidence revision for the
    real-time path (tools/utils.py:133-175). ``keypoints``: (M, 17, C);
    ``scores``: (M, 17, 1). Persons with all-zero detections are dropped."""
    assert keypoints.ndim == 3 and scores.ndim == 3

    h36m_kpts, h36m_scores = [], []
    for kpts, score in zip(keypoints, scores[..., 0]):
        if np.sum(kpts) == 0.0:
            continue
        new_score = np.zeros_like(score, dtype=np.float32)
        new_score[_H36M_COCO_ORDER] = score[_COCO_ORDER]
        new_score[0] = np.mean(score[[11, 12]], dtype=np.float32)
        new_score[8] = np.mean(score[[5, 6]], dtype=np.float32)
        new_score[7] = np.mean(new_score[[0, 8]], dtype=np.float32)
        new_score[10] = np.mean(score[[1, 2, 3, 4]], dtype=np.float32)
        h36m_scores.append(new_score)

        kpts = coco_h36m_frame(kpts)
        low = set(np.where(new_score < 0.3)[0].tolist())
        intersect = [j for j in [2, 3, 5, 6] if j in low]
        for targets, sources in _REVISION_CASES:
            if intersect == targets:
                kpts[targets] = kpts[sources]
                break
        h36m_kpts.append(kpts)

    return h36m_kpts, h36m_scores


def revise_skes_real_time(prediction: List[np.ndarray], re_kpts: np.ndarray,
                          width: int) -> np.ndarray:
    """Streaming variant: place each person from the current frame's anchors."""
    ratio = RATIO_2D_3D * (width / 1920)
    new_prediction = np.zeros((len(prediction), 17, 3), dtype=np.float32)
    for i in range(len(prediction)):
        new_prediction[i] = prediction[i]
        anchors = np.mean(re_kpts[i][_ANCHOR_JOINTS, :], axis=0)
        new_prediction[i, :, 0] -= (anchors[0] - 3 * width / 5) / ratio
        new_prediction[i, :, 1] += (anchors[1] - width / 5) / ratio

    new_prediction[:, :, 2] -= np.amin(new_prediction[:, :, 2])
    return new_prediction
