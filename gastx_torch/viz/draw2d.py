"""2D keypoint drawing + frame resize helpers (host-side, cv2 imported
inside each function): the port's copy of ``gastx.viz.draw2d``.

Parity targets: reference ``tools/utils.py:60-95`` (resize_img, draw_2Dimg)
and ``tools/vis_kpts.py`` (plot_keypoint) — with vis_kpts' x/y
coordinate-pairing bug fixed (SURVEY.md §2.5: tools/vis_kpts.py:40 paired
x of one joint with y of another).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# H36M-17 bone list (tools/utils.py:10-12).
JOINT_PAIRS = [(0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7),
               (7, 8), (8, 9), (9, 10), (8, 11), (11, 12), (12, 13),
               (8, 14), (14, 15), (15, 16)]

BONE_COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
               [170, 255, 0], [85, 255, 0], [0, 255, 0], [50, 205, 50],
               [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
               [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255]]


def resize_img(frame: np.ndarray, max_length: int = 640
               ) -> Tuple[np.ndarray, int, int]:
    """Downscale so the long edge is at most ``max_length``."""
    import cv2

    h, w = frame.shape[:2]
    if max(w, h) > max_length:
        if w > h:
            w_new, h_new = max_length, int(h * max_length / w)
        else:
            w_new, h_new = int(w * max_length / h), max_length
        frame = cv2.resize(frame, (w_new, h_new),
                           interpolation=cv2.INTER_AREA)
        return frame, w_new, h_new
    return frame, w, h


def draw_keypoints(img: np.ndarray, kpts: np.ndarray,
                   scores: Optional[np.ndarray] = None,
                   threshold: float = 0.3, display: bool = False
                   ) -> np.ndarray:
    """Draw (M, 17, 2) keypoints + bones onto a copy of ``img``."""
    import cv2

    im = img.copy()
    if kpts.ndim == 2:
        kpts = kpts[None]
    if scores is not None and scores.ndim == 1:
        scores = scores[None]

    for m, person in enumerate(kpts):
        for j, (x, y) in enumerate(person):
            if scores is None or scores[m, j] > threshold:
                cv2.circle(im, (int(x), int(y)), 4, (255, 255, 255), 1)
        for (j, parent), color in zip(JOINT_PAIRS, BONE_COLORS):
            pt1 = (int(person[j, 0]), int(person[j, 1]))
            pt2 = (int(person[parent, 0]), int(person[parent, 1]))
            cv2.line(im, pt1, pt2, color, 2)

    if display:
        cv2.imshow("frame", im)
        cv2.waitKey(1)
    return im


def draw_bboxes(img: np.ndarray, boxes, labels=None,
                color: Tuple[int, int, int] = (0, 140, 255)) -> np.ndarray:
    """Draw detection boxes + label tags onto a copy of ``img``.

    Parity surface: the reference's detector box renderer
    (lib/detector/yolov3/bbox.py:98-110) — rectangle, filled label
    background sized by cv2.getTextSize, white label text. The reference
    picks a random color per box; here the color is a deterministic
    argument so demo output is reproducible.

    ``boxes``: iterable of (x1, y1, x2, y2); ``labels``: optional list of
    strings (defaults to "person", the only class the pipeline keeps).
    """
    import cv2

    im = img.copy()
    for i, box in enumerate(boxes):
        x1, y1, x2, y2 = (int(v) for v in box[:4])
        label = labels[i] if labels is not None else "person"
        cv2.rectangle(im, (x1, y1), (x2, y2), color, 1)
        t_size = cv2.getTextSize(label, cv2.FONT_HERSHEY_PLAIN, 1, 1)[0]
        c2 = (x1 + t_size[0] + 3, y1 + t_size[1] + 4)
        cv2.rectangle(im, (x1, y1), c2, color, -1)
        cv2.putText(im, label, (x1, y1 + t_size[1] + 4),
                    cv2.FONT_HERSHEY_PLAIN, 1, (225, 255, 255), 1)
    return im
