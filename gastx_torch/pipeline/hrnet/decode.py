"""Heatmap -> keypoint decoding (the port's copy of
``gastx.pipeline.hrnet.decode``; host-side numpy).

Parity target: reference ``lib/pose/hrnet/lib/utils/inference.py:21-82`` —
per-joint argmax with quarter-pixel gradient offset (TEST.POST_PROCESS), then
inverse-affine back to image coordinates. Vectorized over (batch, joint)
instead of the reference's double python loop.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gastx_torch.pipeline.hrnet.transforms import transform_preds


def get_max_preds(batch_heatmaps: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, J, H, W) heatmaps -> ((B, J, 2) xy coords, (B, J, 1) maxvals)."""
    assert batch_heatmaps.ndim == 4
    b, j, h, w = batch_heatmaps.shape
    flat = batch_heatmaps.reshape(b, j, -1)
    idx = np.argmax(flat, axis=2)
    maxvals = np.amax(flat, axis=2)[..., None]

    preds = np.stack([idx % w, idx // w], axis=-1).astype(np.float32)
    preds *= (maxvals > 0.0)
    return preds, maxvals


def get_final_preds(batch_heatmaps: np.ndarray, centers: List,
                    scales: List, post_process: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode heatmaps and map back to original image coordinates."""
    coords, maxvals = get_max_preds(batch_heatmaps)
    b, j, h, w = batch_heatmaps.shape

    if post_process:
        px = np.floor(coords[..., 0] + 0.5).astype(int)
        py = np.floor(coords[..., 1] + 0.5).astype(int)
        inside = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
        pxc = np.clip(px, 1, w - 2)
        pyc = np.clip(py, 1, h - 2)
        bi, ji = np.meshgrid(np.arange(b), np.arange(j), indexing="ij")
        dx = (batch_heatmaps[bi, ji, pyc, pxc + 1]
              - batch_heatmaps[bi, ji, pyc, pxc - 1])
        dy = (batch_heatmaps[bi, ji, pyc + 1, pxc]
              - batch_heatmaps[bi, ji, pyc - 1, pxc])
        offset = np.stack([np.sign(dx), np.sign(dy)], axis=-1) * 0.25
        coords = coords + offset * inside[..., None]

    preds = coords.copy()
    for i in range(b):
        preds[i] = transform_preds(coords[i], centers[i], scales[i], [w, h])
    return preds, maxvals
