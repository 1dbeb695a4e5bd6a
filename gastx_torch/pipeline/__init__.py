"""The in-the-wild video pipeline (the port of ``gastx.pipeline``): YOLOv3
detection, SORT tracking and HRNet 2D pose on the device, keypoint
revision on the host."""
from gastx_torch.pipeline.sort import Sort, KalmanBoxTracker, iou_matrix
from gastx_torch.pipeline.keypoint_revision import (
    h36m_coco_format,
    revise_kpts,
    revise_skes,
    revise_skes_real_time,
)

__all__ = [
    "Sort",
    "KalmanBoxTracker",
    "iou_matrix",
    "h36m_coco_format",
    "revise_kpts",
    "revise_skes",
    "revise_skes_real_time",
]
