"""YOLOv3 person detection (the port of ``gastx.pipeline.yolo``)."""
from gastx_torch.pipeline.yolo.cfg import parse_darknet_cfg, yolov3_blocks
from gastx_torch.pipeline.yolo.model import (
    Darknet,
    load_darknet_weights,
)
from gastx_torch.pipeline.yolo.detect import (
    YoloHumanDetector,
    letterbox_image,
    prep_frame,
    greedy_nms,
    filter_person_detections,
    rescale_boxes,
)

__all__ = [
    "parse_darknet_cfg",
    "yolov3_blocks",
    "Darknet",
    "load_darknet_weights",
    "YoloHumanDetector",
    "letterbox_image",
    "prep_frame",
    "greedy_nms",
    "filter_person_detections",
    "rescale_boxes",
]
