from gastx_torch.data.converters import coco_h36m
from gastx_torch.data.keypoints_json import (load_keypoints_json,
                                             save_keypoints_json)

__all__ = ["coco_h36m", "load_keypoints_json", "save_keypoints_json"]
