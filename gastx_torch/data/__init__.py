from gastx_torch.data.converters import (coco_h36m, coco_h36m_toe_format,
                                         mpii_h36m, openpose_to_coco)
from gastx_torch.data.generators import ChunkedBatcher, UnchunkedBatcher
from gastx_torch.data.keypoints_json import (load_keypoints_json,
                                             save_keypoints_json)

__all__ = ["ChunkedBatcher", "UnchunkedBatcher", "coco_h36m",
           "coco_h36m_toe_format", "load_keypoints_json", "mpii_h36m",
           "openpose_to_coco", "save_keypoints_json"]
