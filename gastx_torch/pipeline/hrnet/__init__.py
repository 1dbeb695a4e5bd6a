"""HRNet 2D pose for the in-the-wild pipeline (the port of
``gastx.pipeline.hrnet``). The JAX package's functional forward and its
folded-parameter import (``hrnet_forward``, ``import_hrnet_params``,
``fold_conv_bn``) are here the modules ``PoseHighResolutionNet`` and
``PoseResNet``, which load the reference's state dicts as they are."""
from gastx_torch.pipeline.hrnet.config import (
    CfgNode,
    default_config,
    hrnet_extra,
    update_config,
)
from gastx_torch.pipeline.hrnet.experiments import (
    EXPERIMENTS,
    experiment_config,
    experiment_names,
    resnet_extra,
)
from gastx_torch.pipeline.hrnet.model import PoseHighResolutionNet
from gastx_torch.pipeline.hrnet.pose_resnet import PoseResNet
from gastx_torch.pipeline.hrnet.transforms import (
    COCO_FLIP_PAIRS,
    box_to_center_scale,
    crop,
    flip_back,
    flip_tta_merge,
    get_affine_transform,
    normalize_crops,
    preprocess_boxes,
    transform_preds,
    warp_affine,
)
from gastx_torch.pipeline.hrnet.decode import get_final_preds, get_max_preds

__all__ = [
    "CfgNode",
    "default_config",
    "hrnet_extra",
    "update_config",
    "EXPERIMENTS",
    "experiment_config",
    "experiment_names",
    "resnet_extra",
    "PoseHighResolutionNet",
    "PoseResNet",
    "COCO_FLIP_PAIRS",
    "box_to_center_scale",
    "crop",
    "flip_back",
    "flip_tta_merge",
    "get_affine_transform",
    "normalize_crops",
    "preprocess_boxes",
    "transform_preds",
    "warp_affine",
    "get_final_preds",
    "get_max_preds",
]
