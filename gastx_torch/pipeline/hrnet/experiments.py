"""Shipped 2D-pose experiment presets (the port's copy of
``gastx.pipeline.hrnet.experiments``).

Parity surface: the 15 experiment yamls under the reference's
``lib/pose/hrnet/experiments/{coco,mpii}/{hrnet,resnet}/`` (e.g.
``experiments/coco/hrnet/w48_384x288_adam_lr1e-3.yaml``). Rather than
vendoring yaml text, each preset is generated from its axes — backbone
family/depth, dataset, input resolution — and merged over
:func:`gastx_torch.pipeline.hrnet.config.default_config`, which reproduces the
reference's ``update_config`` result for that yaml
(lib/pose/hrnet/lib/config/default.py:126-153).

``experiment_config(name)`` accepts the canonical yaml stem, e.g.
``"coco/hrnet/w32_256x192_adam_lr1e-3"`` (with or without the ``.yaml``
suffix).
"""
from __future__ import annotations

from typing import Dict, List

from gastx_torch.pipeline.hrnet.config import CfgNode, default_config, hrnet_extra

# The explicit PRETRAINED_LAYERS list the hrnet yamls use (the default tree
# uses '*'; both select everything for the shipped specs).
_HRNET_PRETRAINED_LAYERS = [
    "conv1", "bn1", "conv2", "bn2", "layer1", "transition1", "stage2",
    "transition2", "stage3", "transition3", "stage4",
]

_RESNET_PRETRAINED = {
    50: "models/pytorch/imagenet/resnet50-19c8e357.pth",
    101: "models/pytorch/imagenet/resnet101-5d3b4d8f.pth",
    152: "models/pytorch/imagenet/resnet152-b121ed2d.pth",
}
_HRNET_PRETRAINED = {
    32: "models/pytorch/imagenet/hrnet_w32-36af842e.pth",
    48: "models/pytorch/imagenet/hrnet_w48-8ef0771d.pth",
}

_COCO_BBOX_FILE = ("data/coco/person_detection_results/"
                   "COCO_val2017_detections_AP_H_56_person.json")


def resnet_extra(num_layers: int = 50) -> Dict:
    """POSE_RESNET spec (reference config/models.py:15-22)."""
    return {
        "NUM_LAYERS": num_layers,
        "DECONV_WITH_BIAS": False,
        "NUM_DECONV_LAYERS": 3,
        "NUM_DECONV_FILTERS": [256, 256, 256],
        "NUM_DECONV_KERNELS": [4, 4, 4],
        "FINAL_CONV_KERNEL": 1,
        "PRETRAINED_LAYERS": ["*"],
    }


def _dataset_block(dataset: str, color_rgb: bool) -> Dict:
    if dataset == "coco":
        d = {"DATASET": "coco", "ROOT": "data/coco/",
             "TEST_SET": "val2017", "TRAIN_SET": "train2017"}
    else:
        d = {"DATASET": "mpii", "ROOT": "data/mpii/",
             "TEST_SET": "valid", "TRAIN_SET": "train"}
    d.update({"DATA_FORMAT": "jpg", "FLIP": True, "COLOR_RGB": color_rgb})
    return d


def _common(preset: Dict) -> Dict:
    preset.update({
        "AUTO_RESUME": True,
        "GPUS": (0, 1, 2, 3),
        "OUTPUT_DIR": "output",
        "LOG_DIR": "log",
        "WORKERS": 24,
        "PRINT_FREQ": 100,
        "DEBUG": {"DEBUG": True, "SAVE_BATCH_IMAGES_GT": True,
                  "SAVE_BATCH_IMAGES_PRED": True, "SAVE_HEATMAPS_GT": True,
                  "SAVE_HEATMAPS_PRED": True},
    })
    return preset


def _hrnet_preset(dataset: str, width: int, image_size: List[int]) -> Dict:
    """HRNet experiment axes: coco uses 45deg/0.35/half-body augmentation
    and 17 joints; mpii uses 30deg/0.25, 16 joints, 256x256."""
    coco = dataset == "coco"
    heatmap = [s // 4 for s in image_size]
    extra = hrnet_extra(width)
    extra["PRETRAINED_LAYERS"] = list(_HRNET_PRETRAINED_LAYERS)
    # w48 at 384x288 drops the per-GPU batch to 24 (memory headroom in the
    # reference recipe); every other variant trains/tests at 32.
    batch = 24 if (width == 48 and image_size == [288, 384]) else 32
    test = {"BATCH_SIZE_PER_GPU": batch, "MODEL_FILE": "", "FLIP_TEST": True,
            "POST_PROCESS": True, "SHIFT_HEATMAP": True}
    if coco:
        test.update({"COCO_BBOX_FILE": _COCO_BBOX_FILE, "BBOX_THRE": 1.0,
                     "IMAGE_THRE": 0.0, "IN_VIS_THRE": 0.2, "NMS_THRE": 1.0,
                     "OKS_THRE": 0.9, "USE_GT_BBOX": True})
    return _common({
        "DATASET": dict(_dataset_block(dataset, color_rgb=True),
                        NUM_JOINTS_HALF_BODY=8,
                        PROB_HALF_BODY=0.3 if coco else -1.0,
                        ROT_FACTOR=45 if coco else 30,
                        SCALE_FACTOR=0.35 if coco else 0.25),
        "MODEL": {
            "INIT_WEIGHTS": True,
            "NAME": "pose_hrnet",
            "NUM_JOINTS": 17 if coco else 16,
            "PRETRAINED": _HRNET_PRETRAINED[width],
            "TARGET_TYPE": "gaussian",
            "IMAGE_SIZE": list(image_size),
            "HEATMAP_SIZE": heatmap,
            "SIGMA": 3 if image_size == [288, 384] else 2,
            "EXTRA": extra,
        },
        "LOSS": {"USE_TARGET_WEIGHT": True},
        "TRAIN": {"BATCH_SIZE_PER_GPU": batch, "SHUFFLE": True,
                  "BEGIN_EPOCH": 0, "END_EPOCH": 210, "OPTIMIZER": "adam",
                  "LR": 0.001, "LR_FACTOR": 0.1, "LR_STEP": [170, 200],
                  "WD": 0.0001, "GAMMA1": 0.99, "GAMMA2": 0.0,
                  "MOMENTUM": 0.9, "NESTEROV": False},
        "TEST": test,
    })


def _resnet_preset(dataset: str, num_layers: int,
                   image_size: List[int]) -> Dict:
    """SimpleBaseline (pose_resnet) experiment axes. The reference's mpii
    resnet yamls keep the COCO test thresholds/bbox file (an upstream
    copy-paste); preserved for config fidelity."""
    coco = dataset == "coco"
    heatmap = [s // 4 for s in image_size]
    return _common({
        "DATASET": dict(_dataset_block(dataset, color_rgb=False),
                        **({"ROT_FACTOR": 40, "SCALE_FACTOR": 0.3} if coco
                           else {"NUM_JOINTS_HALF_BODY": 8,
                                 "PROB_HALF_BODY": -1.0,
                                 "ROT_FACTOR": 30, "SCALE_FACTOR": 0.25})),
        "MODEL": {
            "NAME": "pose_resnet",
            "PRETRAINED": _RESNET_PRETRAINED[num_layers],
            "IMAGE_SIZE": list(image_size),
            "HEATMAP_SIZE": heatmap,
            "SIGMA": 3 if image_size == [288, 384] else 2,
            "NUM_JOINTS": 17 if coco else 16,
            "TARGET_TYPE": "gaussian",
            "EXTRA": resnet_extra(num_layers),
        },
        "LOSS": {"USE_TARGET_WEIGHT": True},
        "TRAIN": {"BATCH_SIZE_PER_GPU": 32, "SHUFFLE": True,
                  "BEGIN_EPOCH": 0, "END_EPOCH": 140, "OPTIMIZER": "adam",
                  "LR": 0.001, "LR_FACTOR": 0.1, "LR_STEP": [90, 120],
                  "WD": 0.0001, "GAMMA1": 0.99, "GAMMA2": 0.0,
                  "MOMENTUM": 0.9, "NESTEROV": False},
        "TEST": {"BATCH_SIZE_PER_GPU": 32, "COCO_BBOX_FILE": _COCO_BBOX_FILE,
                 "BBOX_THRE": 1.0, "IMAGE_THRE": 0.0, "IN_VIS_THRE": 0.2,
                 "MODEL_FILE": "", "NMS_THRE": 1.0, "OKS_THRE": 0.9,
                 "FLIP_TEST": True, "POST_PROCESS": True,
                 "SHIFT_HEATMAP": True, "USE_GT_BBOX": True},
    })


def _build_registry() -> Dict[str, Dict]:
    reg: Dict[str, Dict] = {}
    for width in (32, 48):
        for size in ([192, 256], [288, 384]):
            name = (f"coco/hrnet/w{width}_{size[1]}x{size[0]}"
                    f"_adam_lr1e-3")
            reg[name] = _hrnet_preset("coco", width, size)
        reg[f"mpii/hrnet/w{width}_256x256_adam_lr1e-3"] = _hrnet_preset(
            "mpii", width, [256, 256])
    for layers in (50, 101, 152):
        for size in ([192, 256], [288, 384]):
            name = (f"coco/resnet/res{layers}_{size[1]}x{size[0]}"
                    f"_d256x3_adam_lr1e-3")
            reg[name] = _resnet_preset("coco", layers, size)
        reg[f"mpii/resnet/res{layers}_256x256_d256x3_adam_lr1e-3"] = \
            _resnet_preset("mpii", layers, [256, 256])
    return reg


EXPERIMENTS: Dict[str, Dict] = _build_registry()


def experiment_names():
    return sorted(EXPERIMENTS)


def experiment_config(name: str, opts=None) -> CfgNode:
    """Build the full config for a shipped experiment preset.

    ``name``: canonical yaml stem, e.g. ``coco/hrnet/w48_384x288_adam_lr1e-3``
    (a trailing ``.yaml`` and leading ``experiments/`` are tolerated).
    Equivalent to the reference's ``update_config(cfg, <yaml>)``.
    """
    key = name.removesuffix(".yaml")
    key = key.removeprefix("experiments/")
    if key not in EXPERIMENTS:
        raise KeyError(
            f"unknown experiment {name!r}; shipped: {experiment_names()}")
    cfg = default_config()
    cfg.merge_from_dict(EXPERIMENTS[key])
    if opts:
        cfg.merge_from_list(opts)
    return cfg
