"""HRNet experiment configuration (the port's copy of
``gastx.pipeline.hrnet.config``).

Parity target: the yacs CfgNode tree of reference
``lib/pose/hrnet/lib/config/default.py:17-153`` and the per-model EXTRA stage
specs (``config/models.py:15-58``), rebuilt on a dependency-free ``CfgNode``
(yacs is not in this image). Supports the reference's experiment yamls
(e.g. w48_384x288_adam_lr1e-3.yaml) via :func:`update_config`.
"""
from __future__ import annotations

import copy
from typing import Any, Dict


class CfgNode(dict):
    """Minimal yacs-compatible config node: attribute access + yaml merge."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def defrost(self) -> None:  # yacs API compatibility
        pass

    def freeze(self) -> None:
        pass

    def merge_from_dict(self, other: Dict) -> None:
        for key, value in other.items():
            if isinstance(value, dict) and isinstance(self.get(key), CfgNode):
                self[key].merge_from_dict(value)
            elif isinstance(value, dict):
                self[key] = _to_cfg(value)
            else:
                self[key] = value

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path) as f:
            self.merge_from_dict(yaml.safe_load(f))

    def merge_from_list(self, opts) -> None:
        assert len(opts) % 2 == 0
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                # yacs raises on non-existent keys; silently creating one
                # would make a typo'd override a no-op on the real entry.
                raise KeyError(f"Non-existent config key: {key}")
            node[parts[-1]] = _coerce_value(value, node[parts[-1]])


def _coerce_value(value, old):
    """yacs-style CLI value decoding (lib/config/default.py semantics via
    yacs _decode_cfg_value/_check_and_coerce_cfg_value_type): string
    overrides are literal_eval'd and must match the existing entry's type
    (int->float and list<->tuple casts allowed)."""
    if not isinstance(value, str) or old is None or isinstance(old, str):
        return value
    import ast
    try:
        decoded = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        low = value.lower()
        if low in ("true", "false"):
            decoded = (low == "true")
        else:
            raise ValueError(
                f"cannot decode override {value!r} for a "
                f"{type(old).__name__} config entry")
    # Exact type match (not isinstance: bool must not leak into int
    # entries — yacs raises there too).
    if type(decoded) is type(old):
        return decoded
    if isinstance(old, float) and type(decoded) is int:
        return float(decoded)
    if isinstance(old, tuple) and isinstance(decoded, list):
        return tuple(decoded)
    if isinstance(old, list) and isinstance(decoded, tuple):
        return list(decoded)
    raise ValueError(
        f"type mismatch for override {value!r}: got "
        f"{type(decoded).__name__}, config entry is {type(old).__name__}")


def _to_cfg(d: Dict) -> CfgNode:
    node = CfgNode()
    for key, value in d.items():
        node[key] = _to_cfg(value) if isinstance(value, dict) else value
    return node


def _stage(num_modules, num_branches, num_blocks, num_channels) -> Dict:
    return {
        "NUM_MODULES": num_modules,
        "NUM_BRANCHES": num_branches,
        "NUM_BLOCKS": list(num_blocks),
        "NUM_CHANNELS": list(num_channels),
        "BLOCK": "BASIC",
        "FUSE_METHOD": "SUM",
    }


def hrnet_extra(width: int = 48) -> Dict:
    """Stage spec for HRNet-W<width> (config/models.py:25-53)."""
    c = width
    return {
        "PRETRAINED_LAYERS": ["*"],
        "STEM_INPLANES": 64,
        "FINAL_CONV_KERNEL": 1,
        "STAGE2": _stage(1, 2, [4, 4], [c, 2 * c]),
        "STAGE3": _stage(4, 3, [4, 4, 4], [c, 2 * c, 4 * c]),
        "STAGE4": _stage(3, 4, [4, 4, 4, 4], [c, 2 * c, 4 * c, 8 * c]),
    }


def default_config() -> CfgNode:
    """The default experiment tree (default.py:17-123), HRNet-W48 384x288."""
    return _to_cfg({
        "OUTPUT_DIR": "",
        "LOG_DIR": "",
        "DATA_DIR": "",
        "GPUS": (0,),
        "WORKERS": 1,
        "PRINT_FREQ": 100,
        "AUTO_RESUME": False,
        "PIN_MEMORY": True,
        "RANK": 0,
        "CUDNN": {"BENCHMARK": True, "DETERMINISTIC": False,
                  "ENABLED": True},
        "MODEL": {
            "NAME": "pose_hrnet",
            "INIT_WEIGHTS": True,
            "PRETRAINED": "",
            "NUM_JOINTS": 17,
            "TAG_PER_JOINT": True,
            "TARGET_TYPE": "gaussian",
            "IMAGE_SIZE": [288, 384],
            "HEATMAP_SIZE": [72, 96],
            "SIGMA": 3,
            "EXTRA": hrnet_extra(48),
        },
        "LOSS": {"USE_OHKM": False, "TOPK": 8, "USE_TARGET_WEIGHT": True,
                 "USE_DIFFERENT_JOINTS_WEIGHT": False},
        "DATASET": {"ROOT": "", "DATASET": "coco", "TRAIN_SET": "train2017",
                    "TEST_SET": "val2017", "DATA_FORMAT": "jpg",
                    "HYBRID_JOINTS_TYPE": "", "SELECT_DATA": False,
                    "FLIP": True, "SCALE_FACTOR": 0.25, "ROT_FACTOR": 30,
                    "PROB_HALF_BODY": 0.0, "NUM_JOINTS_HALF_BODY": 8,
                    "COLOR_RGB": False},
        "TRAIN": {"LR_FACTOR": 0.1, "LR_STEP": [90, 110], "LR": 0.001,
                  "OPTIMIZER": "adam", "MOMENTUM": 0.9, "WD": 0.0001,
                  "NESTEROV": False, "GAMMA1": 0.99, "GAMMA2": 0.0,
                  "BEGIN_EPOCH": 0, "END_EPOCH": 140, "RESUME": False,
                  "CHECKPOINT": "", "BATCH_SIZE_PER_GPU": 32,
                  "SHUFFLE": True},
        "TEST": {"BATCH_SIZE_PER_GPU": 32, "COCO_BBOX_FILE": "",
                 "BBOX_THRE": 1.0, "IMAGE_THRE": 0.0, "IN_VIS_THRE": 0.2,
                 "MODEL_FILE": "", "NMS_THRE": 1.0, "OKS_THRE": 0.9,
                 "USE_GT_BBOX": False, "FLIP_TEST": False,
                 "POST_PROCESS": True, "SHIFT_HEATMAP": False},
        "DEBUG": {"DEBUG": False, "SAVE_BATCH_IMAGES_GT": False,
                  "SAVE_BATCH_IMAGES_PRED": False, "SAVE_HEATMAPS_GT": False,
                  "SAVE_HEATMAPS_PRED": False},
    })


def update_config(cfg: CfgNode, yaml_file: str, opts=None) -> CfgNode:
    """Merge an experiment yaml (+ CLI opts) into the default tree
    (default.py:126-153)."""
    cfg.merge_from_file(yaml_file)
    if opts:
        cfg.merge_from_list(opts)
    return cfg
