"""Darknet network descriptions: cfg-file parser + built-in YOLOv3 spec (the
port's copy of ``gastx.pipeline.yolo.cfg``).

Parity target: the cfg parser of reference ``lib/detector/yolov3/darknet.py:38``
(block dicts from the ini-like darknet format). In addition,
:func:`yolov3_blocks` generates the standard 106-layer YOLOv3 (COCO)
architecture programmatically, so the framework is self-contained: users only
need the public ``yolov3.weights`` binary, no cfg download. The generated
block list is asserted equivalent to a parsed upstream ``yolov3.cfg`` in
tests.
"""
from __future__ import annotations

from typing import Dict, List

_ANCHORS = "10,13,  16,30,  33,23,  30,61,  62,45,  59,119,  116,90,  156,198,  373,326"


def parse_darknet_cfg(path: str) -> List[Dict[str, str]]:
    """Parse a darknet .cfg into a list of block dicts (first = [net])."""
    blocks: List[Dict[str, str]] = []
    block: Dict[str, str] = {}
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("["):
                if block:
                    blocks.append(block)
                block = {"type": line[1:-1].strip()}
            else:
                key, value = line.split("=", 1)
                block[key.strip()] = value.strip()
    if block:
        blocks.append(block)
    return blocks


def _conv(filters: int, size: int, stride: int = 1,
          bn: bool = True, activation: str = "leaky") -> Dict[str, str]:
    block = {"type": "convolutional", "filters": str(filters),
             "size": str(size), "stride": str(stride), "pad": "1",
             "activation": activation}
    if bn:
        block["batch_normalize"] = "1"
    return block


def _shortcut() -> Dict[str, str]:
    return {"type": "shortcut", "from": "-3", "activation": "linear"}


def _route(layers) -> Dict[str, str]:
    return {"type": "route",
            "layers": ", ".join(str(l) for l in layers)}


def _yolo(mask) -> Dict[str, str]:
    return {"type": "yolo", "mask": ",".join(str(m) for m in mask),
            "anchors": _ANCHORS, "classes": "80", "num": "9",
            "jitter": ".3", "ignore_thresh": ".5", "truth_thresh": "1",
            "random": "1"}


def yolov3_blocks(width: int = 416, height: int = 416) -> List[Dict[str, str]]:
    """The standard YOLOv3 (COCO, 80-class) architecture, generated.

    Darknet-53 backbone: stem conv, then 5 downsampling stages with
    (1, 2, 8, 8, 4) residual units; detection head: 3 scales with
    conv-set + route/upsample feature fusion.
    """
    blocks: List[Dict[str, str]] = [{
        "type": "net", "batch": "1", "subdivisions": "1",
        "width": str(width), "height": str(height), "channels": "3",
        "momentum": "0.9", "decay": "0.0005",
    }]

    blocks.append(_conv(32, 3))
    # (residual_units, channels) per downsampling stage
    for n_res, ch in [(1, 64), (2, 128), (8, 256), (8, 512), (4, 1024)]:
        blocks.append(_conv(ch, 3, stride=2))
        for _ in range(n_res):
            blocks.append(_conv(ch // 2, 1))
            blocks.append(_conv(ch, 3))
            blocks.append(_shortcut())

    def conv_set(ch: int):
        out = []
        for _ in range(2):
            out.append(_conv(ch, 1))
            out.append(_conv(ch * 2, 3))
        out.append(_conv(ch, 1))
        return out

    # Scale 1 (13x13, large objects)
    blocks += conv_set(512)
    blocks.append(_conv(1024, 3))
    blocks.append(_conv(255, 1, bn=False, activation="linear"))
    blocks.append(_yolo([6, 7, 8]))

    # Scale 2 (26x26)
    blocks.append(_route([-4]))
    blocks.append(_conv(256, 1))
    blocks.append({"type": "upsample", "stride": "2"})
    blocks.append(_route([-1, 61]))
    blocks += conv_set(256)
    blocks.append(_conv(512, 3))
    blocks.append(_conv(255, 1, bn=False, activation="linear"))
    blocks.append(_yolo([3, 4, 5]))

    # Scale 3 (52x52, small objects)
    blocks.append(_route([-4]))
    blocks.append(_conv(128, 1))
    blocks.append({"type": "upsample", "stride": "2"})
    blocks.append(_route([-1, 36]))
    blocks += conv_set(128)
    blocks.append(_conv(256, 3))
    blocks.append(_conv(255, 1, bn=False, activation="linear"))
    blocks.append(_yolo([0, 1, 2]))

    return blocks
