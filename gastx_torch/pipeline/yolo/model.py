"""YOLOv3 as a PyTorch module in NCHW (the port of
``gastx.pipeline.yolo.model``).

Parity targets: reference ``lib/detector/yolov3/darknet.py`` — module builder
(:138-263), forward with route/shortcut caching and 3-scale detection concat
(:280-346), and the sequential binary ``.weights`` loader (:348-433) — plus
the box decode ``predict_transform`` (lib/detector/yolov3/util.py:34-81).

As in the JAX package, BN is folded into a per-channel scale and shift at
load time (inference only): a convolution computes ``conv(x, w) * scale +
shift``. The convolutions are ``F.conv2d`` (cuDNN on the card, in float32:
``device.check_f32_conv`` refuses TF32).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gastx_torch.device import check_f32_conv


def load_darknet_weights(path: str, blocks: List[Dict]
                         ) -> List[Dict[str, torch.Tensor]]:
    """Read the darknet binary: 5 int32 header, then per conv layer either
    (bn_bias, bn_scale, bn_mean, bn_var, conv_w) or (conv_bias, conv_w),
    conv_w stored as (out, in, k, k) fp32.

    Returns per-layer dicts aligned with blocks[1:] (non-conv layers get
    empty dicts) of CPU tensors: ``w`` (out, in, k, k), ``scale`` and
    ``shift``, BN folded: y = conv(x) * scale + shift.
    """
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=5)
        if header.shape[0] != 5:
            raise ValueError(f"{path}: truncated darknet weights header")
        weights = np.fromfile(f, dtype=np.float32)

    params: List[Dict[str, torch.Tensor]] = [{} for _ in blocks[1:]]
    ptr = 0
    in_channels = int(blocks[0].get("channels", 3))
    channels_per_layer = _infer_channels(blocks, in_channels)

    for i, block in enumerate(blocks[1:]):
        if block["type"] != "convolutional":
            continue
        filters = int(block["filters"])
        size = int(block["size"])
        c_in = channels_per_layer[i]
        has_bn = int(block.get("batch_normalize", 0)) == 1

        if has_bn:
            bn_bias = weights[ptr:ptr + filters]; ptr += filters
            bn_scale = weights[ptr:ptr + filters]; ptr += filters
            bn_mean = weights[ptr:ptr + filters]; ptr += filters
            bn_var = weights[ptr:ptr + filters]; ptr += filters
            inv = bn_scale / np.sqrt(bn_var + 1e-5)
            scale, shift = inv, bn_bias - bn_mean * inv
        else:
            conv_bias = weights[ptr:ptr + filters]; ptr += filters
            scale = np.ones(filters, np.float32)
            shift = conv_bias

        n_w = filters * c_in * size * size
        w = weights[ptr:ptr + n_w].reshape(filters, c_in, size, size)
        ptr += n_w
        params[i] = {"w": torch.from_numpy(np.array(w)),
                     "scale": torch.from_numpy(np.array(scale)),
                     "shift": torch.from_numpy(np.array(shift))}

    if ptr != len(weights):
        raise ValueError(f"{path}: weights file mismatch: consumed {ptr} of "
                         f"{len(weights)} floats")
    return params


def _infer_channels(blocks: List[Dict], in_channels: int) -> List[int]:
    """Input channel count for every layer (route concat handling)."""
    out_ch: List[int] = []
    in_ch: List[int] = []
    for i, block in enumerate(blocks[1:]):
        in_ch.append(in_channels)
        t = block["type"]
        if t == "convolutional":
            in_channels = int(block["filters"])
        elif t == "route":
            layers = [int(x) for x in block["layers"].split(",")]
            layers = [l if l < 0 else l - i for l in layers]
            in_channels = sum(out_ch[i + l] for l in layers)
        out_ch.append(in_channels)
    return in_ch


def _decode_scale(x: torch.Tensor, inp_dim: int, anchors: np.ndarray
                  ) -> torch.Tensor:
    """predict_transform: (B, A*85, G, G) NCHW feature map -> (B, G*G*A, 85)
    boxes in input-pixel scale (util.py:34-81)."""
    b, g = x.shape[0], x.shape[2]
    stride = inp_dim // g
    a = anchors.shape[0]
    x = x.permute(0, 2, 3, 1).reshape(b, g * g, a, -1)

    grid = np.arange(g, dtype=np.float32)
    gx, gy = np.meshgrid(grid, grid)
    offsets = torch.from_numpy(np.stack(
        [gx.reshape(-1), gy.reshape(-1)], axis=1)[None, :, None, :]
    ).to(x.device)                                       # (1, G*G, 1, 2)
    anchors_s = torch.from_numpy(
        (anchors / stride)[None, None, :, :]).to(x.device)

    xy = (torch.sigmoid(x[..., :2]) + offsets) * stride
    wh = torch.exp(x[..., 2:4]) * anchors_s * stride
    obj = torch.sigmoid(x[..., 4:5])
    cls = torch.sigmoid(x[..., 5:])
    return torch.cat([xy, wh, obj, cls], dim=-1).reshape(b, g * g * a, -1)


class Darknet(nn.Module):
    """YOLOv3 from darknet blocks: ``forward(x)`` takes (B, 3, inp, inp)
    RGB in [0, 1] and returns (B, N, 85) decoded boxes (x, y, w, h,
    objectness, 80 class scores) in input pixels.

    The weights of conv layer ``i`` of ``blocks[1:]`` are the buffers
    ``w{i}``, ``scale{i}`` and ``shift{i}``; ``params`` is
    :func:`load_darknet_weights`'s list. The module is the JAX package's
    ``make_yolo_forward`` with the weights bound in.
    """

    def __init__(self, blocks: List[Dict], params: List[Dict[str, torch.Tensor]],
                 inp_dim: int = 416):
        super().__init__()
        self.blocks = blocks
        self.inp_dim = inp_dim
        self.anchors = None
        for blk in blocks[1:]:
            if blk["type"] == "yolo":
                vals = [int(v) for v in blk["anchors"].split(",")]
                self.anchors = np.array(vals, np.float32).reshape(-1, 2)
                break
        for i, p in enumerate(params):
            for key, value in p.items():
                self.register_buffer(f"{key}{i}", value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_f32_conv(x.device)
        outputs: Dict[int, torch.Tensor] = {}
        detections = []
        for i, blk in enumerate(self.blocks[1:]):
            t = blk["type"]
            if t == "convolutional":
                size = int(blk["size"])
                pad = (size - 1) // 2 if int(blk.get("pad", 0)) else 0
                x = F.conv2d(x, getattr(self, f"w{i}"),
                             stride=int(blk["stride"]), padding=pad)
                x = (x * getattr(self, f"scale{i}")[:, None, None]
                     + getattr(self, f"shift{i}")[:, None, None])
                if blk.get("activation") == "leaky":
                    x = F.leaky_relu(x, 0.1)
            elif t == "upsample":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif t == "maxpool":
                size = int(blk["size"])
                stride = int(blk["stride"])
                if stride == 1:
                    # darknet MaxPoolStride1: replicate-pad right/bottom by
                    # size-1 then VALID pool (darknet.py:70-78)
                    x = F.pad(x, (0, size - 1, 0, size - 1), mode="replicate")
                x = F.max_pool2d(x, size, stride)
            elif t == "route":
                layers = [int(v) for v in blk["layers"].split(",")]
                layers = [l if l < 0 else l - i for l in layers]
                maps = [outputs[i + l] for l in layers]
                x = maps[0] if len(maps) == 1 else torch.cat(maps, dim=1)
            elif t == "shortcut":
                x = outputs[i - 1] + outputs[i + int(blk["from"])]
            elif t == "yolo":
                mask = [int(v) for v in blk["mask"].split(",")]
                detections.append(_decode_scale(
                    outputs[i - 1], self.inp_dim, self.anchors[mask]))
                x = outputs[i - 1]
            outputs[i] = x
        return torch.cat(detections, dim=1)

