"""HRNet (PoseHighResolutionNet) as a PyTorch module, NCHW, inference-mode
(the port of ``gastx.pipeline.hrnet.model``).

Parity target: reference ``lib/pose/hrnet/lib/models/pose_hrnet.py`` — stem
(2x stride-2 convs) -> Bottleneck layer1 -> three multi-resolution stages of
``HighResolutionModule`` branches with up/downsample fuse layers -> final 1x1
conv to per-joint heatmaps (:274-461).

The module tree is the reference's, so its ``state_dict`` keys are the
published checkpoint's (``pose_hrnet_w48_384x288.pth`` loads with
``load_state_dict``) and the JAX package's ``import_hrnet_params`` reads a
state dict this module saved. BN runs with its running statistics (eval);
the convolutions are ``F.conv2d`` (cuDNN on the card, float32:
``device.check_f32_conv`` refuses TF32).
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from gastx_torch.device import check_f32_conv


def _conv_bn(c_in: int, c_out: int, kernel: int, stride: int = 1,
             relu: bool = True) -> nn.Sequential:
    """Conv (no bias), BN, and ReLU if ``relu``: keys ``.0`` and ``.1``."""
    layers = [nn.Conv2d(c_in, c_out, kernel, stride, (kernel - 1) // 2,
                        bias=False), nn.BatchNorm2d(c_out)]
    if relu:
        layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


def make_layer(block, inplanes: int, planes: int, blocks: int,
               stride: int = 1) -> nn.Sequential:
    """``blocks`` residual blocks, the first with a 1x1 conv + BN
    ``downsample`` where the stride or the width changes."""
    downsample = None
    if stride != 1 or inplanes != planes * block.expansion:
        downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * block.expansion, 1, stride,
                      bias=False),
            nn.BatchNorm2d(planes * block.expansion))
    layers = [block(inplanes, planes, stride, downsample)]
    layers += [block(planes * block.expansion, planes)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class HighResolutionModule(nn.Module):
    """Parallel branches of BASIC residual blocks (the only kind the
    shipped specs use), then the fuse: each output branch sums every branch
    brought to its resolution (1x1 conv + nearest upsample from coarser
    ones, stride-2 3x3 chains from finer ones)."""

    def __init__(self, num_branches: int, num_blocks: List[int],
                 num_inchannels: List[int], num_channels: List[int],
                 multi_scale_output: bool = True):
        super().__init__()
        self.num_branches = num_branches
        self.multi_scale_output = multi_scale_output
        self.num_inchannels = list(num_inchannels)
        self.branches = nn.ModuleList()
        for i in range(num_branches):
            self.branches.append(make_layer(BasicBlock,
                                            self.num_inchannels[i],
                                            num_channels[i], num_blocks[i]))
            self.num_inchannels[i] = num_channels[i]
        self.fuse_layers = self._make_fuse_layers()
        self.relu = nn.ReLU(inplace=True)

    def _make_fuse_layers(self):
        if self.num_branches == 1:
            return None
        ch = self.num_inchannels
        fuse = nn.ModuleList()
        for i in range(self.num_branches if self.multi_scale_output else 1):
            row = nn.ModuleList()
            for j in range(self.num_branches):
                if j > i:
                    row.append(nn.Sequential(
                        nn.Conv2d(ch[j], ch[i], 1, bias=False),
                        nn.BatchNorm2d(ch[i]),
                        nn.Upsample(scale_factor=2 ** (j - i),
                                    mode="nearest")))
                elif j == i:
                    row.append(None)
                else:  # strided 3x3 chain; ReLU on all but the last
                    row.append(nn.Sequential(*[
                        _conv_bn(ch[j], ch[i] if k == i - j - 1 else ch[j],
                                 3, 2, relu=k != i - j - 1)
                        for k in range(i - j)]))
            fuse.append(row)
        return fuse

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        x = [branch(xi) for branch, xi in zip(self.branches, x)]
        if self.num_branches == 1:
            return x
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = x[0] if i == 0 else row[0](x[0])
            for j in range(1, self.num_branches):
                y = y + (x[j] if i == j else row[j](x[j]))
            out.append(self.relu(y))
        return out


class PoseHighResolutionNet(nn.Module):
    """HRNet for 2D pose: (B, 3, H, W) normalized input -> (B, num_joints,
    H/4, W/4) heatmaps. ``extra`` is the MODEL.EXTRA stage spec
    (:func:`gastx_torch.pipeline.hrnet.hrnet_extra`)."""

    def __init__(self, extra: Dict, num_joints: int = 17):
        super().__init__()
        self.extra = extra
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = make_layer(Bottleneck, 64, 64, 4)

        pre = [256]
        for s, key in ((2, "STAGE2"), (3, "STAGE3"), (4, "STAGE4")):
            spec = extra[key]
            channels = list(spec["NUM_CHANNELS"])
            setattr(self, f"transition{s - 1}",
                    self._make_transition_layer(pre, channels))
            modules = []
            for m in range(spec["NUM_MODULES"]):
                multi = not (key == "STAGE4" and m == spec["NUM_MODULES"] - 1)
                module = HighResolutionModule(
                    spec["NUM_BRANCHES"], spec["NUM_BLOCKS"], channels,
                    spec["NUM_CHANNELS"], multi)
                channels = module.num_inchannels
                modules.append(module)
            setattr(self, f"stage{s}", nn.Sequential(*modules))
            pre = channels
        kernel = extra["FINAL_CONV_KERNEL"]
        self.final_layer = nn.Conv2d(pre[0], num_joints, kernel, 1,
                                     1 if kernel == 3 else 0)

    @staticmethod
    def _make_transition_layer(pre: List[int], cur: List[int]):
        layers = nn.ModuleList()
        for i, c in enumerate(cur):
            if i < len(pre):
                layers.append(_conv_bn(pre[i], c, 3) if c != pre[i]
                              else None)
            else:  # a new branch: stride-2 convs from the last one
                layers.append(nn.Sequential(*[
                    _conv_bn(pre[-1], c if j == i - len(pre) else pre[-1],
                             3, 2)
                    for j in range(i + 1 - len(pre))]))
        return layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_f32_conv(x.device)
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in (2, 3, 4):
            transition = getattr(self, f"transition{s - 1}")
            # A transition's conv takes the LAST previous map, as the
            # reference feeds it (pose_hrnet.py:437-455).
            xs = [xs[i] if t is None else t(xs[-1])
                  for i, t in enumerate(transition)]
            for module in getattr(self, f"stage{s}"):
                xs = module(xs)
        return self.final_layer(xs[0])
