"""PoseResNet (SimpleBaseline) as a PyTorch module, NCHW, inference-mode
(the port of ``gastx.pipeline.hrnet.pose_resnet``).

Parity target: reference ``lib/pose/hrnet/lib/models/pose_resnet.py`` — the
alternative registered 2D-pose backbone (ResNet stem/stages + 3 stride-2
deconv layers + final conv to heatmaps, :103-271). The module tree is the
reference's, so its ``state_dict`` keys are the published checkpoints' and
the JAX package's ``import_pose_resnet_params`` reads a state dict this
module saved.
"""
from __future__ import annotations

import torch
from torch import nn

from gastx_torch.device import check_f32_conv
from gastx_torch.pipeline.hrnet.model import BasicBlock, Bottleneck, make_layer

RESNET_SPEC = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


class PoseResNet(nn.Module):
    """(B, 3, H, W) -> (B, num_joints, H/4, W/4) heatmaps: ResNet stages,
    ``num_deconv`` k=4 s=2 p=1 transposed convs (no bias) with BN and ReLU,
    a 1x1 conv."""

    def __init__(self, num_layers: int = 50, num_joints: int = 17,
                 num_deconv: int = 3, deconv_filters: int = 256):
        super().__init__()
        kind, layers = RESNET_SPEC[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     layers), start=1):
            setattr(self, f"layer{stage}",
                    make_layer(block, inplanes, planes, blocks,
                               1 if stage == 1 else 2))
            inplanes = planes * block.expansion
        deconv = []
        for _ in range(num_deconv):
            deconv += [nn.ConvTranspose2d(inplanes, deconv_filters, 4, 2, 1,
                                          bias=False),
                       nn.BatchNorm2d(deconv_filters), nn.ReLU(inplace=True)]
            inplanes = deconv_filters
        self.deconv_layers = nn.Sequential(*deconv)
        self.final_layer = nn.Conv2d(inplanes, num_joints, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_f32_conv(x.device)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        return self.final_layer(self.deconv_layers(x))
