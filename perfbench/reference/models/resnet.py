"""ResNet-18/50 trunks to stride 16 (conv1 .. layer3), NCHW.

Port of deva_tpu/models/resnet.py. torchvision's block layout, so that the
state-dict keys are upstream DEVA's (conv1, bn1, layerN.i.convM, bnM,
downsample.0/1); layer4 is not built. BatchNorm runs in eval mode with
PyTorch's default eps=1e-5, the flax code's value. Paddings are the
explicit symmetric ones of the flax code; the stride of a bottleneck sits
on its 3x3 conv (ResNet v1.5).

The convolutions compute in the model's compute dtype (models/layers.py).
Like flax's nn.BatchNorm(dtype=bf16) (deva_tpu/models/resnet.py:99-121),
BatchNorm2d takes a bf16 input with its f32 statistics and parameters,
normalises in f32 and returns bf16, on the CPU and on a CUDA device.

The trunk modules are attributes of the encoders themselves (upstream
names: the ResNet-50 stage 1 is `res2`, the ResNet-18 one `layer1`), so this
module provides the blocks and the function that stacks them into a
stage.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.models.layers import Conv2d


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out, 1, stride, bias=False),
                nn.BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def make_stage(block, inplanes: int, planes: int, blocks: int,
               stride: int) -> nn.Sequential:
    layers = [block(inplanes, planes, stride)]
    layers += [block(planes * block.expansion, planes)
               for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


def stem(in_dim: int):
    """conv1 (7x7/2) and bn1; the caller applies relu and the 3x3/2 max
    pool (`stem_forward`)."""
    return Conv2d(in_dim, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64)


def stem_forward(conv1: nn.Conv2d, bn1: nn.BatchNorm2d,
                 x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(F.relu(bn1(conv1(x))), 3, 2, 1)  # 1/4
