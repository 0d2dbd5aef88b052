"""Pixel (key) and mask (value) encoders, NCHW.

Port of deva_tpu/models/encoders.py.
  PixelEncoder: ResNet-50 trunk to stride 16, two 1x1 projections (decoder
    skip path + key features). Upstream's attribute names: conv1, bn1, res2,
    layer2, layer3, proj1, proj2.
  MaskEncoder: ResNet-18 with a 4th (mask) input channel to stride 16,
    fused with the pixel f16 by a GroupFeatureFusionBlock, plus a deep GRU
    update of the sensory memory. Attribute names: conv1, bn1, layer1..3,
    fuser, sensory_update.
All object slots run as one folded batch. Frames and masks enter in f32;
the first conv casts them to the compute dtype, as in deva_tpu.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from deva_tpu_torch.models.blocks import (GroupFeatureFusionBlock,
                                          SensoryDeepUpdater, per_object)
from deva_tpu_torch.models.layers import Conv2d
from deva_tpu_torch.models.resnet import (BasicBlock, Bottleneck, make_stage,
                                          stem, stem_forward)


class PixelEncoder(nn.Module):
    def __init__(self, pix_feat_dim: int = 512):
        super().__init__()
        self.conv1, self.bn1 = stem(3)
        self.res2 = make_stage(Bottleneck, 64, 64, 3, 1)
        self.layer2 = make_stage(Bottleneck, 256, 128, 4, 2)
        self.layer3 = make_stage(Bottleneck, 512, 256, 6, 2)
        self.proj1 = Conv2d(1024, pix_feat_dim, 1)
        self.proj2 = Conv2d(1024, pix_feat_dim, 1)

    def forward(self, image: torch.Tensor):
        """image [B, 3, H, W] -> ((f16_proj, f8, f4), key_feat)"""
        x = stem_forward(self.conv1, self.bn1, image)
        f4 = self.res2(x)
        f8 = self.layer2(f4)
        f16 = self.layer3(f8)
        return (self.proj1(f16), f8, f4), self.proj2(f16)


class MaskEncoder(nn.Module):
    def __init__(self, pix_feat_dim: int = 512, value_dim: int = 512,
                 sensory_dim: int = 512):
        super().__init__()
        self.conv1, self.bn1 = stem(4)
        self.layer1 = make_stage(BasicBlock, 64, 64, 2, 1)
        self.layer2 = make_stage(BasicBlock, 64, 128, 2, 2)
        self.layer3 = make_stage(BasicBlock, 128, 256, 2, 2)
        self.fuser = GroupFeatureFusionBlock(pix_feat_dim, 256, value_dim,
                                             value_dim)
        self.sensory_update = SensoryDeepUpdater(value_dim, sensory_dim)

    def forward(self, image: torch.Tensor, pix_f16: torch.Tensor,
                sensory: torch.Tensor, masks: torch.Tensor,
                deep_update: bool = True,
                video: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image [B, 3, H, W]; pix_f16 [B, Cp, h, w]; sensory
        [B, O, Cs, h, w]; masks [B, O, H, W] in [0, 1]
        -> (value [B, O, Cv, h, w], new_sensory).
        video: packed slots, [L] int64: sensory and masks are [L, 1, ...]
        and slot i encodes with frame video[i]."""
        b, o = masks.shape[:2]
        g = torch.cat([per_object(image, o, video), masks[:, :, None]],
                      dim=2).flatten(0, 1)
        g = stem_forward(self.conv1, self.bn1, g)
        g16 = self.layer3(self.layer2(self.layer1(g)))
        g16 = self.fuser(pix_f16, g16.view(b, o, *g16.shape[1:]), video)
        new_sensory = self.sensory_update(g16, sensory) if deep_update \
            else sensory
        return g16, new_sensory
