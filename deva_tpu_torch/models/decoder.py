"""Mask decoder: memory readout + compressed sensory (+ last mask) fused with
pixel features, two x2 upsampling stages, per-object 1-channel logits, and a
multi-scale GRU update of the sensory memory. NCHW.

Port of deva_tpu/models/decoder.py (dtypes as in its lines 52-82): the f32
memory readout is cast to the compute dtype before the sensory_compress
add; the logits conv (`pred`, a plain nn.Conv2d) runs in f32 on
relu(p4) widened to f32; the logits are cast to p4's dtype before they
join the sensory update.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from deva_tpu_torch.models.blocks import (DecoderFeatureProcessor, GConv2D,
                                          GroupFeatureFusionBlock,
                                          LinearPredictor, MaskUpsampleBlock,
                                          SensoryUpdater)
from deva_tpu_torch.ops.resize import downsample_area


class MaskDecoder(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, val_dim: int = 512, pix_feat_dim: int = 512):
        super().__init__()
        self.decoder_feat_proc = DecoderFeatureProcessor([512, 256],
                                                         [val_dim, 256])
        self.sensory_compress = GConv2D(val_dim + 1, val_dim, 1)
        self.fuser = GroupFeatureFusionBlock(pix_feat_dim, val_dim, val_dim,
                                             val_dim)
        self.up_16_8 = MaskUpsampleBlock(val_dim, 256)
        self.up_8_4 = MaskUpsampleBlock(256, 256)
        self.pred = nn.Conv2d(256, 1, 3, padding=1)
        self.sensory_update = SensoryUpdater([val_dim, 256, 256 + 1], 512,
                                             val_dim)
        self.sensory_linear_pred = LinearPredictor(val_dim, pix_feat_dim)

    def forward(self, multi_scale_features, memory_readout: torch.Tensor,
                sensory: torch.Tensor, last_mask: torch.Tensor,
                need_aux: bool = False, update_sensory: bool = True):
        """multi_scale_features: (f16 [B,512,h,w], f8, f4);
        memory_readout/sensory: [B, O, C, h, w]; last_mask [B, O, 1, h, w]
        (already area-downsampled to stride 16)
        -> (new_sensory, logits [B, O, 4h, 4w]) and, with need_aux, the
        training aux logits [B, O, h, w] of the sensory state as it came in
        (deva_tpu/models/decoder.py:43-47)."""
        f16, f8, f4 = multi_scale_features
        aux_logits = None
        if need_aux:
            aux_logits = self.sensory_linear_pred(f16, sensory)[:, :, 0]
        skip8, skip4 = self.decoder_feat_proc([f8, f4])

        p16 = memory_readout.to(self.compute_dtype) + self.sensory_compress(
            torch.cat([sensory, last_mask], dim=2))
        p16 = self.fuser(f16, p16)
        p8 = self.up_16_8(skip8, p16)
        p4 = self.up_8_4(skip4, p8)

        b, o = p4.shape[:2]
        logits = self.pred(F.relu(p4.flatten(0, 1)).float())
        logits_g = logits.view(b, o, *logits.shape[1:])  # [B, O, 1, 4h, 4w]

        new_sensory = sensory
        if update_sensory:
            # area means commute with the channel concat, so each part is
            # downsampled on its own (as in deva_tpu/models/decoder.py:76-82)
            p4_with_logit_s16 = torch.cat(
                [downsample_area(p4, 4),
                 downsample_area(logits_g.to(p4.dtype), 4)],
                dim=2)
            new_sensory = self.sensory_update(
                p16, downsample_area(p8, 2), p4_with_logit_s16, sensory)
        if need_aux:
            return new_sensory, logits_g[:, :, 0], aux_logits
        return new_sensory, logits_g[:, :, 0]
