"""DEVANetwork: the temporal-propagation model, NCHW.

Port of deva_tpu/models/network.py with the four modes of inference:
  encode_image   image -> multi-scale features + key features
  transform_key  key features -> (key, shrinkage, selection)
  encode_mask    image + mask (+ sensory) -> memory value (+ sensory)
  segment        memory readout + sensory + last mask -> probabilities

Grouped tensors are [B, O, C, H, W]. `selector` [B, O] masks padded object
slots. Submodule names are upstream DEVA's, so an upstream state dict (or
deva_tpu variables through models/convert.py) loads with strict=True.
The convolutions and dense layers compute in config.compute_dtype (flax's
`dtype=`, models/layers.py); the parameters stay f32, so the state dict is
the same in every dtype. Logit aggregation, the sigmoid, the selector and
the final x4 upsample run in float32 (deva_tpu/models/network.py:106-140):
`prob` is f32 whatever the compute dtype, and so is the sensory state.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from reference.config import ModelConfig
from reference.models.blocks import KeyProjection
from reference.models.decoder import MaskDecoder
from reference.models.encoders import MaskEncoder, PixelEncoder
from reference.models.layers import set_compute_dtype
from reference.ops.aggregate import aggregate_logits
from reference.ops.resize import downsample_area, upsample_bilinear


class DEVANetwork(nn.Module):
    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        self.config = config
        self.pixel_encoder = PixelEncoder(config.pix_feat_dim)
        self.mask_encoder = MaskEncoder(config.pix_feat_dim,
                                        config.value_dim, config.value_dim)
        self.key_proj = KeyProjection(config.pix_feat_dim, config.key_dim)
        self.mask_decoder = MaskDecoder(config.value_dim,
                                        config.pix_feat_dim)
        set_compute_dtype(self, config.compute_dtype)

    def encode_image(self, image: torch.Tensor):
        """image [B, 3, H, W] -> ((f16, f8, f4), key_feat [B, Cp, h, w])"""
        return self.pixel_encoder(image)

    def transform_key(self, feat: torch.Tensor, need_sk: bool = True,
                      need_ek: bool = True):
        """feat [B, Cp, h, w] -> (key [B, Ck, h, w], shrinkage [B, 1, h, w],
        selection [B, Ck, h, w])"""
        return self.key_proj(feat, need_s=need_sk, need_e=need_ek)

    def encode_mask(self, image, pix_f16, sensory, masks,
                    deep_update: bool = True):
        """-> (value [B, O, Cv, h, w], new_sensory [B, O, Cs, h, w])"""
        return self.mask_encoder(image, pix_f16, sensory, masks,
                                 deep_update=deep_update)

    def segment(self, multi_scale_features, memory_readout: torch.Tensor,
                sensory: torch.Tensor, last_mask: torch.Tensor,
                selector: Optional[torch.Tensor] = None,
                update_sensory: bool = True):
        """memory_readout/sensory [B, O, C, h, w]; last_mask [B, O, H, W]
        -> (new_sensory, logits [B, O+1, H, W], prob [B, O+1, H, W])."""
        lm = downsample_area(last_mask, 16)[:, :, None]  # [B, O, 1, h, w]
        new_sensory, logits = self.mask_decoder(
            multi_scale_features, memory_readout, sensory, lm,
            update_sensory=update_sensory)
        lg, prob = _aggregate(logits, selector, 4)
        return new_sensory, lg, prob


def _aggregate(logits: torch.Tensor, selector: Optional[torch.Tensor],
               factor: int):
    """Per-object logits [B, O, h, w] -> (joint logits [B, O+1, h*factor,
    w*factor], their softmax), in f32."""
    prob = torch.sigmoid(logits.float())
    if selector is not None:
        prob = prob * selector[:, :, None, None]
    lg = upsample_bilinear(aggregate_logits(prob, axis=1), factor)
    return lg, torch.softmax(lg, dim=1)
