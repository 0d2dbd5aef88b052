"""DEVANetwork: the temporal-propagation model, NCHW.

Port of deva_tpu/models/network.py with its five modes:
  encode_image   image -> multi-scale features + key features
  transform_key  key features -> (key, shrinkage, selection)
  encode_mask    image + mask (+ sensory) -> memory value (+ sensory)
  read_memory    the dense-softmax memory readout of training
  segment        memory readout + sensory + last mask -> probabilities
                 (and, for training, the aux head's)

Grouped tensors are [B, O, C, H, W]. `selector` [B, O] masks padded object
slots. `segment` and `encode_mask` take the live slots (`LiveSlots`) when
some slots are padding: the per-object work then runs on the live slots
alone, packed along the folded batch axis, and is scattered back to
[B, O, ...]. Submodule names are upstream DEVA's, so an upstream state dict
(or deva_tpu variables through models/convert.py) loads with strict=True.
The convolutions and dense layers compute in config.compute_dtype (flax's
`dtype=`, models/layers.py); the parameters stay f32, so the state dict is
the same in every dtype. Logit aggregation, the sigmoid, the selector and
the final x4 upsample run in float32 (deva_tpu/models/network.py:106-140):
`prob` is f32 whatever the compute dtype, and so is the sensory state.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from deva_tpu_torch.config import ModelConfig
from deva_tpu_torch.models.blocks import KeyProjection
from deva_tpu_torch.models.decoder import MaskDecoder
from deva_tpu_torch.models.encoders import MaskEncoder, PixelEncoder
from deva_tpu_torch.models.layers import set_compute_dtype
from deva_tpu_torch.ops.aggregate import aggregate_logits
from deva_tpu_torch.ops.memory_attention import (full_softmax, get_similarity,
                                                 readout)
from deva_tpu_torch.ops.resize import downsample_area, upsample_bilinear
from deva_tpu_torch.parallel.object_sharding import object_softmax
from deva_tpu_torch.utils import tracing


class LiveSlots(NamedTuple):
    """The live (video, object) slots of a [B, O] group: `index` [L], the
    folded slot v*O + o of each, and `video` [L], its v; int64 on the
    model's device, ascending."""
    index: torch.Tensor
    video: torch.Tensor


def live_slots(num_obj, o_cap: int, device) -> LiveSlots:
    """The slots o < num_obj[v] of each video v (host integers) at o_cap
    slots a video, moved to `device` in one copy."""
    video = np.repeat(np.arange(len(num_obj)), num_obj)
    obj = np.concatenate([np.arange(n) for n in num_obj])
    both = torch.as_tensor(np.stack([video * o_cap + obj, video]),
                           dtype=torch.int64).to(device)
    return LiveSlots(both[0], both[1])


def _packed(live: Optional[LiveSlots], slots: int,
            name: str) -> Optional[LiveSlots]:
    """`live`, or None where it covers every one of the `slots` slots
    (decided from its host length), after counting the mode's slots."""
    n = slots if live is None else len(live.index)
    tracing.count(name + ".slots", slots)
    tracing.count(name + ".live_slots", n)
    return None if n == slots else live


def _pack(g: torch.Tensor, live: LiveSlots) -> torch.Tensor:
    """[B, O, ...] -> the live slots' [L, 1, ...]."""
    return g.flatten(0, 1).index_select(0, live.index)[:, None]


def _unpack(x: torch.Tensor, live: LiveSlots,
            base: torch.Tensor) -> torch.Tensor:
    """The live slots' [L, 1, ...] written over `base` [B, O, ...]."""
    return base.flatten(0, 1).index_copy(
        0, live.index, x[:, 0].to(base.dtype)).view(base.shape)


def _unpack_zeros(x: torch.Tensor, live: LiveSlots, b: int,
                  o: int) -> torch.Tensor:
    """The live slots' [L, 1, ...] in [B, O, ...], zero elsewhere."""
    return _unpack(x, live, x.new_zeros((b, o, *x.shape[2:])))


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
        with tracing.span("deva.encode_image"):
            return self.pixel_encoder(image)

    def transform_key(self, feat: torch.Tensor, need_sk: bool = True,
                      need_ek: bool = True):
        """feat [B, Cp, h, w] -> (key [B, Ck, h, w], shrinkage [B, 1, h, w],
        selection [B, Ck, h, w])"""
        with tracing.span("deva.transform_key"):
            return self.key_proj(feat, need_s=need_sk, need_e=need_ek)

    def encode_mask(self, image, pix_f16, sensory, masks,
                    deep_update: bool = True,
                    live: Optional[LiveSlots] = None):
        """-> (value [B, O, Cv, h, w], new_sensory [B, O, Cs, h, w]).
        live: the slots to encode; the others get value 0 and keep their
        sensory state. Counters: encode_mask.slots, encode_mask.live_slots.
        """
        with tracing.span("deva.encode_mask"):
            b, o = masks.shape[:2]
            live = _packed(live, b * o, "encode_mask")
            if live is None:
                return self.mask_encoder(image, pix_f16, sensory, masks,
                                         deep_update=deep_update)
            value, new_sensory = self.mask_encoder(
                image, pix_f16, _pack(sensory, live), _pack(masks, live),
                deep_update=deep_update, video=live.video)
            return (_unpack_zeros(value, live, b, o),
                    _unpack(new_sensory, live, sensory) if deep_update
                    else sensory)

    def read_memory(self, query_key: torch.Tensor,
                    query_selection: torch.Tensor, memory_key: torch.Tensor,
                    memory_shrinkage: torch.Tensor,
                    memory_value: torch.Tensor) -> torch.Tensor:
        """The dense attention readout of training: every memory token of
        each batch element, no top-k (deva_tpu/models/network.py:69-89,
        reference:deva/model/network.py:72-92).

        query_key/query_selection [B, Ck, h, w]; memory_key [B, N, Ck];
        memory_shrinkage [B, N]; memory_value [B, O, N, Cv]
        -> [B, O, Cv, h, w] in the compute dtype."""
        b, ck, h, w = query_key.shape
        qk = query_key.flatten(2).transpose(1, 2)  # [B, hw, Ck]
        qe = query_selection.flatten(2).transpose(1, 2)
        aff = full_softmax(get_similarity(memory_key, memory_shrinkage, qk,
                                          qe))  # [B, hw, N]
        out = readout(aff[:, None], memory_value)  # [B, O, hw, Cv]
        return out.transpose(2, 3).reshape(b, out.shape[1], -1, h, w).to(
            self.config.compute_dtype)

    def segment(self, multi_scale_features, memory_readout: torch.Tensor,
                sensory: torch.Tensor, last_mask: torch.Tensor,
                selector: Optional[torch.Tensor] = None,
                need_aux: bool = False, update_sensory: bool = True,
                group=None, live: Optional[LiveSlots] = None):
        """memory_readout/sensory [B, O, C, h, w]; last_mask [B, O, H, W]
        -> (new_sensory, logits [B, O+1, H, W], prob [B, O+1, H, W]) and,
        with need_aux, the aux head's (logits, prob) [B, O+1, H, W]: the
        stride-16 aux logits through the same sigmoid, selector and
        aggregation, x16 bilinear (deva_tpu/models/network.py:110-121).
        group: the object axis's process group when the O slots are this
        process's share of them (parallel/object_sharding.py): the
        background product and the softmax then run over every process's
        objects, and the result holds the background and this process's
        objects.
        live: the slots to decode (not with `group`); the others, which
        `selector` must zero, get logits 0 and keep their sensory state.
        Counters: segment.slots, segment.live_slots."""
        if live is not None and (group is not None or selector is None):
            raise ValueError("live slots need a selector and no "
                             "object-sharding group")
        with tracing.span("deva.segment"):
            b, o = sensory.shape[:2]
            live = _packed(live, b * o, "segment")
            if live is None:
                # [B, O, 1, h, w]
                lm = downsample_area(last_mask, 16)[:, :, None]
                out = self.mask_decoder(multi_scale_features, memory_readout,
                                        sensory, lm, need_aux=need_aux,
                                        update_sensory=update_sensory)
            else:
                lm = downsample_area(_pack(last_mask, live), 16)[:, :, None]
                out = self.mask_decoder(
                    multi_scale_features, _pack(memory_readout, live),
                    _pack(sensory, live), lm, need_aux=need_aux,
                    update_sensory=update_sensory, video=live.video)
                out = ((_unpack(out[0], live, sensory) if update_sensory
                        else sensory),) + tuple(
                    _unpack_zeros(x, live, b, o) for x in out[1:])
            lg, prob = _aggregate(out[1], selector, 4, group)
            if need_aux:
                return (out[0], lg, prob) + _aggregate(out[2], selector, 16,
                                                       group)
            return out[0], lg, prob


def _aggregate(logits: torch.Tensor, selector: Optional[torch.Tensor],
               factor: int, group=None):
    """Per-object logits [B, O, h, w] -> (joint logits [B, O+1, h*factor,
    w*factor], their softmax), in f32; over every process's objects of
    `group` when given."""
    prob = torch.sigmoid(logits.float())
    if selector is not None:
        prob = prob * selector[:, :, None, None]
    lg = upsample_bilinear(aggregate_logits(prob, axis=1, group=group),
                           factor)
    return lg, object_softmax(lg, 1, group)


@torch.no_grad()
def init_weights(model: DEVANetwork, seed: int) -> DEVANetwork:
    """Seeded random weights, drawn on the CPU from one torch.Generator (the
    same seed gives the same weights on every device), with the
    distributions of upstream DEVA's own initialisation: He fan-out normal
    for the ResNet trunks, orthogonal for the key projection, Xavier normal
    for the GRU transforms, PyTorch's default uniform elsewhere; identity
    BatchNorm statistics."""
    gen = torch.Generator().manual_seed(seed)
    trunk_convs = {id(m) for enc in (model.pixel_encoder, model.mask_encoder)
                   for m in enc.modules()
                   if isinstance(m, nn.Conv2d) and m.bias is None}
    for name, m in model.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        if not isinstance(m, (nn.Conv2d, nn.Linear)):
            continue
        w = m.weight
        receptive = w[0, 0].numel() if w.ndim == 4 else 1
        fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
        bound = 1.0 / math.sqrt(fan_in)
        if id(m) in trunk_convs:
            new = torch.randn(w.shape, generator=gen) * \
                math.sqrt(2.0 / fan_out)
        elif name == "key_proj.key_proj":
            # rows of a QR factor: orthonormal over the flattened fan-in
            g = torch.randn((fan_in, w.shape[0]), generator=gen)
            new = torch.linalg.qr(g)[0].T.reshape(w.shape)
        elif name.endswith("sensory_update.transform"):
            new = torch.randn(w.shape, generator=gen) * \
                math.sqrt(2.0 / (fan_in + fan_out))
        else:
            new = (torch.rand(w.shape, generator=gen) * 2 - 1) * bound
        w.copy_(new)
        if m.bias is not None:
            if name == "key_proj.key_proj":
                m.bias.zero_()
            else:
                m.bias.copy_((torch.rand(m.bias.shape, generator=gen) * 2 - 1)
                             * bound)
    return model
