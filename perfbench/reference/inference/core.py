"""InferenceCore: the stateful per-video propagation engine, for
semi-supervised VOS (every object's mask given on the first frame).

Port of deva_tpu/inference/core.py's single-stream path. Host-side
orchestration around the model's four modes and the memory engine:

  - the object axis is padded to a bucket size; a `selector` zeroes the
    padded slots inside `segment`;
  - the memory lives in fixed-capacity rings (inference/memory.py);
  - probabilities returned to the caller are sliced back to 1+num_obj.

The first frame's mask is encoded into memory; every later frame takes the
fused step (inference/fused_step.py), whose eligibility (one bucket in
identity object order, a long-term ring only for that bucket) always holds
once the first frame's objects are in memory.

Frames enter as f32 in every configuration (the model's first conv casts
them to its compute dtype, as deva_tpu's does); the probabilities and
last_mask are f32, the rings in InferenceConfig.ring_dtype.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from reference.config import InferenceConfig
from reference.inference.fused_step import FusedStepper
from reference.inference.memory import MemoryEngine
from reference.models.network import DEVANetwork
from reference.ops.aggregate import aggregate_logits
from reference.ops.pad import pad_divide_by, unpad


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[1, C, h, w] -> token-major [h*w, C]."""
    return x[0].flatten(1).T.contiguous()


class InferenceCore:
    def __init__(self, model: DEVANetwork, config: InferenceConfig, *,
                 device: Optional[torch.device] = None):
        self.model = model.eval()
        self.device = torch.device(device) if device is not None else \
            next(model.parameters()).device
        self.cfg = config
        self.mem_every = config.mem_every
        self._mc = model.config

        self.curr_ti = -1
        self.last_mem_ti = 0
        self.obj_ids: List[int] = []  # the objects, in slot order
        self.memory: Optional[MemoryEngine] = None
        self.o_cap = 0
        self.last_mask: Optional[torch.Tensor] = None  # [O_cap, H, W] probs
        self._fused = FusedStepper(self.model, config.top_k,
                                   topk_method=config.topk_method)

    def _first_frame(self, image, mask, objects: List[int]) -> torch.Tensor:
        """The first frame: its hard mask [H, W] (values `objects`) into
        memory. Returns probabilities [1 + num_obj, H, W], unpadded."""
        image = torch.as_tensor(image, dtype=torch.float32,
                                device=self.device)
        image, pad = pad_divide_by(image.permute(2, 0, 1), 16, -2, -1)
        image = image[None]
        ms_features, key_feat = self.model.encode_image(image)
        key, shrinkage, selection = self.model.transform_key(key_feat)

        self.obj_ids = list(objects)
        n = len(self.obj_ids)
        self.o_cap = self.cfg.pad_objects(max(1, n))
        self.memory = MemoryEngine(self.cfg, self._mc.value_dim,
                                   self._mc.key_dim, self._mc.value_dim,
                                   o_cap=self.o_cap, device=self.device)

        mask, _ = pad_divide_by(torch.as_tensor(mask, device=self.device),
                                16, -2, -1)
        layers = torch.stack([(mask == o).float() for o in self.obj_ids])
        merged = F.pad(layers, (0, 0, 0, 0, 0, self.o_cap - n))
        prob = torch.softmax(aggregate_logits(merged, axis=0), dim=0)
        self.last_mask = prob[1:]

        # the first frame is a memory frame (deep update)
        hq, wq = key.shape[2], key.shape[3]
        self.memory.initialize_sensory(hq, wq)
        value, sensory = self.model.encode_mask(
            image, ms_features[0], self.memory.get_sensory()[None],
            self.last_mask[None], deep_update=True)
        self.memory.add_memory(
            _tokens(key), shrinkage[0].flatten(),
            value[0].flatten(2).transpose(1, 2),  # [O_cap, HW, Cv]
            self.obj_ids, selection=_tokens(selection))
        self.last_mem_ti = self.curr_ti
        self.memory.update_sensory(sensory[0])
        return unpad(prob[:n + 1], pad, -2, -1)

    @torch.no_grad()
    def step(self, image, mask=None, objects: Optional[List[int]] = None, *,
             end: bool = False) -> torch.Tensor:
        """Propagate one frame.

        image: [H, W, 3] float32, ImageNet-normalized (numpy or tensor).
        mask: the first frame's [H, W] int mask, whose values are `objects`.
        Returns probabilities [1 + num_obj, H, W] (background first) on the
        core's device, unpadded.
        """
        self.curr_ti += 1
        if mask is not None:
            if self.memory is not None:
                raise ValueError("masks are taken on the first frame only")
            return self._first_frame(image, mask, objects)
        if self.memory is None:
            raise ValueError("the first frame needs its mask")

        is_mem_frame = (self.curr_ti - self.last_mem_ti >= self.mem_every) \
            and not end
        image = torch.as_tensor(image, dtype=torch.float32,
                                device=self.device)
        (bid, bucket), = self.memory.buckets.items()
        lt = self.memory.long_buckets.get(bid)
        if is_mem_frame:
            h, w = image.shape[:2]
            hw_tokens = (-(-h // 16)) * (-(-w // 16))
            bucket.ensure_capacity(
                hw_tokens, hw_tokens,
                limit=self.memory.max_work_tokens
                if self.memory.use_long_term else None)
        prob, sensory, self.last_mask = self._fused(
            image, len(self.obj_ids), bucket, lt, self.memory.get_sensory(),
            self.last_mask, mem_write=is_mem_frame, update_sensory=not end,
            work_usage=self.memory.use_long_term,
            count_lt_usage=self.memory.count_long_term_usage)
        self.memory.update_sensory(sensory)
        if is_mem_frame:
            self.last_mem_ti = self.curr_ti
            self.memory.maybe_consolidate()
        return prob
