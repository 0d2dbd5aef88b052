"""InferenceCore: the stateful per-video propagation engine.

Port of deva_tpu/inference/core.py (`step` and what it needs). Host-side
orchestration around the model's four modes and the memory engine:

  - the object axis is padded to a bucket size; a `selector` zeroes the
    padded slots inside `segment`;
  - the memory lives in fixed-capacity rings (inference/memory.py), whose
    attention runs through the CUDA kernels on a CUDA device;
  - probabilities returned to the caller are sliced back to 1+num_obj.

`step` always takes deva_tpu's composed path; its results are those of
deva_tpu's fused single-program step, which computes the same sub-functions
(deva_tpu/inference/fused_step.py:14-16). Not ported yet: block stepping
(`step_chunk`), object-axis sharding and detection fusion.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.feature_store import ImageFeatureStore
from deva_tpu_torch.inference.memory import MemoryEngine
from deva_tpu_torch.inference.object_manager import ObjectManager
from deva_tpu_torch.models.network import DEVANetwork
from deva_tpu_torch.ops.aggregate import aggregate_logits
from deva_tpu_torch.ops.pad import pad_divide_by, unpad


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
        self.object_manager = ObjectManager()
        self.memory: Optional[MemoryEngine] = None
        self.o_cap = 0
        self.image_feature_store = ImageFeatureStore(
            self.model.encode_image, self.model.transform_key)
        self.last_mask: Optional[torch.Tensor] = None  # [O_cap, H, W] probs
        self.pad: Tuple[int, int, int, int] = (0, 0, 0, 0)

    # -- object-slot management -------------------------------------------

    def _ensure_capacity(self) -> None:
        """(Re)size the padded object axis to hold num_obj slots."""
        need = self.cfg.pad_objects(max(1, self.object_manager.num_obj))
        if self.memory is None:
            self.memory = MemoryEngine(self.cfg, self._mc.value_dim,
                                       self._mc.key_dim, self._mc.value_dim,
                                       o_cap=need, device=self.device)
            self.o_cap = need
            return
        if need > self.o_cap:
            grow = need - self.o_cap
            self.memory.o_cap = need
            if self.memory.sensory is not None:
                self.memory.sensory = F.pad(self.memory.sensory,
                                            (0, 0, 0, 0, 0, 0, 0, grow))
            if self.last_mask is not None:
                self.last_mask = F.pad(self.last_mask, (0, 0, 0, 0, 0, grow))
            self.o_cap = need

    def _selector(self) -> torch.Tensor:
        n = self.object_manager.num_obj
        return (torch.arange(self.o_cap, device=self.device) < n).float()[None]

    def _pad_objects(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-pad the object axis (dim 0) of [O, H, W] to o_cap."""
        return F.pad(x, (0, 0, 0, 0, 0, self.o_cap - x.shape[0]))

    # -- internals ----------------------------------------------------------

    def _segment(self, key, shrinkage, selection, ms_features,
                 update_sensory: bool = True) -> torch.Tensor:
        """-> probabilities [1 + O_cap, H, W] (padded channels ~ 0)."""
        if self.memory is None or not self.memory.engaged:
            warnings.warn("Trying to segment without any memory!",
                          RuntimeWarning)
            h, w = key.shape[2] * 16, key.shape[3] * 16
            return torch.zeros((1, h, w), device=self.device)

        hq, wq = key.shape[2], key.shape[3]
        obj_rows = {o.id: t - 1
                    for o, t in self.object_manager.obj_to_tmp_id.items()}
        readout = self.memory.match_memory(_tokens(key), _tokens(selection),
                                           obj_rows)  # [O_cap, HW, Cv]
        readout = readout.transpose(1, 2).reshape(1, self.o_cap, -1, hq, wq)

        sensory = self.memory.get_sensory()[None]
        last_mask = self.last_mask[None] if self.last_mask is not None else \
            torch.zeros((1, self.o_cap, hq * 16, wq * 16), device=self.device)
        new_sensory, _, prob = self.model.segment(
            ms_features, readout, sensory, last_mask,
            selector=self._selector(), update_sensory=update_sensory)
        if update_sensory:
            self.memory.update_sensory(new_sensory[0])
        return prob[0]

    def _add_memory(self, image, ms_features, prob_no_bg, key, shrinkage,
                    selection, *, is_deep_update: bool = True) -> None:
        """prob_no_bg: [O_cap, H, W]."""
        if self.object_manager.num_obj == 0:
            warnings.warn("Empty object mask!", RuntimeWarning)
            return
        hq, wq = key.shape[2], key.shape[3]
        self.memory.initialize_sensory(hq, wq)
        value, sensory = self.model.encode_mask(
            image, ms_features[0], self.memory.get_sensory()[None],
            prob_no_bg[None], deep_update=is_deep_update)
        self.memory.add_memory(
            _tokens(key), shrinkage[0].flatten(),
            value[0].flatten(2).transpose(1, 2),  # [O_cap, HW, Cv]
            self.object_manager.all_obj_ids,
            selection=_tokens(selection) if selection is not None else None)
        self.last_mem_ti = self.curr_ti
        if is_deep_update:
            self.memory.update_sensory(sensory[0])

    # -- public API ----------------------------------------------------------

    @torch.no_grad()
    def step(self, image, mask=None, objects: Optional[List[int]] = None, *,
             hard_mask: bool = True, end: bool = False,
             image_ti_override: Optional[int] = None,
             delete_buffer: bool = True) -> torch.Tensor:
        """Propagate one frame.

        image: [H, W, 3] float32, ImageNet-normalized (numpy or tensor).
        mask: [H, W] int (hard) or [num_objects, H, W] float (soft) or None.
        objects: object ids corresponding to the hard mask values.
        Returns probabilities [1 + num_obj, H, W] (background first) on the
        core's device, unpadded.
        """
        if objects is None and mask is not None:
            if hard_mask:
                raise ValueError("a hard mask needs its object ids")
            objects = list(range(1, mask.shape[0] + 1))

        self.curr_ti += 1
        image_ti = self.curr_ti if image_ti_override is None else \
            image_ti_override
        is_mem_frame = ((self.curr_ti - self.last_mem_ti >= self.mem_every)
                        or (mask is not None)) and (not end)

        image = torch.as_tensor(image, dtype=torch.float32,
                                device=self.device).permute(2, 0, 1)
        image, self.pad = pad_divide_by(image, 16, -2, -1)
        image = image[None]

        need_segment = (mask is None) or (
            self.object_manager.num_obj > 0
            and not self.object_manager.has_all(list(objects or [])))

        ms_features, key, shrinkage, selection = \
            self.image_feature_store.get_features(image_ti, image)

        if self.memory is None:
            self._ensure_capacity()

        pred_prob_with_bg = None
        if need_segment:
            pred_prob_with_bg = self._segment(key, shrinkage, selection,
                                              ms_features,
                                              update_sensory=not end)

        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
            mask, _ = pad_divide_by(mask, 16, -2, -1)
            pred_prob_with_bg = self._merge_input_mask(
                mask, objects, hard_mask, need_segment, pred_prob_with_bg)

        # keep all padded slots in last_mask (fixed shape)
        n = self.object_manager.num_obj
        self.last_mask = self._pad_objects(pred_prob_with_bg[1:])

        if is_mem_frame:
            self._add_memory(image, ms_features, self.last_mask, key,
                             shrinkage, selection)

        if delete_buffer:
            self.image_feature_store.delete(image_ti)

        return unpad(pred_prob_with_bg[:n + 1], self.pad, -2, -1)

    def _merge_input_mask(self, mask, objects, hard_mask: bool,
                          need_segment: bool, pred_prob_with_bg):
        """Merge a provided (possibly partial) mask with the forward
        prediction."""
        tmp_ids, _ = self.object_manager.add_new_objects(list(objects))
        self._ensure_capacity()

        if hard_mask:
            layers = [(mask == objects[i]).float()
                      for i in range(len(tmp_ids))]
        else:
            layers = [mask[i].float() for i in range(len(tmp_ids))]
        if need_segment:
            claimed = (mask > 0) if hard_mask else (mask.amax(dim=0) > 0.5)
            merged = self._pad_objects(
                torch.where(claimed[None], 0.0, pred_prob_with_bg[1:]))
            merged[[t - 1 for t in tmp_ids]] = torch.stack(layers)
        else:
            merged = self._pad_objects(torch.stack(layers))

        logits = aggregate_logits(merged, axis=0)
        return torch.softmax(logits, dim=0)
