"""InferenceCore: the stateful per-video propagation engine.

Port of deva_tpu/inference/core.py. Host-side orchestration around the
model's four modes and the memory engine:

  - the object axis is padded to a bucket size; a `selector` zeroes the
    padded slots inside `segment`;
  - the memory lives in fixed-capacity rings (inference/memory.py), whose
    attention runs through the CUDA kernels on a CUDA device;
  - probabilities returned to the caller are sliced back to 1+num_obj.

`step` takes the fused step (inference/fused_step.py) for a plain
propagation frame, under deva_tpu's eligibility rules, and the composed path
otherwise; `step_chunk` steps a memory period per call through the fused
block body.

Detection fusion (deva_tpu/inference/core.py:501-627): `spatial_alignment`
projects a frame's segments onto another frame (encode mask -> attention over
the source frame's tokens -> decode; exact attention launches the sim_topk
and topk_readout kernels on a CUDA device), `vote_in_temporary_buffer` runs
the in-clip consensus over the buffered frames (inference/consensus.py, on
the host but for the alignments), and `incorporate_detection` merges a
detection mask into the tracked objects (inference/segment_merging.py on the
host, with the forward prediction handed over as argmax ids), purges the
objects missed too often and writes the merged mask to memory. Several
cores advance in lockstep through inference/batched_detection.py, which
stacks their buckets (attach), steps them together and writes the state
back (detach); its forward predictions enter incorporate_detection as
`forward_mask`, its alignments vote_in_temporary_buffer as
`precomputed_proj`. Not ported yet: object-axis sharding (deva_tpu's
obj_mesh).

Frames enter as f32 in every configuration (the model's first conv casts
them to its compute dtype, as deva_tpu's does); the probabilities and
last_mask are f32, the rings in InferenceConfig.ring_dtype.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.consensus import \
    find_consensus_auto_association
from deva_tpu_torch.inference.feature_store import ImageFeatureStore
from deva_tpu_torch.inference.fused_step import FusedStepper
from deva_tpu_torch.inference.memory import MemoryEngine, attend
from deva_tpu_torch.inference.object_info import ObjectInfo
from deva_tpu_torch.inference.object_manager import ObjectManager
from deva_tpu_torch.inference.segment_merging import match_and_merge
from deva_tpu_torch.models.network import DEVANetwork
from deva_tpu_torch.ops.aggregate import aggregate_logits, argmax_ids
from deva_tpu_torch.ops.pad import pad_divide_by, unpad


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[1, C, h, w] -> token-major [h*w, C]."""
    return x[0].flatten(1).T.contiguous()


class InferenceCore:
    def __init__(self, model: DEVANetwork, config: InferenceConfig, *,
                 device: Optional[torch.device] = None,
                 image_feature_store: Optional[ImageFeatureStore] = None):
        """image_feature_store: a store shared with other cores of the same
        video (the bidirectional drivers give the consensus core's to both
        propagation passes, deva_tpu/inference/core.py:40); by default the
        core makes its own."""
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
        if image_feature_store is None:  # (an empty store is falsy)
            image_feature_store = ImageFeatureStore(
                self.model.encode_image, self.model.transform_key)
        self.image_feature_store = image_feature_store
        self.last_mask: Optional[torch.Tensor] = None  # [O_cap, H, W] probs
        self.pad: Tuple[int, int, int, int] = (0, 0, 0, 0)
        self.frame_buffer: List = []  # online/semi-online buffering
        self.next_voting_frame = config.num_voting_frames - 1
        self._fused = FusedStepper(self.model, config.top_k,
                                   topk_method=config.topk_method,
                                   preencode_blocks=config.preencode_blocks)

    # -- object-slot management -------------------------------------------

    def enabled_long_id(self) -> None:
        self.object_manager.use_long_id = True

    @property
    def use_long_id(self) -> bool:
        return self.object_manager.use_long_id

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

    def _image_nchw(self, image):
        """[H, W, 3] frame (numpy or tensor) -> padded [1, 3, H', W'] on the
        device, and the pad amounts."""
        image = torch.as_tensor(image, dtype=torch.float32,
                                device=self.device)
        image, pad = pad_divide_by(image.permute(2, 0, 1), 16, -2, -1)
        return image[None], pad

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
                                device=self.device)
        fused = self._try_fused_step(image, mask, is_mem_frame, end,
                                     image_ti_override, delete_buffer)
        if fused is not None:
            return fused

        image, self.pad = self._image_nchw(image)

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

    def _fused_bucket(self):
        """(bucket, long-term bucket | None) when the fused path applies to
        the memory as it stands (one bucket in identity object order, and a
        long-term ring only for that bucket), else None."""
        if self.memory is None or not self.memory.engaged or \
                self.last_mask is None or len(self.memory.buckets) != 1:
            return None
        (bid, bucket), = self.memory.buckets.items()
        if bucket.obj_ids != self.object_manager.all_obj_ids or \
                bucket.o_cap != self.o_cap:
            return None
        lt = self.memory.long_buckets.get(bid)
        if self.memory.long_buckets and lt is None:
            return None
        return bucket, lt

    def _max_work(self) -> Optional[int]:
        return self.memory.max_work_tokens if self.memory.use_long_term \
            else None

    def _try_fused_step(self, image, mask, is_mem_frame: bool, end: bool,
                        image_ti_override, delete_buffer: bool):
        """The fused path for a plain propagation frame (no input mask, no
        feature-store bookkeeping). image [H, W, 3] on the device. Returns
        the probabilities [1 + num_obj, H, W], or None when the composed
        path must run."""
        if mask is not None or image_ti_override is not None or \
                not delete_buffer:
            return None
        found = self._fused_bucket()
        if found is None:
            return None
        bucket, lt = found
        h, w = image.shape[:2]
        hw_tokens = (-(-h // 16)) * (-(-w // 16))
        if is_mem_frame:
            bucket.ensure_capacity(hw_tokens, hw_tokens,
                                   limit=self._max_work())
        prob, sensory, self.last_mask = self._fused(
            image, self.object_manager.num_obj, bucket, lt,
            self.memory.get_sensory(), self.last_mask,
            mem_write=is_mem_frame, update_sensory=not end,
            work_usage=self.memory.use_long_term,
            count_lt_usage=self.memory.count_long_term_usage)
        self.memory.update_sensory(sensory)
        if is_mem_frame:
            self.last_mem_ti = self.curr_ti
            self.memory.maybe_consolidate()
        return prob

    @torch.no_grad()
    def step_chunk(self, images, *, end: bool = False) -> List[torch.Tensor]:
        """Propagate several maskless frames, a memory period per call of
        the fused block body: the chunk is cut into blocks of read-only
        frames plus one trailing memory-write frame, ending before a
        consolidation would trigger and leaving an end frame to step().
        The same results as step() per frame; falls back to step() when the
        fused path does not apply. images: [H, W, 3] frames. Returns a list
        of [1 + num_obj, H, W] probabilities."""
        images = list(images)
        if not images:
            return []
        found = self._fused_bucket()
        if found is None:
            return [self.step(img, end=end and i == len(images) - 1)
                    for i, img in enumerate(images)]
        bucket, lt = found
        bid, = self.memory.buckets
        h, w = images[0].shape[:2]
        hw_tokens = (-(-h // 16)) * (-(-w // 16))
        max_work = self._max_work()

        out = []
        i = 0
        while i < len(images):
            # the longest run that fits, ends where a consolidation must
            # run, and leaves the end frame to step()
            writes = []
            size, last_mem = bucket.size, self.last_mem_ti
            for j in range(i, len(images)):
                if end and j == len(images) - 1:
                    break
                ti = self.curr_ti + 1 + (j - i)
                write = ti - last_mem >= self.mem_every
                writes.append(write)
                if write:
                    last_mem = ti
                    size += hw_tokens
                    if max_work is not None and size >= max_work:
                        break
            if not writes:
                out.append(self.step(images[i], end=True))
                i += 1
                continue

            k = len(writes)
            n_writes = sum(writes)
            if n_writes:
                bucket.ensure_capacity(n_writes * hw_tokens, hw_tokens,
                                       limit=max_work)
            frames = torch.stack([
                torch.as_tensor(im, dtype=torch.float32, device=self.device)
                for im in images[i:i + k]])
            probs, sensory, self.last_mask = self._fused.run_chunk(
                frames, writes, self.object_manager.num_obj, bucket, lt,
                self.memory.get_sensory(), self.last_mask,
                work_usage=self.memory.use_long_term,
                count_lt_usage=self.memory.count_long_term_usage)
            self.memory.update_sensory(sensory)
            self.curr_ti += k
            if n_writes:
                self.last_mem_ti = last_mem
                self.memory.maybe_consolidate()
                lt = self.memory.long_buckets.get(bid)
            out.extend(probs)
            i += k
        return out

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

    # -- consensus / detection fusion --------------------------------------

    @torch.no_grad()
    def spatial_alignment(self, src_ti: int, src_image, src_mask, tar_ti: int,
                          tar_image) -> np.ndarray:
        """Project src_mask [O, H, W] (one-hot float) from the src frame onto
        the target frame. The frames are [H, W, 3], already padded to /16.
        From a fresh zero sensory: encode the mask on the source frame (deep
        update), attend the target's query over the source frame's tokens,
        and decode without a sensory update, under a selector of
        cfg.pad_objects(O) slots. Returns [1 + O, H, W] probabilities
        (numpy, f32)."""
        o = src_mask.shape[0]
        o_pad = self.cfg.pad_objects(o)
        src_mask = torch.as_tensor(np.asarray(src_mask, np.float32),
                                   device=self.device)
        src_mask = F.pad(src_mask, (0, 0, 0, 0, 0, o_pad - o))
        selector = (torch.arange(o_pad, device=self.device) < o).float()[None]
        src_image, _ = self._image_nchw(src_image)
        tar_image, _ = self._image_nchw(tar_image)
        src_ms, src_key, src_shr, _ = self.image_feature_store.get_features(
            src_ti, src_image)
        tar_ms, tar_key, _, tar_sel = self.image_feature_store.get_features(
            tar_ti, tar_image)

        hq, wq = src_key.shape[-2:]
        sensory = torch.zeros((1, o_pad, self._mc.value_dim, hq, wq),
                              device=self.device)
        value, sensory = self.model.encode_mask(
            src_image, src_ms[0], sensory, src_mask[None], deep_update=True)
        mk, ms = _tokens(src_key), src_shr[0].flatten()
        if mk.dtype != ms.dtype:  # the kernels take one dtype for both
            mk, ms = mk.float(), ms.float()
        values = value[0].flatten(2).permute(2, 0, 1).contiguous()  # [HW,O,Cv]
        readout = attend(self.cfg.resolve_topk_method() == "approx", mk, ms,
                         values, _tokens(tar_key), _tokens(tar_sel),
                         self.cfg.top_k)
        readout = readout.transpose(1, 2).reshape(1, o_pad, -1, hq, wq)
        _, _, prob = self.model.segment(tar_ms, readout, sensory,
                                        src_mask[None], selector=selector,
                                        update_sensory=False)
        return prob[0, :o + 1].cpu().numpy()

    def vote_in_temporary_buffer(self, keyframe_selection: str = "first",
                                 precomputed_proj=None):
        """In-clip consensus over the buffered frames (inference/consensus.py).
        Returns (keyframe ti, consensus id mask, its ObjectInfos)."""
        return find_consensus_auto_association(
            self.frame_buffer, self, keyframe_selection=keyframe_selection,
            precomputed_proj=precomputed_proj)

    @torch.no_grad()
    def incorporate_detection(self, image, new_mask: np.ndarray,
                              segments_info: List[ObjectInfo], *,
                              image_ti_override: Optional[int] = None,
                              forward_mask: Optional[np.ndarray] = None,
                              incremental: bool = False) -> torch.Tensor:
        """Merge an image-level detection mask (real ids, [H, W]) into the
        propagated state. forward_mask, if given, is the forward prediction
        in tmp ids in unpadded space; otherwise the core predicts it (when
        its memory is engaged). Returns aggregated logits [1 + num_obj, H,
        W] on the core's device, unpadded."""
        self.curr_ti += 1
        image_ti = self.curr_ti if image_ti_override is None else \
            image_ti_override
        image, self.pad = self._image_nchw(image)
        lw, uw, lh, uh = self.pad
        new_mask = np.pad(np.asarray(new_mask), ((lh, uh), (lw, uw)))

        ms_features, key, shrinkage, selection = \
            self.image_feature_store.get_features(image_ti, image)
        if self.memory is None:
            self._ensure_capacity()

        if forward_mask is None:
            if self.memory.engaged:
                prob = self._segment(key, shrinkage, selection, ms_features)
                forward_mask = argmax_ids(
                    prob[:self.object_manager.num_obj + 1])
            else:
                forward_mask = np.zeros_like(new_mask)
        else:
            forward_mask = np.asarray(forward_mask)
            if forward_mask.shape != new_mask.shape:
                forward_mask = np.pad(forward_mask, ((lh, uh), (lw, uw)))

        merged = match_and_merge(forward_mask, new_mask, self.object_manager,
                                 segments_info,
                                 max_num_objects=self.cfg.max_num_objects,
                                 incremental_mode=incremental)

        purged, tmp_keep, obj_keep = \
            self.object_manager.purge_inactive_objects(
                self.cfg.max_missed_detection_count)
        if purged:
            self.memory.purge_except(obj_keep)
            rows = [t - 1 for t in tmp_keep]
            merged = merged[rows]
            if self.memory.sensory is not None:
                # the kept rows first, in order; zeros after. An object that
                # match_and_merge added in this frame may have a row beyond
                # the sensory's: it reads the last row, as deva_tpu's gather
                # clamps (its jnp indexing, core.py:595-603)
                keep = torch.as_tensor(rows + [0] * (self.o_cap - len(rows)),
                                       device=self.device)
                keep = keep.clamp(max=self.memory.sensory.shape[0] - 1)
                kept = (torch.arange(self.o_cap, device=self.device)
                        < len(rows))[:, None, None, None]
                self.memory.sensory = torch.where(
                    kept, self.memory.sensory[keep], 0.0)

        self._ensure_capacity()
        merged = torch.from_numpy(merged).to(self.device)
        self.last_mask = self._pad_objects(merged)
        self._add_memory(image, ms_features, self.last_mask, key, shrinkage,
                         selection)
        self.image_feature_store.delete(image_ti)
        return unpad(aggregate_logits(merged, axis=0), self.pad, -2, -1)

    # -- online/semi-online buffering ---------------------------------------

    def add_to_temporary_buffer(self, frame_info) -> None:
        self.frame_buffer.append(frame_info)

    def clear_buffer(self) -> None:
        for f in self.frame_buffer:
            self.image_feature_store.delete(f.ti)
        self.frame_buffer = []
