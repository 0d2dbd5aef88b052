"""Fused per-frame propagation step.

Port of deva_tpu/inference/fused_step.py (`FusedStepper`). It runs the hot
path of a plain propagation frame (no input mask, one working-memory bucket
in identity row order, an optional long-term ring) as one straight body:

    pad -> encode -> key projection -> attention over the rings -> decode
    -> (on a memory frame) encode the mask and append a frame of tokens

with the same sub-functions as the composed path in inference/core.py. The
attention takes deva_tpu's FusedStepper(use_pallas=True) route for the
configured top-k method (config.InferenceConfig): exact through
attention_kernels.attend_topk, approx through
approx_kernels.attend_approx{,_multi}; the hand-written kernels on a CUDA
device, their plain twins on the CPU.

Where deva_tpu donates the ring buffers to its jitted step, this port writes
the new tokens into the rings in place (Bucket.append, which rounds them to
the ring dtype, as deva_tpu's fused_step.py:198-205,409-417 casts them) and
adds the usage counts in place. The model's features are in its compute
dtype; the readout, the probabilities, last_mask and the sensory carry are
f32 in every configuration.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from reference.config import resolve_topk_method
from reference.inference.memory import (Bucket, count_usage,
                                             valid_mask)
from reference.models.network import DEVANetwork
from reference.ops.approx_kernels import (attend_approx,
                                               attend_approx_multi)
from reference.ops.attention_kernels import attend_topk
from reference.ops.pad import pad_amounts


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> token-major [B*h*w, C] (frame-major rows),
    contiguous as the kernels take it."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1]).contiguous()


class FusedStepper:
    def __init__(self, model: DEVANetwork, top_k: int,
                 topk_method: str = "auto"):
        self.model = model
        self.top_k = top_k
        self.approx = resolve_topk_method(topk_method) == "approx"

    # -- attention ------------------------------------------------------------

    def _attend(self, key, shr, value, valid, qk, qe, want_usage: bool):
        """Top-k attention over one ring -> [O, Q, Cv] (and usage [N])."""
        attend = attend_approx if self.approx else attend_topk
        return attend(key, shr, value, qk, qe, self.top_k, valid,
                      return_usage=want_usage)

    def _attend_rings(self, qk, qe, bucket: Bucket, lt: Optional[Bucket],
                      use_lt: bool, work_usage: bool):
        """Attention over the rings for one frame's query rows. Returns
        (rd [O, Q, Cv], work usage | None, lt usage | None)."""
        dev = qk.device
        work_valid = valid_mask(bucket.cap, bucket.size, dev)
        if use_lt:
            lt_valid = valid_mask(lt.cap, lt.size, dev)
            if self.approx:
                rd, (lt_usage, work_u) = attend_approx_multi(
                    [(lt.key, lt.shrinkage, lt.value, lt_valid),
                     (bucket.key, bucket.shrinkage, bucket.value,
                      work_valid)], qk, qe, self.top_k, return_usage=True)
            else:
                # the value rings are read in place (two segments); the
                # keys, shrinkage and validity are concatenated for sim_topk
                rd, usage = attend_topk(
                    torch.cat([lt.key, bucket.key]),
                    torch.cat([lt.shrinkage, bucket.shrinkage]),
                    (lt.value, bucket.value), qk, qe, self.top_k,
                    torch.cat([lt_valid, work_valid]), return_usage=True)
                lt_usage, work_u = usage[:lt.cap], usage[lt.cap:]
            return rd, work_u, lt_usage
        if work_usage:
            rd, work_u = self._attend(bucket.key, bucket.shrinkage,
                                      bucket.value, work_valid, qk, qe, True)
            return rd, work_u, None
        return self._attend(bucket.key, bucket.shrinkage, bucket.value,
                            work_valid, qk, qe, False), None, None

    def _attend_and_count(self, qk, qe, bucket, lt, use_lt: bool,
                          work_usage: bool, count_lt_usage: bool):
        """_attend_rings plus the frame's in-place usage counts."""
        rd, work_u, lt_u = self._attend_rings(qk, qe, bucket, lt, use_lt,
                                              work_usage)
        if work_usage:
            count_usage(bucket, work_u,
                        valid_mask(bucket.cap, bucket.size, qk.device), 1)
        if use_lt and count_lt_usage:
            count_usage(lt, lt_u, valid_mask(lt.cap, lt.size, qk.device), 1)
        return rd

    # -- the per-frame body ---------------------------------------------------

    def _decode(self, ms, rd, hq, wq, num_obj, sensory, last_mask,
                update_sensory: bool):
        """segment() on one frame's readout rd [O, Q, Cv] -> (prob [1+O, H,
        W], sensory [O, Cs, h, w])."""
        o_cap = sensory.shape[0]
        readout = rd.transpose(1, 2).reshape(1, o_cap, -1, hq, wq)
        selector = (torch.arange(o_cap, device=rd.device) <
                    num_obj).float()[None]
        new_sensory, _, prob = self.model.segment(
            ms, readout, sensory[None], last_mask[None], selector=selector,
            update_sensory=update_sensory)
        return prob[0], (new_sensory[0] if update_sensory else sensory)

    def _write(self, bucket, padded, f16, key, shrinkage, selection, sensory,
               last_mask):
        """A memory frame: encode its mask and append its tokens in place.
        padded [1, 3, H, W]; f16/key/... of that one frame. Returns the
        deep-updated sensory."""
        value, deep = self.model.encode_mask(padded, f16, sensory[None],
                                             last_mask[None],
                                             deep_update=True)
        o_cap = sensory.shape[0]
        bucket.append(_tokens(key), shrinkage.reshape(-1),
                      value[0].reshape(o_cap, value.shape[2], -1)
                      .permute(2, 0, 1),
                      _tokens(selection) if bucket.selection is not None
                      else None)
        return deep[0]

    def _step(self, image, num_obj, bucket, lt, sensory, last_mask, *,
              mem_write: bool, update_sensory: bool, use_lt: bool,
              work_usage: bool, count_lt_usage: bool):
        """One frame (deva_tpu's _raw_step). image [H, W, 3] on the device.
        Returns (prob [1 + O_cap, H, W] unpadded, sensory, last_mask)."""
        h, w = image.shape[:2]
        lw, uw, lh, uh = pad_amounts(h, w, 16)
        padded = F.pad(image.permute(2, 0, 1), (lw, uw, lh, uh))[None]
        ms, key_feat = self.model.encode_image(padded)
        key, shrinkage, selection = self.model.transform_key(key_feat)
        hq, wq = key.shape[2:]
        rd = self._attend_and_count(_tokens(key), _tokens(selection), bucket,
                                    lt, use_lt, work_usage, count_lt_usage)
        prob, sensory = self._decode(ms, rd, hq, wq, num_obj, sensory,
                                     last_mask, update_sensory)
        last_mask = prob[1:]
        if mem_write:
            sensory = self._write(bucket, padded, ms[0], key, shrinkage,
                                  selection, sensory, last_mask)
        return prob[:, lh:lh + h, lw:lw + w], sensory, last_mask

    def __call__(self, image, num_obj: int, bucket: Bucket,
                 lt: Optional[Bucket], sensory, last_mask, *,
                 mem_write: bool, update_sensory: bool, work_usage: bool,
                 count_lt_usage: bool):
        """Runs the fused step; writes into bucket/lt in place (a memory
        frame needs the capacity for one more frame). Returns (prob
        [1 + num_obj, H, W], new sensory, new last_mask)."""
        use_lt = lt is not None and lt.size > 0
        prob, sensory, last_mask = self._step(
            image, num_obj, bucket, lt, sensory, last_mask,
            mem_write=mem_write, update_sensory=update_sensory,
            use_lt=use_lt, work_usage=work_usage,
            count_lt_usage=count_lt_usage and use_lt)
        return prob[:num_obj + 1], sensory, last_mask
