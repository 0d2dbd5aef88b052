"""Fused per-frame propagation step and block stepping.

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
f32 in every configuration. The per-frame body makes no host
synchronisation (ring sizes and capacities are host integers), so a later
change can capture it as a CUDA graph. deva_tpu's lax.scan over a block's
read-only frames is a Python loop here.

Under object sharding (`shards=`, parallel/object_sharding.py) the sensory,
last_mask and the bucket's value columns are this process's object slots:
the attention reads the local value columns, `segment` aggregates over
every process's objects, and the probabilities returned to the caller are
gathered whole (the background from rank 0).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deva_tpu_torch.config import resolve_topk_method
from deva_tpu_torch.inference.memory import (Bucket, count_usage,
                                             valid_mask)
from deva_tpu_torch.models.network import DEVANetwork
from deva_tpu_torch.ops.approx_kernels import (attend_approx,
                                               attend_approx_multi)
from deva_tpu_torch.ops.attention_kernels import attend_topk
from deva_tpu_torch.ops.pad import pad_amounts
from deva_tpu_torch.parallel.object_sharding import ObjectShards
from deva_tpu_torch.utils import tracing


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> token-major [B*h*w, C] (frame-major rows),
    contiguous as the kernels take it."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1]).contiguous()


class FusedStepper:
    def __init__(self, model: DEVANetwork, top_k: int,
                 topk_method: str = "auto", preencode_blocks: bool = False,
                 shards: Optional[ObjectShards] = None):
        self.model = model
        self.shards = shards
        self.top_k = top_k
        self.approx = resolve_topk_method(topk_method) == "approx"
        # True: run_block encodes a block's frames as one batch and attends
        # with all their query rows at once (_run_preenc)
        self.preencode_blocks = preencode_blocks

    def _whole(self, prob):
        """A frame's probabilities [1 + O, H, W] as the caller takes them:
        gathered from every process's slots under sharding."""
        return prob if self.shards is None else self.shards.gather_prob(prob)

    # -- attention ------------------------------------------------------------

    def _attend(self, key, shr, value, valid, qk, qe, want_usage: bool):
        """Top-k attention over one ring -> [O, Q, Cv] (and usage [N])."""
        attend = attend_approx if self.approx else attend_topk
        return attend(key, shr, value, qk, qe, self.top_k, valid,
                      return_usage=want_usage)

    def _attend_rings(self, qk, qe, bucket: Bucket, lt: Optional[Bucket],
                      use_lt: bool, work_usage: bool):
        """Attention over the rings for any number of query rows (one
        frame's Q, or K frames' K*Q: the rings do not change within a
        block). Returns (rd [O, Q, Cv], work usage | None, lt usage |
        None)."""
        with tracing.span("deva.attention"):
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
                    # the value rings are read in place (two segments);
                    # the keys, shrinkage and validity are concatenated
                    # for sim_topk
                    rd, usage = attend_topk(
                        torch.cat([lt.key, bucket.key]),
                        torch.cat([lt.shrinkage, bucket.shrinkage]),
                        (lt.value, bucket.value), qk, qe, self.top_k,
                        torch.cat([lt_valid, work_valid]), return_usage=True)
                    lt_usage, work_u = usage[:lt.cap], usage[lt.cap:]
                return rd, work_u, lt_usage
            if work_usage:
                rd, work_u = self._attend(bucket.key, bucket.shrinkage,
                                          bucket.value, work_valid, qk, qe,
                                          True)
                return rd, work_u, None
            return self._attend(bucket.key, bucket.shrinkage, bucket.value,
                                work_valid, qk, qe, False), None, None

    def _attend_and_count(self, qk, qe, bucket, lt, use_lt: bool,
                          work_usage: bool, count_lt_usage: bool,
                          lives: int = 1):
        """_attend_rings plus the in-place usage counts of `lives` frames."""
        rd, work_u, lt_u = self._attend_rings(qk, qe, bucket, lt, use_lt,
                                              work_usage)
        if work_usage:
            count_usage(bucket, work_u,
                        valid_mask(bucket.cap, bucket.size, qk.device),
                        lives)
        if use_lt and count_lt_usage:
            count_usage(lt, lt_u, valid_mask(lt.cap, lt.size, qk.device),
                        lives)
        return rd

    # -- the per-frame body ---------------------------------------------------

    def _decode(self, ms, rd, hq, wq, num_obj, sensory, last_mask,
                update_sensory: bool):
        """segment() on one frame's readout rd [O, Q, Cv] -> (prob [1+O, H,
        W], sensory [O, Cs, h, w])."""
        o_cap = sensory.shape[0]  # this process's slots under sharding
        readout = rd.transpose(1, 2).reshape(1, o_cap, -1, hq, wq)
        lo = self.shards.rank * o_cap if self.shards is not None else 0
        selector = (torch.arange(lo, lo + o_cap, device=rd.device) <
                    num_obj).float()[None]
        new_sensory, _, prob = self.model.segment(
            ms, readout, sensory[None], last_mask[None], selector=selector,
            update_sensory=update_sensory,
            group=self.shards.group if self.shards is not None else None)
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
        return self._whole(prob)[:num_obj + 1], sensory, last_mask

    # -- multi-frame blocks ---------------------------------------------------

    def _run_preenc(self, frames, num_obj, bucket, lt, sensory, last_mask, *,
                    write_last: bool, use_lt: bool, work_usage: bool,
                    count_lt_usage: bool):
        """deva_tpu's _raw_block_preenc: the recurrence flows only through
        the decoder, so the K frames are encoded as one batch and attend
        with K*Q query rows in one call (exact: the rings do not change
        within a block, and usage is a sum over query rows); then a
        decode-only loop, and the write frame reuses its features."""
        k, h, w = frames.shape[:3]
        n_read = k - 1 if write_last else k
        lw, uw, lh, uh = pad_amounts(h, w, 16)
        padded = F.pad(frames.permute(0, 3, 1, 2), (lw, uw, lh, uh))
        ms, key_feat = self.model.encode_image(padded)
        key, shrinkage, selection = self.model.transform_key(key_feat)
        hq, wq = key.shape[2:]
        q = hq * wq
        rd = self._attend_and_count(_tokens(key), _tokens(selection), bucket,
                                    lt, use_lt, work_usage, count_lt_usage,
                                    lives=k)
        probs = []
        for i in range(k):
            ms_i = tuple(x[i:i + 1] for x in ms)
            prob, sensory = self._decode(ms_i, rd[:, i * q:(i + 1) * q], hq,
                                         wq, num_obj, sensory, last_mask,
                                         True)
            last_mask = prob[1:]
            probs.append(self._whole(prob))
        if write_last:
            i = n_read
            sensory = self._write(bucket, padded[i:i + 1], ms[0][i:i + 1],
                                  key[i:i + 1], shrinkage[i:i + 1],
                                  selection[i:i + 1], sensory, last_mask)
        probs = torch.stack(probs)[:, :, lh:lh + h, lw:lw + w]
        return probs, sensory, last_mask

    def run_block(self, frames, num_obj: int, bucket: Bucket,
                  lt: Optional[Bucket], sensory, last_mask, *,
                  write_last: bool, work_usage: bool, count_lt_usage: bool):
        """frames [K, H, W, 3] on the device; the first K-1 (or all K if not
        write_last) are read-only, the last one writes memory. Updates
        bucket/lt in place; returns (probs [K, 1+num_obj, H, W], sensory,
        last_mask)."""
        use_lt = lt is not None and lt.size > 0
        count_lt = count_lt_usage and use_lt
        if self.preencode_blocks:
            probs, sensory, last_mask = self._run_preenc(
                frames, num_obj, bucket, lt, sensory, last_mask,
                write_last=write_last, use_lt=use_lt, work_usage=work_usage,
                count_lt_usage=count_lt)
            return probs[:, :num_obj + 1], sensory, last_mask
        k = frames.shape[0]
        probs = []
        for i in range(k):
            prob, sensory, last_mask = self._step(
                frames[i], num_obj, bucket, lt, sensory, last_mask,
                mem_write=write_last and i == k - 1, update_sensory=True,
                use_lt=use_lt, work_usage=work_usage, count_lt_usage=count_lt)
            probs.append(self._whole(prob)[:num_obj + 1])
        return torch.stack(probs), sensory, last_mask

    def run_chunk(self, frames, writes: Sequence[bool], num_obj: int,
                  bucket: Bucket, lt: Optional[Bucket], sensory, last_mask,
                  *, work_usage: bool, count_lt_usage: bool):
        """frames [K, H, W, 3]; writes [K] bool. Runs the chunk as memory-
        period blocks (a run of read-only frames plus at most one trailing
        write frame) through run_block. Updates bucket/lt in place; returns
        (probs [K, 1 + num_obj, H, W], sensory, last_mask)."""
        writes = np.asarray(writes, bool)
        k = len(writes)
        assert frames.shape[0] == k
        parts = []
        start = 0
        while start < k:
            later = np.nonzero(writes[start:])[0]
            stop = k if len(later) == 0 else start + int(later[0]) + 1
            p, sensory, last_mask = self.run_block(
                frames[start:stop], num_obj, bucket, lt, sensory, last_mask,
                write_last=len(later) > 0, work_usage=work_usage,
                count_lt_usage=count_lt_usage)
            parts.append(p)
            start = stop
        return torch.cat(parts), sensory, last_mask
