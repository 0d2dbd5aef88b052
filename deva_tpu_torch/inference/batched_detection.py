"""Lockstep multi-video stepping for multi-bucket videos (detection fusion
and mid-stream VOS), with long-term memory.

Port of deva_tpu/inference/batched_detection.py
(`BatchedDetectionPropagator`). Videos that fuse detections, or whose
ground-truth masks arrive mid-stream, hold multi-bucket memory: objects
first seen at different frames keep separate top-k normalisation sets. Their
plain propagation frames and the forward predictions of
`incorporate_detection` have no cross-video coupling, so they advance B
videos in lockstep, while consensus, match-and-merge and mask insertion run
on the per-video InferenceCores in between (attach / detach).

Each video's buckets are stacked into fixed-shape slot rings
[B, S, cap, ...] (S = the padded bucket count, `_slot_bucket`), the ring
dtype of the cores, usage counts in f32. Where deva_tpu loops over the slots
inside a vmap over the videos (S launches of each kernel per frame), the
port flattens the (video, slot) pairs into the kernels' video axis: one
launch of each kernel of the configured top-k method per lockstep frame for
all B*S pairs, each pair with its own top-k set, as deva_tpu's per-slot
call. The queries are shared by a video's slots and repeated per pair
(the kernels take contiguous operands). An empty slot attends a one-token
floor and contributes zero rows; usage accrues only on valid tokens. The
pairs' readouts [B*S, o_slot, Q, Cv], masked to each bucket's real rows, are
added into the object rows [B, o_cap, Q, Cv] with one index_add_.

Long-term memory stacks the same way ([B, S, lcap, ...], per-pair sizes).
Every read attends [long-term ; working] per pair: with the exact method
the keys, shrinkage and validity are concatenated for sim_topk and the value
rings are read in place as two segments; with the approx method the rings
are concatenated and attended as one ring, as deva_tpu's batched body calls
the single-ring attend_pallas_approx. Consolidation runs in lockstep over
the (video, slot) pairs that hit the trigger: sizes advance in whole-frame
quanta, so every triggered pair sits at the same size and the prototype
windows stack (memory.consolidate_prototypes_batched).

Memory-write schedules may diverge across the batch (a detection or a mask
resets that video's cadence): per-video curr_ti / last_mem_ti clocks drive
masked writes. Every video writes its tokens at its own cursor; only writers
advance their sizes and take the deep-updated sensory, so a non-writer's
tokens lie beyond its size, invalid, until its next real write overwrites
them. A core with no objects rides along as an empty lane (zero-size rings,
fresh zero sensory) and is restored untouched but for its clocks.

Ring sizes are host integers, as in deva_tpu. Not ported: deva_tpu's
`_pack_call` / `_unpack_call` / `_fns` / `_donation` / `_jit_kwargs` (XLA
dispatch-count, donation and compile-cache devices: here attach and detach
are plain indexed copies into one preallocated tensor per stacked array).
The propagator runs on its model's device: on a CUDA device the kernels
launch, on the CPU their plain twins run.

Video sharding (`mesh=`, deva_tpu/inference/batched_detection.py:62-108):
each process of the mesh's 'data' axis attaches and steps its own share of
the group's cores (the caller runs their host code: consensus and
incorporate_detection) and returns their outputs. The stacked shapes (the
object pad, slot count and width, ring and long-term capacities, the
alignment's object pad) and the group-wide write and growth decisions are
taken from integers all-reduced over the group, so each (video, slot) pair
steps as in the unsharded group of all the cores. A process whose cores
are all empty lanes takes the shapes from the others.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.batched import BatchedPropagator, _tokens
from deva_tpu_torch.inference.core import InferenceCore, frames_to_device
from deva_tpu_torch.inference.memory import (LongTermBucket, _round_up,
                                             consolidate_prototypes_batched)
from deva_tpu_torch.models.network import DEVANetwork
from deva_tpu_torch.ops import memory_attention as ma
from deva_tpu_torch.ops.aggregate import argmax_ids
from deva_tpu_torch.ops.approx_kernels import attend_approx
from deva_tpu_torch.ops.attention_kernels import attend_topk
from deva_tpu_torch.ops.pad import pad_amounts
from deva_tpu_torch.parallel.mesh import (axis_group, check_even_share,
                                          group_max)
from deva_tpu_torch.utils import tracing

# ring dtypes as the group agrees on them
_DTYPES = (torch.float32, torch.bfloat16)


def _slot_bucket(n: int) -> int:
    for b in (1, 2, 4, 8, 16, 32):
        if n <= b:
            return b
    return n


def _fit(a: torch.Tensor, cap: int) -> torch.Tensor:
    """A new tensor of `cap` rows: a's first rows, zeros after (the stacked
    capacity and a bucket's own may differ either way)."""
    out = a.new_zeros((cap,) + tuple(a.shape[1:]))
    n = min(cap, a.shape[0])
    out[:n] = a[:n]
    return out


def _grow_axis2(t: torch.Tensor, new_cap: int) -> torch.Tensor:
    """Zero-pad the token axis (axis 2) of a stacked slot ring to new_cap."""
    out = t.new_zeros(t.shape[:2] + (new_cap,) + t.shape[3:])
    out[:, :, :t.shape[2]] = t
    return out


class BatchedDetectionPropagator:
    # the stacked working rings (sel, use_cnt and life_cnt only with
    # long-term memory) and the long-term rings
    _WORK = ("key", "shr", "sel", "value", "use_cnt", "life_cnt")
    _LONG = ("lt_key", "lt_shr", "lt_value", "lt_use", "lt_life")

    def __init__(self, model: DEVANetwork, config: InferenceConfig,
                 mesh=None):
        """mesh: a ('data', 'model') mesh; the videos shard over 'data'
        (see the module note)."""
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.cfg = config
        self.use_lt = config.enable_long_term
        self.count_lt_usage = (config.enable_long_term and
                               config.enable_long_term_count_usage)
        self.approx = config.resolve_topk_method() == "approx"
        self._group = axis_group(mesh, "data")[0] if mesh is not None \
            else None

    # -- stacking -------------------------------------------------------------

    @torch.no_grad()
    def attach(self, cores: Sequence[InferenceCore]) -> None:
        """Stack the cores' multi-bucket state. The cores share one padded
        resolution, model dims and ring dtype. A core that is not engaged
        (its detections have all come up empty, or every object was purged)
        rides along as an empty lane; detach restores only its clocks."""
        self.cores = list(cores)
        b = len(cores)
        assert b > 0
        check_even_share(self._group, b)
        eng = [c.memory is not None and c.memory.engaged for c in cores]
        self._engaged = eng
        engaged = [c for c, e in zip(cores, eng) if e]
        ref = engaged[0] if engaged else None
        ref_ring = next(iter(ref.memory.buckets.values())).key if ref \
            else None
        for c in engaged:
            assert c.memory.use_long_term == self.use_lt
            # the stacked state advances in one hw quantum: a core with
            # another padded resolution, dims or ring dtype cannot join
            assert c.memory.hw == ref.memory.hw, \
                "all videos in a batch must share the padded resolution"
            assert (c.memory.ck, c.memory.cv) == (ref.memory.ck,
                                                  ref.memory.cv)
            assert next(iter(c.memory.buckets.values())).key.dtype == \
                ref_ring.dtype, "all videos in a batch must share the ring " \
                "dtype"
        # the stacked shapes over the whole group (a process whose cores
        # are all empty lanes contributes zeros)
        buckets = [bk for c in engaged for bk in c.memory.buckets.values()]
        lts = [lt for c in engaged for lt in c.memory.long_buckets.values()]
        shape = [int(ref is not None), max(c.o_cap for c in cores),
                 max((len(c.memory.buckets) for c in engaged), default=0),
                 max((bk.o_cap for bk in buckets), default=0),
                 max((bk.cap for bk in buckets), default=0),
                 max((lt.cap for lt in lts), default=0)]
        if ref is not None:
            shape += [ref.memory.hw, ref.memory.ck, ref.memory.cv,
                      _DTYPES.index(ref_ring.dtype),
                      *ref.memory.sensory.shape[1:], *ref.last_mask.shape[1:]]
        else:
            shape += [0] * 9
        (any_eng, o_cap, n_buckets, o_slot, cap, lt_cap, hw, ck, cv, dti,
         *tails) = group_max(self._group, *shape)
        assert any_eng, (
            "attach needs at least one engaged video to define the stacked "
            "shapes; step all-empty groups per-core instead")
        if ref is not None:
            assert [hw, ck, cv, dti] == shape[6:10], \
                "all videos in a batch must share the padded resolution, " \
                "dims and ring dtype"
        self.o_cap = max(o_cap, 1)
        s = _slot_bucket(n_buckets)
        self.n_slots = s
        self.o_slot = o_slot
        self.hw = hw
        cap = _round_up(cap, self.hw)
        self._ck, self._cv = ck, cv
        dt = _DTYPES[dti]
        self._ring_dtype = dt
        dev = self.device

        def z(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.key, self.shr = z(b, s, cap, ck), z(b, s, cap)
        self.value = z(b, s, cap, self.o_slot, cv)
        self.sel = self.use_cnt = self.life_cnt = None
        if self.use_lt:
            self.sel = z(b, s, cap, ck)
            self.use_cnt = z(b, s, cap, dtype=torch.float32)
            self.life_cnt = z(b, s, cap, dtype=torch.float32)
        self.sizes = np.zeros((b, s), np.int64)
        self.rowcnt = np.zeros((b, s), np.int64)
        rowmaps = np.zeros((b, s, self.o_slot), np.int64)
        self._slot_bids: List[List[int]] = []
        self.lt_sizes = np.zeros((b, s), np.int64)
        if self.use_lt:
            lcap = _round_up(max(self.cfg.num_prototypes, lt_cap),
                             self.cfg.num_prototypes)
            self.lt_key, self.lt_shr = z(b, s, lcap, ck), z(b, s, lcap)
            self.lt_value = z(b, s, lcap, self.o_slot, cv)
            self.lt_use = z(b, s, lcap, dtype=torch.float32)
            self.lt_life = z(b, s, lcap, dtype=torch.float32)
        sen_tail, lm_tail = tails[:3], tails[3:]
        # an empty lane keeps fresh zero state at the batch's shapes (a
        # purged core's stale sensory and last_mask must not leak in); both
        # are f32 in every configuration
        self.sensory = torch.zeros((b, self.o_cap) + tuple(sen_tail),
                                   device=dev)
        self.last_mask = torch.zeros((b, self.o_cap) + tuple(lm_tail),
                                     device=dev)
        nobj = []
        for vi, c in enumerate(cores):
            bids = sorted(c.memory.buckets) if eng[vi] else []
            self._slot_bids.append(bids)
            nobj.append(c.object_manager.num_obj if eng[vi] else 0)
            if not eng[vi]:
                continue
            obj_rows = {o.id: t - 1
                        for o, t in c.object_manager.obj_to_tmp_id.items()}
            for si, bid in enumerate(bids):
                bk = c.memory.buckets[bid]
                n, bo = bk.cap, bk.o_cap
                self.key[vi, si, :n] = bk.key
                self.shr[vi, si, :n] = bk.shrinkage
                self.value[vi, si, :n, :bo] = bk.value
                if self.use_lt:
                    self.sel[vi, si, :n] = bk.selection
                    self.use_cnt[vi, si, :n] = bk.use_cnt
                    self.life_cnt[vi, si, :n] = bk.life_cnt
                    lt = c.memory.long_buckets.get(bid)
                    if lt is not None:
                        m = lt.cap
                        self.lt_key[vi, si, :m] = lt.key
                        self.lt_shr[vi, si, :m] = lt.shrinkage
                        self.lt_value[vi, si, :m, :lt.o_cap] = lt.value
                        if lt.use_cnt is not None:
                            self.lt_use[vi, si, :m] = lt.use_cnt
                            self.lt_life[vi, si, :m] = lt.life_cnt
                        self.lt_sizes[vi, si] = lt.size
                self.sizes[vi, si] = bk.size
                self.rowcnt[vi, si] = len(bk.obj_ids)
                rowmaps[vi, si, :len(bk.obj_ids)] = [obj_rows[o]
                                                     for o in bk.obj_ids]
            self.sensory[vi, :c.memory.sensory.shape[0]] = c.memory.sensory
            self.last_mask[vi, :c.last_mask.shape[0]] = c.last_mask
        self.num_obj = np.asarray(nobj, np.int64)
        self.selector = (torch.arange(self.o_cap)[None, :] <
                         torch.as_tensor(self.num_obj)[:, None]).float() \
            .to(dev)
        self.rowmaps = torch.as_tensor(rowmaps, device=dev)
        # the pairs' real object rows, and their global rows in [B * o_cap]
        self._row_ok = (torch.arange(self.o_slot)[None, None, :] <
                        torch.as_tensor(self.rowcnt)[:, :, None]).to(dev)
        self._flat_rows = (self.rowmaps + self.o_cap * torch.arange(
            b, device=dev)[:, None, None]).reshape(-1)
        self._masks = None  # the validity masks, rebuilt when sizes change
        # per-video frame clocks: videos may join at different times and
        # reset their memory cadence independently (a mid-stream mask forces
        # a write), so neither clock is uniform across the batch
        self.curr_ti = np.asarray([c.curr_ti for c in cores], np.int64)
        self.last_mem_ti = np.asarray([c.last_mem_ti for c in cores],
                                      np.int64)

    @torch.no_grad()
    def detach(self) -> None:
        """Write the advanced stacked state back into the per-video cores
        (so consensus and incorporate_detection run the single-video code),
        then release the stacked rings."""
        for vi, c in enumerate(self.cores):
            c.curr_ti = int(self.curr_ti[vi])
            c.last_mem_ti = int(self.last_mem_ti[vi])
            if not self._engaged[vi]:
                # empty lane: its (absent) memory, sensory and last_mask stay
                # untouched, so a later detection engages it from clean state
                continue
            for si, bid in enumerate(self._slot_bids[vi]):
                bk = c.memory.buckets[bid]
                need = int(self.sizes[vi, si])
                # plan (not ensure): the rings are replaced below anyway
                cap = bk.plan_capacity(
                    need - bk.size, self.hw,
                    limit=c.memory.max_work_tokens if self.use_lt else None) \
                    if need > bk.cap else bk.cap
                bk.key = _fit(self.key[vi, si], cap)
                bk.shrinkage = _fit(self.shr[vi, si], cap)
                bk.value = _fit(self.value[vi, si, :, :bk.o_cap], cap)
                bk.size = need
                if not self.use_lt:
                    continue
                bk.selection = _fit(self.sel[vi, si], cap)
                bk.use_cnt = _fit(self.use_cnt[vi, si], cap)
                bk.life_cnt = _fit(self.life_cnt[vi, si], cap)
                lt_size = int(self.lt_sizes[vi, si])
                lt = c.memory.long_buckets.get(bid)
                p = self.cfg.num_prototypes
                if lt is None and lt_size > 0:
                    # consolidated while attached
                    lt = LongTermBucket(bk.obj_ids, bk.o_cap,
                                        _round_up(lt_size, p), self._ck,
                                        self._cv,
                                        save_usage=self.count_lt_usage,
                                        dtype=self._ring_dtype,
                                        device=self.device)
                    c.memory.long_buckets[bid] = lt
                if lt is None:
                    continue
                lcap = lt.cap if lt_size <= lt.cap else _round_up(lt_size, p)
                lt.key = _fit(self.lt_key[vi, si], lcap)
                lt.shrinkage = _fit(self.lt_shr[vi, si], lcap)
                lt.value = _fit(self.lt_value[vi, si, :, :lt.o_cap], lcap)
                if lt.use_cnt is not None:
                    lt.use_cnt = _fit(self.lt_use[vi, si], lcap)
                    lt.life_cnt = _fit(self.lt_life[vi, si], lcap)
                lt.size = lt_size
            c.memory.update_sensory(self.sensory[vi, :c.o_cap].clone())
            c.last_mask = self.last_mask[vi, :c.o_cap].clone()
        for name in self._WORK + self._LONG + ("sensory", "last_mask"):
            setattr(self, name, None)
        self._masks = None

    # -- the per-frame body ---------------------------------------------------

    def _validity(self):
        """(floor, work, lt) validity [B*S, ...] of the pairs: the working
        ring with a one-token floor (what attention reads: an empty slot
        attends one zero token, NaN-free), the working ring's real tokens
        (where usage accrues) and the long-term ring (None without
        long-term memory). Rebuilt only when the sizes change."""
        if self._masks is None:
            dev = self.device
            sizes = torch.as_tensor(self.sizes.reshape(-1), device=dev)
            pos = torch.arange(self.key.shape[2], device=dev)[None]
            work = pos < sizes[:, None]
            floor = pos < sizes.clamp(min=1)[:, None]
            lt = None
            if self.use_lt:
                lt_sizes = torch.as_tensor(self.lt_sizes.reshape(-1),
                                           device=dev)
                lt = torch.arange(self.lt_key.shape[2],
                                  device=dev)[None] < lt_sizes[:, None]
            self._masks = (floor, work, lt)
        return self._masks

    def _attend(self, qk: torch.Tensor, qe: torch.Tensor) -> torch.Tensor:
        """Attention of every (video, slot) pair's queries over its rings:
        one launch of each kernel of the method for all B*S pairs, and the
        usage counts in place. qk/qe [B, Q, Ck]. Returns the readout added
        into the object rows, [B, o_cap, Q, Cv] f32."""
        with tracing.span("deva.attention"):
            b, s, cap, ck = self.key.shape
            p, o_slot, cv = b * s, self.o_slot, self._cv
            q = qk.shape[1]
            floor, work, lt_valid = self._validity()
            # the pairs' queries, materialised: the kernels take contiguous
            # operands, and a video's slots share its queries
            qk_p = qk.repeat_interleave(s, 0)
            qe_p = qe.repeat_interleave(s, 0)
            key = self.key.view(p, cap, ck)
            shr = self.shr.view(p, cap)
            value = self.value.view(p, cap, o_slot, cv)
            top_k = self.cfg.top_k
            if self.use_lt:
                lcap = self.lt_key.shape[2]
                mk = torch.cat([self.lt_key.view(p, lcap, ck), key], 1)
                ms = torch.cat([self.lt_shr.view(p, lcap), shr], 1)
                valid = torch.cat([lt_valid, floor], 1)
                lt_value = self.lt_value.view(p, lcap, o_slot, cv)
                if self.approx:
                    # deva_tpu's batched body attends the concatenated ring
                    # with the single-ring attend_pallas_approx
                    rd, usage = attend_approx(mk, ms, torch.cat(
                        [lt_value, value], 1), qk_p, qe_p, top_k, valid,
                        return_usage=True)
                else:
                    # the value rings are read in place as two segments
                    rd, usage = attend_topk(mk, ms, (lt_value, value), qk_p,
                                            qe_p, top_k, valid,
                                            return_usage=True)
                shape = (b, s, cap)
                self.use_cnt += torch.where(work, usage[:, lcap:], 0.0) \
                    .view(shape)
                self.life_cnt += work.float().view(shape)
                if self.count_lt_usage:
                    shape = (b, s, lcap)
                    self.lt_use += torch.where(lt_valid, usage[:, :lcap],
                                               0.0).view(shape)
                    self.lt_life += lt_valid.float().view(shape)
            else:
                attend = attend_approx if self.approx else attend_topk
                rd = attend(key, shr, value, qk_p, qe_p, top_k, floor)
            # each pair's real rows into its video's object rows; padded rowmap
            # entries carry zero rows
            rd = rd.masked_fill_(~self._row_ok.view(p, o_slot, 1, 1), 0.0)
            out = torch.zeros((b * self.o_cap, q, cv), dtype=torch.float32,
                              device=qk.device)
            out.index_add_(0, self._flat_rows, rd.reshape(p * o_slot, q, cv))
            return out.view(b, self.o_cap, q, cv)

    def _write(self, key, shrinkage, qe, value) -> None:
        """A memory frame: every pair writes one frame of tokens at its own
        cursor (deva_tpu's masked write: a non-writer's tokens lie beyond its
        size). key [B, Ck, h, w], shrinkage [B, 1, h, w], qe [B, Q, Ck],
        value [B, o_cap, Cv, h, w]."""
        b, s = self.sizes.shape
        q = key.shape[2] * key.shape[3]
        dev = key.device
        dt = self._ring_dtype
        at = torch.as_tensor(self.sizes, device=dev)[:, :, None] + \
            torch.arange(q, device=dev)
        vi = torch.arange(b, device=dev)[:, None, None]
        si = torch.arange(s, device=dev)[None, :, None]
        # each pair's rows of the frame's values, token-major
        vals = value.reshape(b, self.o_cap, self._cv, q)[vi, self.rowmaps]
        vals = vals.masked_fill_(~self._row_ok[..., None, None], 0.0)
        self.value[vi, si, at] = vals.permute(0, 1, 4, 2, 3).to(dt)
        self.key[vi, si, at] = _tokens(key)[:, None].to(dt) \
            .expand(b, s, q, self._ck)
        self.shr[vi, si, at] = shrinkage.flatten(1)[:, None].to(dt) \
            .expand(b, s, q)
        if self.use_lt:
            self.sel[vi, si, at] = qe[:, None].to(dt).expand(b, s, q,
                                                            self._ck)
            self.use_cnt[vi, si, at] = 0.0
            self.life_cnt[vi, si, at] = 1e-7

    def _body(self, images, *, mem_write: bool, update_sensory: bool,
              do_write: Optional[torch.Tensor]):
        """One lockstep frame of every video (deva_tpu's _body, vmapped).
        images [B, H, W, 3] on the device; do_write [B] bool gates the deep
        sensory update of a masked write (None: every video writes).
        Returns (prob [B, 1 + o_cap, H, W] unpadded, sensory, last_mask)."""
        b, h, w = images.shape[:3]
        lw, uw, lh, uh = pad_amounts(h, w, 16)
        padded = F.pad(images.permute(0, 3, 1, 2), (lw, uw, lh, uh))
        ms, key_feat = self.model.encode_image(padded)
        key, shrinkage, selection = self.model.transform_key(key_feat)
        hq, wq = key.shape[2:]
        qe = _tokens(selection)
        rd = self._attend(_tokens(key), qe)
        readout = rd.transpose(2, 3).reshape(b, self.o_cap, -1, hq, wq)
        new_sensory, _, prob = self.model.segment(
            ms, readout, self.sensory, self.last_mask, selector=self.selector,
            update_sensory=update_sensory)
        if not update_sensory:
            new_sensory = self.sensory
        new_last_mask = prob[:, 1:]
        if mem_write:
            value, deep = self.model.encode_mask(padded, ms[0], new_sensory,
                                                 new_last_mask,
                                                 deep_update=True)
            # non-writers keep the shallow (post-segment) sensory: only
            # memory frames deep-update
            new_sensory = deep if do_write is None else torch.where(
                do_write[:, None, None, None, None], deep, new_sensory)
            self._write(key, shrinkage, qe, value)
        return prob[:, :, lh:lh + h, lw:lw + w], new_sensory, new_last_mask

    # -- stepping -------------------------------------------------------------

    def _reserve(self, extra: int) -> None:
        """Room for `extra` more tokens at every pair's cursor (deva_tpu's
        policy: the exact need, rounded to whole frames)."""
        top, = group_max(self._group, int(self.sizes.max()))
        need = top + extra
        cap = self.key.shape[2]
        if need > cap:
            new_cap = _round_up(need, self.hw)
            for name in self._WORK:
                ring = getattr(self, name)
                if ring is not None:
                    setattr(self, name, _grow_axis2(ring, new_cap))
            self._masks = None

    def _images(self, frames) -> torch.Tensor:
        """B frames (a sequence of arrays or tensors, or one stacked array
        or tensor) -> one f32 tensor on the propagator's device."""
        return frames_to_device(frames, self.device)

    def _advance(self, writers: np.ndarray, hw: int) -> None:
        """Every real slot of every writing video received one frame."""
        self.sizes = self.sizes + hw * (writers[:, None] & (self.rowcnt > 0))
        self._masks = None

    def _launch(self, frames, mem_write: bool, update_sensory: bool,
                keep_last_mask: bool = True, write_mask=None):
        """write_mask: None (every video follows `mem_write`) or [B] bool
        writers (diverged cadences). Returns prob [B, 1 + o_cap, H, W]."""
        images = self._images(frames)
        hw = BatchedPropagator._frame_tokens(*images.shape[1:3])
        do_write = None if write_mask is None else \
            torch.as_tensor(np.asarray(write_mask), device=self.device)
        prob, self.sensory, last_mask = self._body(
            images, mem_write=mem_write, update_sensory=update_sensory,
            do_write=do_write)
        if keep_last_mask:
            self.last_mask = last_mask
        if mem_write:
            self._advance(np.ones(len(self.cores), bool) if write_mask is None
                          else np.asarray(write_mask), hw)
        return prob

    @torch.no_grad()
    def step_all(self, frames, end: bool = False) -> torch.Tensor:
        """One lockstep propagation frame for every video, with the semantics
        of each core's step(image, end=end). Videos whose memory cadences have
        diverged write through a masked write. Returns probabilities
        [B, 1 + o_cap, H, W] (video i's live channels first)."""
        self.curr_ti = self.curr_ti + 1
        is_mem = ((self.curr_ti - self.last_mem_ti >= self.cfg.mem_every)
                  & (not end))
        any_write = self._any_write(is_mem, frames)
        if is_mem.all() or not is_mem.any():
            probs = self._launch(frames, bool(is_mem.all()), not end)
        else:
            probs = self._launch(frames, True, not end, write_mask=is_mem)
        self.last_mem_ti = np.where(is_mem, self.curr_ti, self.last_mem_ti)
        if any_write:
            self._maybe_consolidate()
        return probs

    def _any_write(self, is_mem: np.ndarray, frames) -> bool:
        """Whether any video of the group writes this frame; if so, room
        for one more frame of tokens at every pair's cursor."""
        any_write = bool(group_max(self._group, int(is_mem.any()))[0])
        if any_write:
            h, w = np.shape(frames[0])[-3:-1]
            self._reserve(BatchedPropagator._frame_tokens(h, w))
        return any_write

    def plan_block(self, max_k: int) -> int:
        """The largest K <= max_k such that no video's memory write falls
        before the block's last frame."""
        nxt = self.last_mem_ti + self.cfg.mem_every - self.curr_ti
        return int(max(1, min(int(nxt.min()), max_k)))

    @torch.no_grad()
    def step_block(self, frames, end: bool = False) -> torch.Tensor:
        """Advance every video K frames (deva_tpu's scanned block: a loop of
        the per-frame body; the rings change only on the last frame, which
        may be a masked write). Use plan_block to choose K. frames:
        [B, K, H, W, 3] (or B arrays [K, H, W, 3]). end=True freezes sensory
        on the last frame, as step_all(end=True) does. Returns probabilities
        [B, K, 1 + o_cap, H, W]."""
        with tracing.step():
            frames = self._images(frames)
            k, h, w = frames.shape[1:4]
            for i in range(1, k):
                due = self.curr_ti + i - self.last_mem_ti >= self.cfg.mem_every
                assert not due.any(), \
                    "a mid-block frame would be a memory frame; use plan_block"
            self.curr_ti = self.curr_ti + k
            is_mem = ((self.curr_ti - self.last_mem_ti >= self.cfg.mem_every)
                      & (not end))
            write_last = bool(is_mem.any())
            masked = write_last and not is_mem.all()
            hw = BatchedPropagator._frame_tokens(h, w)
            any_write = self._any_write(is_mem, frames[:, 0])
            do_write = torch.as_tensor(is_mem, device=self.device) if masked \
                else None
            probs = []
            for i in range(k):
                last = i == k - 1
                prob, self.sensory, self.last_mask = self._body(
                    frames[:, i], mem_write=write_last and last,
                    update_sensory=not (end and last), do_write=do_write)
                probs.append(prob)
            if write_last:
                self._advance(is_mem, hw)
                self.last_mem_ti = np.where(is_mem, self.curr_ti,
                                            self.last_mem_ti)
            if any_write:
                self._maybe_consolidate()
            return torch.stack(probs, 1)

    @torch.no_grad()
    def forward_probs(self, frames) -> np.ndarray:
        """The forward prediction of every core's incorporate_detection
        (its `_segment`) in one lockstep frame: sensory updates, last_mask
        and the clocks do not advance. Run it before detach, so the sensory
        update reaches the cores. Returns [B, 1 + o_cap, H, W] on the
        host."""
        return self._launch(frames, False, True,
                            keep_last_mask=False).cpu().numpy()

    @torch.no_grad()
    def forward_ids(self, frames) -> np.ndarray:
        """forward_probs with the masked argmax on the device: id maps
        [B, H, W] uint8 (ids 0..num_obj[v], np.argmax of forward_probs(
        frames)[v][:num_obj[v] + 1] over the channels), one copy to the host
        to feed incorporate_detection(forward_mask=...)."""
        prob = self._launch(frames, False, True, keep_last_mask=False)
        assert self.o_cap < 255
        live = torch.arange(prob.shape[1], device=prob.device)[None, :] <= \
            torch.as_tensor(self.num_obj, device=prob.device)[:, None]
        return argmax_ids(torch.where(live[:, :, None, None], prob, -1.0),
                          dim=1)

    @torch.no_grad()
    def align_consensus_batched(self, cores: Sequence[InferenceCore],
                                keyframe_selection: str = "first"):
        """Every (video, non-keyframe voting frame) spatial alignment of the
        in-clip consensus in one batched call, with the masked argmax on the
        device. Per item the semantics of InferenceCore.spatial_alignment +
        np.argmax(proj, 0), up to the padded-channel softmax shift (the
        object pad is the batch's largest). Returns per-video dicts
        {frame index: id map [H, W] int64, padded domain} for
        vote_in_temporary_buffer(precomputed_proj=...).

        The one-hot masks are built on the device from int32 id masks and a
        per-item segment table padded with -1; each video's keyframe image
        goes up and is encoded once. Exact attention takes one launch of
        each exact kernel for all items; approx takes the dense threshold
        form per item, as spatial_alignment does."""
        dev = self.device
        per_video: List[Dict[int, np.ndarray]] = [dict() for _ in cores]
        items, tars = [], []
        for vi, c in enumerate(cores):
            frames = c.frame_buffer
            if not frames:
                continue
            if keyframe_selection == "last":
                ki = len(frames) - 1
            elif keyframe_selection == "first":
                ki = 0
            elif keyframe_selection == "middle":
                ki = (len(frames) + 1) // 2
            else:
                raise NotImplementedError(keyframe_selection)
            lw, uw, lh, uh = pad_amounts(*frames[0].image.shape[:2], 16)

            def pad_img(img):
                img = torch.as_tensor(img, dtype=torch.float32, device=dev)
                return F.pad(img.permute(2, 0, 1), (lw, uw, lh, uh))

            tar_idx = None
            for i, f in enumerate(frames):
                if i == ki or not f.segments_info:
                    continue
                if tar_idx is None:
                    tar_idx = len(tars)
                    tars.append(pad_img(frames[ki].image))
                m = np.pad(np.asarray(f.mask, np.int32),
                           ((lh, uh), (lw, uw)))
                items.append((vi, i, pad_img(f.image), tar_idx, m,
                              [seg.id for seg in f.segments_info]))
        # the object pad is the group's largest
        most, = group_max(self._group,
                          max((len(it[5]) for it in items), default=0))
        if not items:
            return per_video
        o_pad = self.cfg.pad_objects(most)
        assert o_pad < 255
        n_obj = torch.as_tensor([len(it[5]) for it in items], device=dev)
        src = torch.stack([it[2] for it in items])
        mask_ids = torch.as_tensor(np.stack([it[4] for it in items]),
                                   device=dev)
        # -1 never matches an id; channel order is segments_info's, as
        # find_consensus_auto_association reads it
        seg_tab = torch.as_tensor(np.stack([
            np.asarray(it[5] + [-1] * (o_pad - len(it[5])), np.int32)
            for it in items]), device=dev)
        src_mask = (mask_ids[:, None] == seg_tab[:, :, None, None]).float()
        tar_of = torch.as_tensor([it[3] for it in items], device=dev)
        src_ms, src_feat = self.model.encode_image(src)
        src_key, src_shr, _ = self.model.transform_key(src_feat)
        tar_ms, tar_feat = self.model.encode_image(torch.stack(tars))
        tar_key, _, tar_sel = self.model.transform_key(tar_feat)
        tar_ms = tuple(f[tar_of] for f in tar_ms)
        tar_key, tar_sel = tar_key[tar_of], tar_sel[tar_of]
        n, hq, wq = src_key.shape[0], src_key.shape[2], src_key.shape[3]
        cv = self.model.config.value_dim
        sensory = torch.zeros((n, o_pad, cv, hq, wq), device=dev)
        value, sensory = self.model.encode_mask(src, src_ms[0], sensory,
                                                src_mask, deep_update=True)
        mk, ms = _tokens(src_key), src_shr.flatten(1)
        if mk.dtype != ms.dtype:  # the kernels take one dtype for both
            mk, ms = mk.float(), ms.float()
        # token-major values [n, Q, o_pad, Cv]: a copy (value viewed
        # token-major is not contiguous)
        values = value.flatten(3).permute(0, 3, 1, 2).contiguous()
        qk, qe = _tokens(tar_key), _tokens(tar_sel)
        if self.approx:
            rd = torch.stack([ma.attend(
                mk[j], ms[j], values[j].transpose(0, 1), qk[j], qe[j],
                self.cfg.top_k, method="approx") for j in range(n)])
        else:
            rd = attend_topk(mk, ms, values, qk, qe, self.cfg.top_k)
        readout = rd.transpose(2, 3).reshape(n, o_pad, cv, hq, wq)
        selector = (torch.arange(o_pad, device=dev)[None] <
                    n_obj[:, None]).float()
        _, _, prob = self.model.segment(tar_ms, readout, sensory, src_mask,
                                        selector=selector,
                                        update_sensory=False)
        live = torch.arange(prob.shape[1], device=dev)[None] <= n_obj[:, None]
        ids = argmax_ids(torch.where(live[:, :, None, None], prob, -1.0),
                         dim=1)
        for j, (vi, i, *_rest) in enumerate(items):
            per_video[vi][i] = ids[j].astype(np.int64)
        return per_video

    # -- long-term consolidation (host-orchestrated, rare) --------------------

    def _maybe_consolidate(self) -> None:
        """Consolidate every (video, slot) pair whose working ring hit the
        trigger. Writes advance in whole-frame quanta and the check runs
        after every write, so every triggered pair sits at the same size and
        the candidate windows stack (MemoryEngine.maybe_consolidate,
        _compress and _evict_obsolete, with the prototype math batched over
        the triggered pairs)."""
        if not self.use_lt:
            return
        cfg = self.cfg
        hw = self.hw
        max_work = cfg.max_mid_term_frames * hw
        min_work = cfg.min_mid_term_frames * hw
        trig = [(vi, si)
                for vi in range(len(self.cores))
                for si in range(self.n_slots)
                if self.rowcnt[vi, si] > 0
                and self.sizes[vi, si] >= max_work
                and self.sizes[vi, si] > min_work + hw]
        # the long-term capacity the group's largest cursor needs after
        # this consolidation (0 where no pair triggers)
        p = min(cfg.num_prototypes,
                max(max_work, (cfg.min_mid_term_frames + 2) * hw) -
                min_work)
        top, = group_max(self._group, 
            max((int(self.lt_sizes[vi, si]) for vi, si in trig), default=-p)
            + p)
        if not trig:
            self._grow_long(top, p)
            return
        # every pair triggers at the same smallest qualifying size: the
        # min-size guard can delay the trigger past max_work when max_work
        # <= min_work + hw
        s_star = max(max_work, (cfg.min_mid_term_frames + 2) * hw)
        sizes = {int(self.sizes[vi, si]) for vi, si in trig}
        assert sizes == {s_star}, \
            f"triggered pairs must sit at {s_star} tokens, got {sizes}"

        # usage-based eviction for pairs whose long-term ring is at the cap
        limit = cfg.max_long_term_elements - cfg.num_prototypes
        evict = [(vi, si) for vi, si in trig
                 if self.lt_sizes[vi, si] >= limit]
        if evict:
            # without long-term usage counting every usage is 0, and the
            # strictly-greater threshold would evict the whole long-term
            # memory
            assert self.count_lt_usage, (
                "long-term memory saturated but enable_long_term_count_usage"
                " is False; enable it (the reference's long-video policy) so"
                " eviction has usage statistics to rank tokens by")
            self._evict_obsolete(evict, limit)

        size = s_star
        start, end = hw, size - min_work + hw
        dev = self.device
        vis = torch.as_tensor([vi for vi, _ in trig], device=dev)
        sis = torch.as_tensor([si for _, si in trig], device=dev)
        usage = self.use_cnt[vis, sis] / self.life_cnt[vis, sis]
        proto_key, proto_shr, proto_value = consolidate_prototypes_batched(
            self.key[vis, sis, start:end], self.shr[vis, sis, start:end],
            self.sel[vis, sis, start:end], self.value[vis, sis, start:end],
            usage[:, start:end], cfg.num_prototypes)

        # sieve the triggered pairs in place: keep [0:start] + [end:size]
        # (a permutation of their tokens: [start:end] moves beyond the size)
        cap = self.key.shape[2]
        order = torch.as_tensor(np.concatenate([
            np.arange(start), np.arange(end, size), np.arange(start, end),
            np.arange(size, cap)]), device=dev)
        for name in self._WORK:
            ring = getattr(self, name)
            ring[vis, sis] = ring[vis, sis][:, order]
        new_size = start + (size - end)
        for vi, si in trig:
            self.sizes[vi, si] = new_size

        # append the prototypes at each pair's long-term cursor, growing the
        # lazy capacity when the largest cursor needs it
        assert p == proto_key.shape[1]  # num_prototypes unless clamped
        self._grow_long(top, p)
        for i, (vi, si) in enumerate(trig):
            at = slice(int(self.lt_sizes[vi, si]),
                       int(self.lt_sizes[vi, si]) + p)
            self.lt_key[vi, si, at] = proto_key[i].to(self.lt_key.dtype)
            self.lt_shr[vi, si, at] = proto_shr[i].to(self.lt_shr.dtype)
            self.lt_value[vi, si, at] = proto_value[i].to(
                self.lt_value.dtype)
            self.lt_use[vi, si, at] = 0.0
            self.lt_life[vi, si, at] = 1e-7
            self.lt_sizes[vi, si] += p
        self._masks = None

    def _grow_long(self, top: int, p: int) -> None:
        """Grow the lazy long-term capacity, in quanta of p prototypes, to
        hold `top` tokens."""
        cfg = self.cfg
        lcap = self.lt_key.shape[2]
        if top > lcap:
            max_cap = _round_up(cfg.max_long_term_elements, p)
            new_cap = min(_round_up(max(lcap * 2, top), p), max_cap)
            for name in self._LONG:
                setattr(self, name, _grow_axis2(getattr(self, name),
                                                new_cap))

    def _evict_obsolete(self, pairs, max_size: int) -> None:
        """Per-(video, slot) usage eviction with upstream's strictly-greater
        threshold; survivors keep their order (a stable gather)."""
        lcap = self.lt_key.shape[2]
        lt_use = self.lt_use.cpu().numpy()
        lt_life = self.lt_life.cpu().numpy()
        for vi, si in pairs:
            n = int(self.lt_sizes[vi, si])
            k = n - max_size
            if k <= 0:
                continue
            usage = lt_use[vi, si, :n] / lt_life[vi, si, :n]
            thresh = np.partition(usage, k - 1)[k - 1]
            survived = usage > thresh
            order = torch.as_tensor(np.concatenate([
                np.nonzero(survived)[0], np.nonzero(~survived)[0],
                np.arange(n, lcap)]), device=self.device)
            for name in self._LONG:
                ring = getattr(self, name)
                ring[vi, si] = ring[vi, si][order]
            self.lt_sizes[vi, si] = int(survived.sum())
