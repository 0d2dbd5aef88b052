"""Batched multi-video propagation: B videos advance in lockstep, with one
batch-B model call per stage and one launch of each attention kernel of the
configured top-k method per lockstep frame.

Port of deva_tpu/inference/batched.py (`BatchedPropagator`). deva_tpu vmaps
its fused per-frame body over the videos; here the body is written out over
a leading video axis:

    pad -> encode_image / transform_key on [B, ...] -> attention over the
    stacked rings (the kernels' video grid axis, ops/attention_kernels.py
    and ops/approx_kernels.py) -> segment with a per-video object selector
    [B, O_cap] -> (on a memory frame) encode_mask on [B, ...] and one slice
    write at the shared working size

and the block body is a Python loop of it over K frames (deva_tpu's
lax.scan, with no ring carry: the rings change only on the block's last
frame). State lives in stacked fixed-capacity rings ([B, cap, ...]) in the
ring dtype, with usage counts in f32. The videos share one memory-write
schedule, so their working sizes stay equal and saturate together:
long-term consolidation runs in lockstep (the prototype selection and
potentiation batched over the videos), and prototypes append at each
video's own long-term offset. Eviction of obsolete long-term tokens is per
video, on the host, as in deva_tpu.

segment and encode_mask run on the live object slots only (each video's
first num_obj of its O_cap), packed, whenever some slots are padding;
padded slots keep their sensory state and get value 0 and probability 0
before the aggregate, as the selector gives them unpacked.

Ring sizes are host integers (numpy) and the long-term validity is a device
mask updated where the long-term sizes change, so a lockstep step makes no
host synchronisation; eviction frames read the usage counts, as deva_tpu's
do. New tokens are written into the rings in place (deva_tpu donates its
buffers). The propagator runs on its model's device: on a CUDA device the
kernels launch, on the CPU their plain twins run.

Videos shorter than the batch keep stepping harmlessly; callers discard
their outputs past the end (see evaluation/eval_vos_batched_torch.py).

Video sharding (`mesh=`, deva_tpu/inference/batched.py:41-71): a mesh from
parallel.mesh.make_mesh with a 'data' axis of D processes; each process
stacks and steps its own B/D videos (its share of the group, given to
initialize and step_all by the caller) and returns their outputs. The
per-video body has no cross-video term; the group-wide host decisions (the
shared o_cap and ring capacity, ring growth, whether long-term memory is
engaged, the long-term capacity) read integers that an all_reduce takes
over the whole group, so each video's outputs and rings equal those of the
unsharded group of all B videos.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.core import InferenceCore, frames_to_device
from deva_tpu_torch.inference.memory import (_round_up,
                                             consolidate_prototypes_batched)
from deva_tpu_torch.models.network import DEVANetwork, live_slots
from deva_tpu_torch.ops.approx_kernels import attend_approx_multi
from deva_tpu_torch.ops.attention_kernels import attend_topk
from deva_tpu_torch.ops.pad import pad_amounts
from deva_tpu_torch.parallel.mesh import (axis_group, check_even_share,
                                          group_max)
from deva_tpu_torch.utils import tracing


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> per-video token-major [B, h*w, C], contiguous as the
    kernels take it."""
    return x.flatten(2).transpose(1, 2).contiguous()


def _padded(t: torch.Tensor, shape) -> torch.Tensor:
    """t zero-padded at the end of each axis to `shape`."""
    out = t.new_zeros(tuple(shape))
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def _grow_tokens(t: torch.Tensor, new_cap: int) -> torch.Tensor:
    """Zero-pad the token axis (axis 1) of a stacked ring to new_cap."""
    return _padded(t, (t.shape[0], new_cap, *t.shape[2:]))


class BatchedPropagator:
    # the stacked working rings and their per-token counts (None when
    # long-term memory is off: no selection, no usage)
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

    @torch.no_grad()
    def initialize(self, images0: Sequence, masks0: Sequence,
                   objects: Sequence[List[int]]) -> None:
        """Consume each video's first frame and ground-truth mask through the
        single-video InferenceCore.step, then stack the resulting states.
        With a mesh, this process's videos."""
        with tracing.step():
            check_even_share(self._group, len(images0))
            self.cores = []
            o_cap = 0
            for img, mask, objs in zip(images0, masks0, objects):
                core = InferenceCore(self.model, self.cfg,
                                     device=self.device)
                core.step(img, mask, objects=list(objs))
                (_, bucket), = core.memory.buckets.items()
                o_cap = max(o_cap, bucket.o_cap)
                self.cores.append(core)
            # _stack pads every video's rings and slots to the shared
            # o_cap/cap
            o_cap, = group_max(self._group, o_cap)
            self._stack(o_cap)
            self._token_hw = int(self.sizes[0])  # tokens written per frame
            self.frame_idx = 0  # frames consumed after the first

    def _stack(self, o_cap: int) -> None:
        cfg = self.cfg
        buckets = [next(iter(c.memory.buckets.values())) for c in self.cores]
        cap, = group_max(self._group, max(b.cap for b in buckets))
        if self.use_lt:
            hw = buckets[0].size
            # consolidation triggers at size >= max_work AND size > min_work
            # + hw (upstream's min-size guard), so the ring must hold up to
            # max(max_work, min_work + 2*hw) tokens before it fires
            cap = max(cap, _round_up(
                max(cfg.max_mid_term_frames,
                    cfg.min_mid_term_frames + 2) * hw, hw))

        def stack(name, shape):
            return torch.stack([_padded(getattr(b, name), shape)
                                for b in buckets])

        ck, cv = buckets[0].key.shape[1], buckets[0].value.shape[2]
        self.key = stack("key", (cap, ck))
        self.shr = stack("shrinkage", (cap,))
        self.value = stack("value", (cap, o_cap, cv))
        if self.use_lt:
            self.sel = stack("selection", (cap, ck))
            self.use_cnt = stack("use_cnt", (cap,))
            self.life_cnt = stack("life_cnt", (cap,))
        else:
            self.sel = self.use_cnt = self.life_cnt = None
        self.sizes = np.asarray([b.size for b in buckets])
        sens = [c.memory.get_sensory() for c in self.cores]
        self.sensory = torch.stack([_padded(s, (o_cap, *s.shape[1:]))
                                    for s in sens])
        self.last_mask = torch.stack([
            _padded(c.last_mask, (o_cap, *c.last_mask.shape[1:]))
            for c in self.cores])
        self.num_obj = np.asarray([c.object_manager.num_obj
                                   for c in self.cores])
        b = len(self.cores)
        # the live object slots, which segment() and encode_mask() run on,
        # and the per-video object selector of segment(): [B, O_cap]
        self.live = live_slots(self.num_obj, o_cap, self.device)
        self.selector = torch.zeros(b * o_cap, device=self.device) \
            .index_fill_(0, self.live.index, 1.0).view(b, o_cap)
        self.o_cap = o_cap
        self.lt_sizes = np.zeros((b,), np.int64)
        if self.use_lt:
            # lazy long-term capacity, doubled on demand in
            # _maybe_consolidate: attention pays for the whole masked
            # capacity (MemoryEngine._compress's policy)
            lcap = _round_up(4 * cfg.num_prototypes, cfg.num_prototypes)
            z = lambda *shape, dt=self.key.dtype: torch.zeros(
                (b, lcap, *shape), dtype=dt, device=self.device)
            self.lt_key = z(ck)
            self.lt_shr = z()
            self.lt_value = z(o_cap, cv)
            self.lt_use = z(dt=torch.float32)
            self.lt_life = z(dt=torch.float32)
            # the long-term validity, kept beside lt_sizes
            self.lt_valid = z(dt=torch.bool)

    @property
    def _lt_engaged(self) -> bool:
        return self.use_lt and bool(
            group_max(self._group, int((self.lt_sizes > 0).any()))[0])

    # -- the per-frame body ---------------------------------------------------

    def _attend_and_count(self, qk, qe, lt_on: bool):
        """Attention of every video's queries over its rings, one launch of
        each kernel of the method for all B (deva_tpu's _attend_rings under
        vmap), and the in-place usage counts. Returns rd [B, O, Q, Cv]."""
        with tracing.span("deva.attention"):
            b, cap = self.key.shape[:2]
            size = int(self.sizes[0])  # equal in every video (lockstep)
            work_valid = (torch.arange(cap, device=qk.device) <
                          size).repeat(b, 1)
            top_k = self.cfg.top_k
            if lt_on:
                if self.approx:
                    rd, (lt_u, work_u) = attend_approx_multi(
                        [(self.lt_key, self.lt_shr, self.lt_value,
                          self.lt_valid),
                         (self.key, self.shr, self.value, work_valid)],
                        qk, qe, top_k, return_usage=True)
                else:
                    # the value rings are read in place (two segments);
                    # the keys, shrinkage and validity are concatenated
                    # for sim_topk
                    lcap = self.lt_key.shape[1]
                    rd, usage = attend_topk(
                        torch.cat([self.lt_key, self.key], 1),
                        torch.cat([self.lt_shr, self.shr], 1),
                        (self.lt_value, self.value), qk, qe, top_k,
                        torch.cat([self.lt_valid, work_valid], 1),
                        return_usage=True)
                    lt_u, work_u = usage[:, :lcap], usage[:, lcap:]
            else:
                ring = (self.key, self.shr, self.value, work_valid)
                if self.approx:
                    res = attend_approx_multi([ring], qk, qe, top_k,
                                              return_usage=self.use_lt)
                    rd, work_u = (res[0], res[1][0]) if self.use_lt else \
                        (res, None)
                else:
                    res = attend_topk(*ring[:3], qk, qe, top_k, ring[3],
                                      return_usage=self.use_lt)
                    rd, work_u = res if self.use_lt else (res, None)
            if self.use_lt:  # working-memory usage whenever long-term is on
                self.use_cnt += torch.where(work_valid, work_u, 0.0)
                self.life_cnt += work_valid.float()
            if lt_on and self.count_lt_usage:
                self.lt_use += torch.where(self.lt_valid, lt_u, 0.0)
                self.lt_life += self.lt_valid.float()
            return rd

    def _write(self, padded, f16, key, shrinkage, selection) -> None:
        """A memory frame: encode every video's mask and write its tokens at
        the shared working size, in place (rounded to the ring dtype)."""
        value, deep = self.model.encode_mask(padded, f16, self.sensory,
                                             self.last_mask,
                                             deep_update=True,
                                             live=self.live)
        self.sensory = deep
        b, o, cv = value.shape[:3]
        size = int(self.sizes[0])
        at = slice(size, size + key.shape[2] * key.shape[3])
        self.key[:, at] = _tokens(key)
        self.shr[:, at] = shrinkage.flatten(1)
        if self.sel is not None:
            self.sel[:, at] = _tokens(selection)
        self.value[:, at] = value.reshape(b, o, cv, -1).permute(0, 3, 1, 2)
        if self.use_cnt is not None:
            self.use_cnt[:, at] = 0.0
            self.life_cnt[:, at] = 1e-7

    def _body(self, images, *, mem_write: bool, update_sensory: bool,
              lt_on: bool) -> torch.Tensor:
        """One lockstep frame (deva_tpu's _raw_step, vmapped). images
        [B, H, W, 3] on the device. Returns prob [B, 1 + O_cap, H, W]."""
        b, h, w = images.shape[:3]
        lw, uw, lh, uh = pad_amounts(h, w, 16)
        padded = F.pad(images.permute(0, 3, 1, 2), (lw, uw, lh, uh))
        ms, key_feat = self.model.encode_image(padded)
        key, shrinkage, selection = self.model.transform_key(key_feat)
        hq, wq = key.shape[2:]
        rd = self._attend_and_count(_tokens(key), _tokens(selection), lt_on)
        readout = rd.transpose(2, 3).reshape(b, self.o_cap, -1, hq, wq)
        new_sensory, _, prob = self.model.segment(
            ms, readout, self.sensory, self.last_mask, selector=self.selector,
            update_sensory=update_sensory, live=self.live)
        if update_sensory:
            self.sensory = new_sensory
        self.last_mask = prob[:, 1:]
        if mem_write:
            self._write(padded, ms[0], key, shrinkage, selection)
        return prob[:, :, lh:lh + h, lw:lw + w]

    # -- ring capacity --------------------------------------------------------

    def reserve(self, n_writes: int) -> None:
        """Pre-size the rings for `n_writes` further memory writes so that no
        growth happens mid-run. With long-term memory the working set is
        already capped (the rings were sized for the trigger in _stack)."""
        if self.use_lt:
            return
        top, = group_max(self._group, int(self.sizes.max()))
        need = top + n_writes * self._token_hw
        if need > self.key.shape[1]:
            self._grow_rings(need - self.key.shape[1])

    def _grow_rings(self, grow: int) -> None:
        new_cap = self.key.shape[1] + grow
        for name in self._WORK:
            ring = getattr(self, name)
            if ring is not None:
                setattr(self, name, _grow_tokens(ring, new_cap))

    # -- long-term consolidation (lockstep over the batch) --------------------

    def _maybe_consolidate(self) -> None:
        """All videos share one write schedule, so their working sizes stay
        equal and saturate together: consolidate the whole batch in lockstep
        (MemoryEngine.maybe_consolidate, _compress and _evict_obsolete, with
        the prototype math batched over the videos)."""
        if not self.use_lt:
            return
        cfg = self.cfg
        size = int(self.sizes[0])
        hw = self._token_hw
        max_work = cfg.max_mid_term_frames * hw
        min_work = cfg.min_mid_term_frames * hw
        if size < max_work or size <= min_work + hw:
            return
        with tracing.span("deva.consolidate"):
            self._consolidate(size, hw, min_work)

    def _consolidate(self, size: int, hw: int, min_work: int) -> None:
        """_maybe_consolidate's work, once the working rings are full."""
        cfg = self.cfg
        # usage-based eviction of least-used long-term tokens for the videos
        # at the cap
        limit = cfg.max_long_term_elements - cfg.num_prototypes
        if group_max(self._group, int((self.lt_sizes >= limit).any()))[0]:
            # without long-term usage counting every usage is 0, and the
            # strictly-greater threshold would silently evict the whole
            # long-term memory
            assert self.count_lt_usage, (
                "long-term memory saturated but enable_long_term_count_usage"
                " is False; enable it (the reference's long-video policy) so"
                " eviction has usage statistics to rank tokens by")
            self._evict_obsolete(limit)

        start, end = hw, size - min_work + hw
        usage = self.use_cnt / self.life_cnt
        proto_key, proto_shr, proto_value = consolidate_prototypes_batched(
            self.key[:, start:end], self.shr[:, start:end],
            self.sel[:, start:end], self.value[:, start:end],
            usage[:, start:end], cfg.num_prototypes)

        # sieve: keep [0:start] + [end:size] (the same window in every video)
        new_size = start + (size - end)

        def sieve(ring):
            out = torch.zeros_like(ring)
            out[:, :start] = ring[:, :start]
            out[:, start:new_size] = ring[:, end:size]
            return out

        for name in self._WORK:
            setattr(self, name, sieve(getattr(self, name)))
        self.sizes = np.full_like(self.sizes, new_size)

        # append the prototypes at each video's long-term cursor, growing the
        # lazy capacity when the batch's largest cursor needs it
        p = proto_key.shape[1]  # == num_prototypes unless window-clamped
        lcap = self.lt_key.shape[1]
        top, = group_max(self._group, int(self.lt_sizes.max()))
        if top + p > lcap:
            max_cap = _round_up(cfg.max_long_term_elements, p)
            new_cap = min(_round_up(max(lcap * 2, top + p), p), max_cap)
            for name in self._LONG + ("lt_valid",):
                setattr(self, name, _grow_tokens(getattr(self, name),
                                                 new_cap))
        offsets = sorted(set(self.lt_sizes.tolist()))
        for off in offsets:
            # the videos whose cursor is at `off` (all of them, unless an
            # eviction left the sizes apart)
            vids = np.nonzero(self.lt_sizes == off)[0]
            rows = slice(None) if len(vids) == len(self.lt_sizes) else \
                torch.as_tensor(vids, device=self.device)
            at = slice(off, off + p)
            for ring, new in ((self.lt_key, proto_key),
                              (self.lt_shr, proto_shr),
                              (self.lt_value, proto_value)):
                ring[rows, at] = new[rows]
            self.lt_use[rows, at] = 0.0
            self.lt_life[rows, at] = 1e-7
            self.lt_valid[rows, at] = True
        self.lt_sizes = self.lt_sizes + p

    def _evict_obsolete(self, max_size: int) -> None:
        """Per-video usage eviction with upstream's strictly-greater
        threshold; survivors keep their order (a stable gather)."""
        lcap = self.lt_key.shape[1]
        lt_use = self.lt_use.cpu().numpy()
        lt_life = self.lt_life.cpu().numpy()
        orders = []
        new_sizes = self.lt_sizes.copy()
        for v in range(len(self.cores)):
            n = int(self.lt_sizes[v])
            k = n - max_size
            if k <= 0:
                orders.append(np.arange(lcap))
                continue
            usage = lt_use[v, :n] / lt_life[v, :n]
            thresh = np.partition(usage, k - 1)[k - 1]
            survived = usage > thresh
            orders.append(np.concatenate([
                np.nonzero(survived)[0], np.nonzero(~survived)[0],
                np.arange(n, lcap)]))
            new_sizes[v] = int(survived.sum())
        idx = torch.as_tensor(np.stack(orders), device=self.device)
        videos = torch.arange(len(orders), device=self.device)[:, None]
        for name in self._LONG:
            setattr(self, name, getattr(self, name)[videos, idx])
        self.lt_sizes = new_sizes
        self.lt_valid = (torch.arange(lcap)[None, :] <
                         torch.as_tensor(new_sizes)[:, None]).to(self.device)

    # -- stepping -------------------------------------------------------------

    def _images(self, frames) -> torch.Tensor:
        """B frames (a sequence of arrays or tensors, or one stacked array or
        tensor) -> one f32 tensor on the propagator's device."""
        return frames_to_device(frames, self.device)

    @staticmethod
    def _frame_tokens(h: int, w: int) -> int:
        lw, uw, lh, uh = pad_amounts(h, w, 16)
        return ((h + lh + uh) // 16) * ((w + lw + uw) // 16)

    @torch.no_grad()
    def step_block(self, frames, end: bool = False) -> torch.Tensor:
        """Advance every video K frames (deva_tpu's _raw_block under vmap: a
        loop of the per-frame body, the rings written only by the last
        frame). frames: [B, K, H, W, 3] (or B arrays [K, H, W, 3]). The
        memory-write schedule must land only on the block's last frame;
        asserts otherwise. Returns probabilities [B, K, 1 + O_cap, H, W]."""
        with tracing.step():
            frames = self._images(frames)
            k, h, w = frames.shape[1:4]
            last_mem = self._last_mem_ti()
            for i in range(1, k):
                assert (self.frame_idx + i) - last_mem < \
                    self.cfg.mem_every, \
                    "a mid-block frame would be a memory frame; use a " \
                    "smaller K"
            write_last = ((self.frame_idx + k) - last_mem
                          >= self.cfg.mem_every) and not end
            hw = self._frame_tokens(h, w)
            if write_last and not self.use_lt and \
                    group_max(self._group, int(self.sizes.max()))[0] + hw > \
                    self.key.shape[1]:
                self.reserve(4)
            lt_on = self._lt_engaged
            probs = [self._body(frames[:, i],
                                mem_write=write_last and i == k - 1,
                                update_sensory=True, lt_on=lt_on)
                     for i in range(k)]
            self.frame_idx += k
            if write_last:
                self.sizes = self.sizes + hw
                self._mem_ti = self.frame_idx
                self._maybe_consolidate()
            return torch.stack(probs, 1)

    @torch.no_grad()
    def step_all(self, frames, end: bool = False) -> torch.Tensor:
        """One lockstep frame for every video. frames: B arrays [H, W, 3]
        (or one [B, H, W, 3]). Returns probabilities [B, 1 + O_cap, H, W]
        (video i's live channels are the first 1 + num_obj[i])."""
        with tracing.step():
            self.frame_idx += 1
            curr_ti = self.frame_idx
            is_mem = (curr_ti - self._last_mem_ti() >= self.cfg.mem_every) \
                and not end
            images = self._images(frames)
            hw = self._frame_tokens(*images.shape[1:3])
            if is_mem and not self.use_lt and \
                    group_max(self._group, int(self.sizes.max()))[0] + hw > \
                    self.key.shape[1]:
                self._grow_rings(hw * 4)
            probs = self._body(images, mem_write=is_mem,
                               update_sensory=not end,
                               lt_on=self._lt_engaged)
            if is_mem:
                self.sizes = self.sizes + hw
                self._mem_ti = curr_ti
                self._maybe_consolidate()
            return probs

    def _last_mem_ti(self) -> int:
        return getattr(self, "_mem_ti", 0)
