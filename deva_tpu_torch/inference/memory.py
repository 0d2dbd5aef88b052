"""Fixed-capacity working + long-term memory engine.

Port of deva_tpu/inference/memory.py. Every bucket owns fixed-capacity,
token-major rings

    key        [cap, Ck]       value     [cap, O_cap, Cv]
    shrinkage  [cap]           selection [cap, Ck]
    use_cnt / life_cnt [cap]

with a host-side integer `size` as the single source of truth for validity.
key, shrinkage, selection and value are stored in the ring dtype
(InferenceConfig.ring_dtype; appends round to it), use_cnt and life_cnt in
f32 (deva_tpu/inference/memory.py:172-182,233-241). Long-term consolidation
reads and writes the rings in their dtype; every readout is f32.
Appends write in place at the cursor; capacities grow geometrically in
whole-frame quanta (`ensure_capacity`).

Objects first seen in the same frame share one bucket (one key timeline and
one top-k normalization set); every `add_memory` appends the same frame's
tokens to every live bucket. Consolidation into long-term memory (usage
top-k prototypes + a dense-softmax potentiation readout) triggers at
size == max_work_tokens; eviction of obsolete long-term tokens keeps
survivors in order.

`match_memory` is the composed path of deva_tpu's memory.py:94-123. With the
exact method every readout goes through attention_kernels.attend_topk (single
ring, or [long-term ; working]: keys concatenated, value rings read in place
as two segments), so on a CUDA device both exact kernels run; with the
approx method it takes the dense threshold form of
memory_attention.topk_softmax over the concatenated rings, as deva_tpu does
(XLA code there, not a kernel). The fused step (inference/fused_step.py)
reads and writes the same rings in place.

Object sharding (parallel/object_sharding.py, `shards=`): sensory holds this
process's object slots, and so does every bucket's value ring whose padded
object count divides over the processes ([cap, o_b/D, Cv]; a bucket that
does not divide keeps all its columns, deva_tpu's placement rule). The
token-axis rings and counts are whole on every process and the host
decisions are the unsharded engine's: purges, growth, consolidation and
eviction act on each process's slice, and the decisions that read usage
counts read rank 0's. A readout whose bucket columns are not laid out as
the object slots (another bucket order, other padding) is gathered and
scattered to the slots' owners.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.ops import memory_attention as ma
from deva_tpu_torch.ops.attention_kernels import attend_topk
from deva_tpu_torch.parallel.object_sharding import ObjectShards
from deva_tpu_torch.utils import tracing


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def _grow(arr: torch.Tensor, new_cap: int) -> torch.Tensor:
    """Zero-pad the leading (token) axis to new_cap."""
    out = arr.new_zeros((new_cap,) + tuple(arr.shape[1:]))
    out[:arr.shape[0]] = arr
    return out


def _readout_token_major(aff: torch.Tensor, value: torch.Tensor):
    """aff [Q, N]; value [N, O, Cv] -> [O, Q, Cv] (one [Q,N]@[N,O*Cv], f32).
    As memory_attention.readout, the affinity is rounded to the ring's
    dtype (deva_tpu/inference/memory.py:83-89)."""
    n, o, cv = value.shape
    out = ma.readout(aff, value.reshape(n, o * cv))
    return out.reshape(aff.shape[0], o, cv).transpose(0, 1)


def _consolidate_prototypes(cand_key, cand_shr, cand_sel, cand_value,
                            cand_usage, num_prototypes: int):
    """Select the top-usage prototypes and potentiate them: a full-softmax
    readout of the candidate values at the prototype queries. cand_value is
    token-major [N, O, Cv]; returns prototype key [P, Ck], shrinkage [P],
    value [P, O, Cv]. P is clamped to the number of candidates. The selection
    is ordered like lax.top_k (ties to the lowest index)."""
    num_prototypes = min(num_prototypes, cand_usage.shape[0])
    _, idx = ma.topk_sorted(cand_usage, num_prototypes)
    proto_key = cand_key[idx]
    proto_sel = cand_sel[idx]
    sim = ma.get_similarity(cand_key, cand_shr, proto_key, proto_sel)
    aff = ma.full_softmax(sim)
    proto_value = _readout_token_major(aff, cand_value).transpose(0, 1)
    proto_shr = ma.readout(aff, cand_shr[None, :, None])[0, :, 0]
    return proto_key, proto_shr, proto_value.contiguous()


def consolidate_prototypes_batched(cand_key, cand_shr, cand_sel, cand_value,
                                   cand_usage, num_prototypes: int):
    """_consolidate_prototypes for B videos at once, with tensor ops over the
    video axis (deva_tpu vmaps the 2-D form, inference/batched.py:337-341):
    cand_key [B, n, Ck], cand_shr [B, n], cand_sel [B, n, Ck], cand_value
    [B, n, O, Cv], cand_usage [B, n] -> prototype key [B, P, Ck], shrinkage
    [B, P], value [B, P, O, Cv], each video's as the 2-D form selects and
    potentiates them (the readout rounds the affinity to the ring dtype)."""
    b, n = cand_usage.shape
    num_prototypes = min(num_prototypes, n)
    _, idx = ma.topk_sorted(cand_usage, num_prototypes)  # [B, P]
    videos = torch.arange(b, device=idx.device)[:, None]
    proto_key = cand_key[videos, idx]
    proto_sel = cand_sel[videos, idx]
    sim = ma.get_similarity(cand_key, cand_shr, proto_key, proto_sel)
    aff = ma.full_softmax(sim)  # [B, P, n]
    o, cv = cand_value.shape[-2:]
    proto_value = ma.readout(aff, cand_value.reshape(b, n, o * cv))
    proto_shr = ma.readout(aff, cand_shr[..., None])[..., 0]
    return proto_key, proto_shr, proto_value.reshape(b, -1, o, cv)


class Bucket:
    """One working-memory bucket: a key timeline shared by the objects that
    first appeared together, plus per-object values (rows follow obj_ids)."""

    def __init__(self, obj_ids: List[int], o_cap: int, cap: int, ck: int,
                 cv: int, save_selection: bool, save_usage: bool,
                 dtype: torch.dtype, device: torch.device,
                 shards: Optional[ObjectShards] = None):
        """shards: the object axis's processes; the value ring then holds
        this process's o_cap/D columns, when o_cap divides over them."""
        self.obj_ids = list(obj_ids)
        self.o_cap = o_cap
        self.shards = shards if shards is not None and \
            shards.divides(o_cap) else None
        o_here = o_cap // self.shards.size if self.shards else o_cap
        self.size = 0
        z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt,
                                                 device=device)
        self.key = z(cap, ck)
        self.shrinkage = z(cap)
        self.selection = z(cap, ck) if save_selection else None
        self.value = z(cap, o_here, cv)
        self.use_cnt = z(cap, dt=torch.float32) if save_usage else None
        self.life_cnt = z(cap, dt=torch.float32) if save_usage else None

    @property
    def cap(self) -> int:
        return self.key.shape[0]

    def map_rings(self, fn) -> None:
        """Replace each token-major ring that exists by fn(ring)."""
        for name in ("key", "shrinkage", "selection", "value", "use_cnt",
                     "life_cnt"):
            arr = getattr(self, name)
            if arr is not None:
                setattr(self, name, fn(arr))

    def plan_capacity(self, extra: int, quantum: int,
                      limit: Optional[int] = None) -> int:
        """The capacity ensure_capacity grows to, without copying the rings
        (the batched propagator's detach overwrites them anyway)."""
        if self.size + extra <= self.cap:
            return self.cap
        new_cap = max(self.cap * 2, _round_up(self.size + extra, quantum))
        new_cap = _round_up(new_cap, quantum)
        if limit is not None:
            # long-term mode: the working set never exceeds max_work_tokens,
            # so geometric growth must not overshoot it
            new_cap = min(new_cap, max(_round_up(limit, quantum),
                                       self.size + extra))
        return new_cap

    def ensure_capacity(self, extra: int, quantum: int,
                        limit: Optional[int] = None) -> None:
        new_cap = self.plan_capacity(extra, quantum, limit)
        if new_cap != self.cap:
            self.map_rings(lambda arr: _grow(arr, new_cap))

    def append(self, key: torch.Tensor, shrinkage: torch.Tensor,
               value: torch.Tensor,
               selection: Optional[torch.Tensor] = None) -> None:
        """Write n tokens at the cursor, in place (capacity ensured by the
        caller): key [n, Ck], shrinkage [n], value [n, o_cap, Cv], selection
        [n, Ck]; the new slots start with use_cnt 0 and life_cnt 1e-7."""
        n = key.shape[0]
        at = slice(self.size, self.size + n)
        self.key[at] = key
        self.shrinkage[at] = shrinkage
        if self.selection is not None:
            self.selection[at] = selection
        if self.use_cnt is not None:
            self.use_cnt[at] = 0.0
            self.life_cnt[at] = 1e-7
        self.value[at] = value
        self.size += n

    def keep_objects(self, keep: List[int]) -> None:
        """Drop the value columns of objects not in `keep` (order kept)."""
        new_ids = [o for o in self.obj_ids if o in keep]
        if new_ids == self.obj_ids:
            return
        rows = [self.obj_ids.index(o) for o in new_ids]
        if self.shards is not None:
            self.value = self.shards.regather(
                self.value, rows + [-1] * (self.o_cap - len(rows)), dim=1)
        else:
            value = torch.zeros_like(self.value)
            value[:, :len(rows)] = self.value[:, rows]
            self.value = value
        self.obj_ids = new_ids


class LongTermBucket(Bucket):
    def __init__(self, obj_ids: List[int], o_cap: int, cap: int, ck: int,
                 cv: int, save_usage: bool, dtype: torch.dtype,
                 device: torch.device,
                 shards: Optional[ObjectShards] = None):
        super().__init__(obj_ids, o_cap, cap, ck, cv, save_selection=False,
                         save_usage=save_usage, dtype=dtype, device=device,
                         shards=shards)


def attend(approx: bool, mk, ms, values, qk, qe, top_k: int, valid=None,
           return_usage: bool = False):
    """The composed path's attention, by the port's one dispatch rule
    (config.resolve_topk_method): exact through attention_kernels.
    attend_topk (on a CUDA device, the sim_topk and topk_readout kernels),
    approx through the dense threshold form of memory_attention, as
    deva_tpu's memory.py does. values [N, O, Cv] token-major, or the pair of
    [long-term ; working] value rings, which the exact kernels read in place
    -> [O, Q, Cv] (and usage [N])."""
    if approx:
        if isinstance(values, tuple):  # the dense form reads one ring
            values = torch.cat(values)
        return ma.attend(mk, ms, values.transpose(0, 1), qk, qe, top_k,
                         valid, return_usage, method="approx")
    return attend_topk(mk, ms, values, qk, qe, top_k, valid, return_usage)


def valid_mask(cap: int, size: int, device) -> torch.Tensor:
    return torch.arange(cap, device=device) < size


def count_usage(b: Bucket, usage: torch.Tensor, valid: torch.Tensor,
                lives: float = 1.0) -> None:
    """Add one step's usage [cap] to the valid slots, in place, and `lives`
    frames to their life counts."""
    b.use_cnt += torch.where(valid, usage, 0.0)
    b.life_cnt += valid.float() * lives


class MemoryEngine:
    """Sensory, working and long-term memory of one video. Object rows follow
    host tmp ids (0-based); the object axis is padded to `o_cap`. shards:
    the object axis's processes (InferenceCore(obj_mesh=...)); o_cap then
    divides over them and sensory holds this process's slots."""

    def __init__(self, config: InferenceConfig, sensory_dim: int,
                 key_dim: int, value_dim: int, o_cap: int,
                 device: torch.device,
                 shards: Optional[ObjectShards] = None):
        self.cfg = config
        self.shards = shards
        self.approx = config.resolve_topk_method() == "approx"
        self.sensory_dim = sensory_dim
        self.ck = key_dim
        self.cv = value_dim
        self.o_cap = o_cap
        self.device = torch.device(device)
        self.top_k = config.top_k
        self.use_long_term = config.enable_long_term
        self.count_long_term_usage = config.enable_long_term_count_usage
        self.ring_dtype = config.ring_torch_dtype

        self.hw: Optional[int] = None  # tokens per frame (set on first add)
        self.buckets: Dict[int, Bucket] = {}
        self.long_buckets: Dict[int, LongTermBucket] = {}
        self._next_bucket_id = 0
        self.sensory: Optional[torch.Tensor] = None  # [O_cap, Cs, h, w]
        self.engaged = False

    # -- sensory ----------------------------------------------------------

    def initialize_sensory(self, h: int, w: int) -> None:
        if self.sensory is None:
            self.sensory = torch.zeros((self._slots(), self.sensory_dim, h, w),
                                       dtype=torch.float32,
                                       device=self.device)

    def _slots(self) -> int:
        """The object slots this process holds."""
        return self.o_cap // self.shards.size if self.shards else self.o_cap

    def _decision(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor that a host decision reads: rank 0's under sharding."""
        return self.shards.broadcast0(x.contiguous()) if self.shards else x

    def update_sensory(self, sensory: torch.Tensor) -> None:
        """sensory [O_cap, Cs, h, w] (already in tmp-row order)."""
        self.sensory = sensory

    def get_sensory(self) -> torch.Tensor:
        return self.sensory

    # -- working/long-term ------------------------------------------------

    @property
    def max_work_tokens(self) -> int:
        return self.cfg.max_mid_term_frames * self.hw

    @property
    def min_work_tokens(self) -> int:
        return self.cfg.min_mid_term_frames * self.hw

    def add_memory(self, key: torch.Tensor, shrinkage: torch.Tensor,
                   value: torch.Tensor, obj_ids: List[int],
                   selection: Optional[torch.Tensor] = None,
                   new_obj_ids: Optional[List[int]] = None) -> None:
        """Append one frame of tokens: key [HW, Ck], shrinkage [HW], value
        [O_cap, HW, Cv] (rows = tmp rows; this process's slots under
        sharding), selection [HW, Ck]. Objects in `new_obj_ids`
        (first-time) form a new bucket; every existing bucket receives the
        same tokens."""
        self.engaged = True
        hw = key.shape[0]
        if self.hw is None:
            self.hw = hw

        known = {o for b in self.buckets.values() for o in b.obj_ids}
        if new_obj_ids is None:
            new_obj_ids = [o for o in obj_ids if o not in known]
        if new_obj_ids:
            bid = self._next_bucket_id
            self._next_bucket_id += 1
            self.buckets[bid] = Bucket(
                new_obj_ids, self.cfg.pad_objects(len(new_obj_ids)), hw,
                self.ck, self.cv, save_selection=self.use_long_term,
                save_usage=self.use_long_term, dtype=self.ring_dtype,
                device=self.device, shards=self.shards)

        row_of = {o: i for i, o in enumerate(obj_ids)}
        limit = self.max_work_tokens if self.use_long_term else None
        whole = None  # every process's slots, gathered once if needed
        for b in self.buckets.values():
            b.ensure_capacity(hw, hw, limit=limit)
            rows = [row_of[o] for o in b.obj_ids]
            rows += [0] * (b.o_cap - len(rows))  # padded columns: harmless
            if self.shards is None:
                vals = value[rows]
            elif b.shards is not None and rows == list(range(self.o_cap)):
                vals = value  # the bucket's columns are the object slots
            else:
                if whole is None:
                    whole = self.shards.gather(value)
                vals = whole[rows]
                if b.shards is not None:
                    vals = b.shards.take(vals)
            b.append(key, shrinkage, vals.transpose(0, 1),  # [HW, o_b, Cv]
                     selection)

        self.maybe_consolidate()

    def maybe_consolidate(self) -> None:
        """Evict obsolete long-term tokens and consolidate any saturated
        working bucket."""
        if not self.use_long_term:
            return
        for bid in list(self.buckets.keys()):
            b = self.buckets[bid]
            if b.size < self.max_work_tokens:
                continue
            with tracing.span("deva.consolidate"):
                lt = self.long_buckets.get(bid)
                max_lt = (self.cfg.max_long_term_elements -
                          self.cfg.num_prototypes)
                if lt is not None and lt.size >= max_lt:
                    self._evict_obsolete(bid, max_lt)
                self._compress(bid)

    def _compress(self, bid: int) -> None:
        """Consolidate the middle of the working timeline into prototypes and
        append them to the long-term bucket."""
        b = self.buckets[bid]
        hw = self.hw
        start, end = hw, b.size - self.min_work_tokens + hw
        if b.size <= self.min_work_tokens + hw:
            return  # min_size guard

        usage = self._decision(b.use_cnt / b.life_cnt)
        proto_key, proto_shr, proto_value = _consolidate_prototypes(
            b.key[start:end], b.shrinkage[start:end],
            b.selection[start:end], b.value[start:end], usage[start:end],
            self.cfg.num_prototypes)

        # sieve: keep [0:start] + [end:size], compacted, zeros after
        new_size = start + (b.size - end)

        def sieve(arr):
            out = torch.zeros_like(arr)
            out[:start] = arr[:start]
            out[start:new_size] = arr[end:b.size]
            return out

        b.map_rings(sieve)
        b.size = new_size

        lt = self.long_buckets.get(bid)
        p = proto_key.shape[0]  # == num_prototypes unless window-clamped
        if lt is None:
            # allocated lazily, small, and doubled as prototypes accumulate:
            # every frame's attention pays for the whole ring capacity
            lt = LongTermBucket(b.obj_ids, b.o_cap, _round_up(4 * p, p),
                                self.ck, self.cv,
                                save_usage=self.count_long_term_usage,
                                dtype=self.ring_dtype, device=self.device,
                                shards=self.shards)
            self.long_buckets[bid] = lt
        if lt.size + p > lt.cap:
            max_cap = _round_up(self.cfg.max_long_term_elements, p)
            new_cap = min(_round_up(max(lt.cap * 2, lt.size + p), p),
                          max_cap)
            lt.map_rings(lambda arr: _grow(arr, new_cap))
        lt.obj_ids = list(b.obj_ids)
        lt.append(proto_key, proto_shr, proto_value)

    def _evict_obsolete(self, bid: int, max_size: int) -> None:
        """Remove least-used long-term tokens until size <= max_size, keeping
        survivors in their order (strictly-greater threshold, as upstream's
        kv_memory_store)."""
        lt = self.long_buckets[bid]
        if lt.use_cnt is None:
            raise RuntimeError(
                "long-term memory saturated but usage counting is off "
                "(enable_long_term_count_usage=False): eviction needs usage "
                "statistics")
        usage = self._decision(lt.use_cnt / lt.life_cnt).cpu().numpy()[
            :lt.size]
        k = lt.size - max_size
        if k <= 0:
            return
        thresh = np.partition(usage, k - 1)[k - 1]
        survived = usage > thresh
        order = np.concatenate([np.nonzero(survived)[0],
                                np.nonzero(~survived)[0],
                                np.arange(lt.size, lt.cap)])
        idx = torch.as_tensor(order, device=self.device)
        lt.map_rings(lambda arr: arr[idx])
        lt.size = int(survived.sum())

    def match_memory(self, qk: torch.Tensor, qe: torch.Tensor,
                     obj_rows: Dict[int, int]) -> torch.Tensor:
        """qk/qe: [HW, Ck]. obj_rows: obj id -> global tmp row.
        Returns the readout [O_cap, HW, Cv] (f32), rows in tmp order (this
        process's slots under sharding)."""
        with tracing.span("deva.attention"):
            out = torch.zeros((self._slots(), qk.shape[0], self.cv),
                              dtype=torch.float32, device=self.device)
            for bid, b in self.buckets.items():
                valid = valid_mask(b.cap, b.size, self.device)
                lt = self.long_buckets.get(bid)
                if self.use_long_term and lt is not None and lt.size > 0:
                    lt_valid = valid_mask(lt.cap, lt.size, self.device)
                    rd, usage = attend(
                        self.approx, torch.cat([lt.key, b.key]),
                        torch.cat([lt.shrinkage, b.shrinkage]),
                        (lt.value, b.value), qk, qe, self.top_k,
                        valid=torch.cat([lt_valid, valid]), return_usage=True)
                    count_usage(b, usage[lt.cap:], valid)
                    if self.count_long_term_usage:
                        count_usage(lt, usage[:lt.cap], lt_valid)
                elif self.use_long_term:
                    rd, usage = attend(self.approx, b.key, b.shrinkage,
                                       b.value, qk, qe, self.top_k,
                                       valid=valid, return_usage=True)
                    count_usage(b, usage, valid)
                else:
                    rd = attend(self.approx, b.key, b.shrinkage, b.value, qk,
                                qe, self.top_k, valid=valid)
                rows = [obj_rows[o] for o in b.obj_ids]
                if self.shards is None:
                    out[rows] = rd[:len(rows)]
                else:
                    self._scatter_sharded(out, b, rows, rd)
            return out

    def _scatter_sharded(self, out, b: Bucket, rows: List[int], rd) -> None:
        """out[rows] = the bucket's readout rd [o_b(/D), Q, Cv], where out
        holds this process's object slots. Where the bucket's columns are
        the slots themselves no process needs another's columns; else the
        bucket's columns are gathered and each process keeps its rows."""
        lo, hi = self.shards.span(self.o_cap)
        if b.shards is not None and b.o_cap == self.o_cap and \
                rows == list(range(len(rows))):
            n = min(max(len(rows) - lo, 0), hi - lo)
            out[:n] = rd[:n]
            return
        whole = b.shards.gather(rd) if b.shards is not None else rd
        mine = [(r - lo, j) for j, r in enumerate(rows) if lo <= r < hi]
        if mine:
            out[[i for i, _ in mine]] = whole[[j for _, j in mine]]

    def purge_except(self, keep_obj_ids: List[int]) -> None:
        keep = set(keep_obj_ids)
        for store in (self.buckets, self.long_buckets):
            for bid in list(store):
                store[bid].keep_objects(keep)
                if not store[bid].obj_ids:
                    del store[bid]
        if not self.buckets:
            self.engaged = False

    @property
    def num_work_tokens(self) -> int:
        return max((b.size for b in self.buckets.values()), default=0)
