"""Object-axis ('model' mesh axis) sharding for many-object serving.

Port of deva_tpu/parallel/object_sharding.py on torch.distributed. The
object axis of the propagation model is embarrassingly parallel: the
grouped decoder, the mask encoder and the value readout treat every object
alone (reference:deva/model/group_modules.py:6-7). deva_tpu shards the
object axis of the serving state over a 'model' mesh axis and XLA inserts
the cross-object collectives; here each process of the axis owns a
contiguous range of object slots and the collectives are written out:

  - slot ownership: of a padded object axis of o_cap slots (a multiple of
    the axis size D, InferenceCore rounds it up), process i owns slots
    [i * o_cap/D, (i + 1) * o_cap/D);
  - per process: its slots of `sensory` [o_cap/D, Cs, h, w] and
    `last_mask` [o_cap/D, H, W], and of each memory bucket's value ring
    [cap, o_b/D, Cv] where the bucket's own padded count o_b divides by D
    (deva_tpu's placement rule: a bucket that does not divide stays whole
    on every process);
  - whole on every process: the weights, the token-axis state (keys,
    shrinkage, selection, usage and life counters) and the host state
    (object manager, ring sizes);
  - the collectives: the background product prod(1 - p) over the objects
    (`object_product`: a local product, then one all_reduce PRODUCT), the
    softmax over [background, objects] (`object_softmax`: all_reduce MAX
    and SUM), the full probability for host code (`ObjectShards.
    gather_prob`: one list all_gather), and the moves of slots between
    processes when the layout changes (`ObjectShards.regather`: object
    capacity growth, purges; one broadcast per process that sends).

PRODUCT rather than a sum of logs: gloo and NCCL both reduce with it, a
product of D partial products rounds like the unsharded product up to
order, and it keeps 1 - p = 0 (a certain object) exact where a log would
give -inf.

Host decisions stay replicated: every process runs the object manager on
the full probability gathered from the owners, which is the same bytes on
every process; the background channel is rank 0's. Decisions that read a
tensor every process computes for itself (the usage counts of
consolidation and eviction) read rank 0's, broadcast
(`ObjectShards.broadcast0`): the same compute on two cards need not be
bitwise equal.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from deva_tpu_torch.parallel.mesh import axis_group


def object_product(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """prod over `dim` of every process's slots of x (keepdim): a local
    product, then one all_reduce PRODUCT. The same on every process."""
    out = torch.prod(x, dim=dim, keepdim=True)
    if group is not None:
        dist.all_reduce(out, op=dist.ReduceOp.PRODUCT, group=group)
    return out


def object_softmax(lg: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Softmax over [background ; every process's objects] along `dim`,
    where index 0 of `dim` is the background (the same on every process)
    and the rest are this process's object slots. Returns this process's
    [background ; its objects] probabilities."""
    if group is None:
        return torch.softmax(lg, dim=dim)
    m = lg.amax(dim=dim, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(lg - m)
    bg, objs = e.split([1, e.shape[dim] - 1], dim=dim)
    s = objs.sum(dim=dim, keepdim=True)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return e / (s + bg)


class ObjectShards:
    """This process's place on the object axis of a mesh, and the moves of
    object slots between the processes of that axis."""

    def __init__(self, mesh, axis: str = "model"):
        self.group, self.rank, self.size = axis_group(mesh, axis)
        self.ranks = dist.get_process_group_ranks(self.group)

    def divides(self, n: int) -> bool:
        return n % self.size == 0

    def span(self, n: int):
        """(first, end) of this process's slots of an axis of n slots."""
        if not self.divides(n):
            raise ValueError(f"{n} object slots do not divide over "
                             f"{self.size} processes")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def take(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This process's slots of a whole tensor (a view)."""
        lo, hi = self.span(x.shape[dim])
        return x.narrow(dim, lo, hi - lo)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The whole tensor from every process's slots along `dim` (one
        list all_gather; every process gets the same bytes)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def gather_prob(self, prob: torch.Tensor) -> torch.Tensor:
        """[1 + o_cap/D, ...] (background ; this process's objects) ->
        [1 + o_cap, ...]: the objects from their owners, the background
        from rank 0 of the axis."""
        parts = [torch.empty_like(prob) for _ in range(self.size)]
        dist.all_gather(parts, prob.contiguous(), group=self.group)
        return torch.cat([parts[0][:1]] + [p[1:] for p in parts])

    def broadcast0(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's x on every process of the axis (in place)."""
        dist.broadcast(x, self.ranks[0], group=self.group)
        return x

    def regather(self, x: torch.Tensor, src: Sequence[int],
                 dim: int = 0) -> torch.Tensor:
        """Re-lay a sharded axis. x: this process's slots (o_old/D of them)
        of an axis of o_old slots along `dim`; src: for each of the o_new
        new slots, the old slot it takes (an index into all o_old) or -1
        for zeros. Returns this process's o_new/D new slots. Every process
        whose slots another process needs broadcasts them once; the peak is
        this process's slots plus one process's."""
        src = [int(s) for s in src]
        per_old = x.shape[dim]
        per_new = len(src) // self.size
        if per_new * self.size != len(src):
            raise ValueError(f"{len(src)} object slots do not divide over "
                             f"{self.size} processes")
        shape = list(x.shape)
        shape[dim] = per_new
        out = x.new_zeros(shape)

        def wants(r: int, s: int) -> List[tuple]:
            """(new local slot, old local slot) pairs process r takes from
            process s."""
            return [(i, j - s * per_old)
                    for i, j in enumerate(src[r * per_new:(r + 1) * per_new])
                    if s * per_old <= j < (s + 1) * per_old]

        for s in range(self.size):
            mine = wants(self.rank, s)
            others = any(wants(r, s) for r in range(self.size) if r != s)
            if s == self.rank:
                buf = x
                if others:
                    dist.broadcast(x.contiguous(), self.ranks[s],
                                   group=self.group)
            elif others:
                buf = torch.empty_like(x).contiguous()
                dist.broadcast(buf, self.ranks[s], group=self.group)
            else:
                continue
            if mine:
                to = torch.as_tensor([i for i, _ in mine], device=x.device)
                fr = torch.as_tensor([j for _, j in mine], device=x.device)
                out.index_copy_(dim, to, buf.index_select(dim, fr))
        return out

