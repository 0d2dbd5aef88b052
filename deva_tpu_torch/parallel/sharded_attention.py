"""Memory-axis (sequence-parallel) sharded attention.

Port of deva_tpu/parallel/sharded_attention.py on torch.distributed. The
long axis of DEVA is the memory bank: when it outgrows one card, the memory
tokens are sharded over a mesh axis and the partial top-k softmax readouts
are reduced across it. Per process, on its own token shard:

  - `sim_topk` (the hand-written kernel on a CUDA device) gives the local
    top-k candidate values and indices [Q, k]; no [Q, N/D] affinity is
    built;
  - one all_gather of the candidate values [Q, k] gives every process the
    global k-th value and the row max: the union of the shards' top-k holds
    the global top-k, so the k-th of the gathered values is the global k-th
    value;
  - the weights w = exp(v - row max) * [v >= k-th] of the local candidates;
    one all_reduce SUM of their sums gives the softmax denominator;
  - `topk_readout` (the kernel) reads the normalised weights' value rows of
    the local shard, and one all_reduce SUM adds the partial outputs.

Usage stays sharded with its tokens, as in deva_tpu.

Both top-k methods take this route. deva_tpu's 'approx' branch uses
lax.approx_max_k, which is exact top-k off the TPU, so the methods differ
there only in the similarity precision; the port's similarity is true f32
for both (TF32 stays off).

The one departure from deva_tpu: where more than k tokens of one shard tie
at the global k-th value, deva_tpu's dense `sim >= kth` admits them all,
while the local top-k keeps exactly k of them (the lowest indices). With
a unique k-th value per query row the supports are equal and the outputs
agree up to the order of the sums; deva_tpu's docstring accepts the same
kind of tie difference between its sharded and unsharded paths.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from deva_tpu_torch.config import resolve_topk_method
from deva_tpu_torch.ops.attention_kernels import sim_topk, topk_readout
from deva_tpu_torch.parallel.mesh import axis_group


def pad_tokens(n: int, n_shards: int) -> int:
    """Tokens per shard must be equal: n rounded up to a multiple of
    n_shards (the padding rows are marked invalid through `valid`)."""
    return -(-n // n_shards) * n_shards


def attend_mem_sharded(mk: torch.Tensor, ms: Optional[torch.Tensor],
                       values: torch.Tensor, qk: torch.Tensor,
                       qe: Optional[torch.Tensor], top_k: int,
                       valid: Optional[torch.Tensor], mesh,
                       axis: str = "data", method: str = "exact",
                       return_usage: bool = False):
    """deva_tpu's attend with the memory token axis sharded over `mesh`'s
    `axis`; call it on every process of the axis with that process's token
    shard.

    mk [n, Ck], ms [n] or None, values [n, O, Cv] (token-major, as every
    attention function of the port), valid [n] bool or None: this
    process's n = N/D tokens (pad N with pad_tokens and mark the padding
    invalid); qk [Q, Ck], qe [Q, Ck] or None: the queries, the same on
    every process. Returns out [O, Q, Cv] f32, the same on every process,
    and with return_usage this shard's usage [n]."""
    resolve_topk_method(method)  # both methods take the one route
    group, _, d = axis_group(mesh, axis)
    n, o, cv = values.shape
    if top_k > n:
        raise ValueError(f"top_k={top_k} must fit in one shard's {n} tokens")
    vals, idx = sim_topk(qk, qe, mk, ms, valid, top_k)  # [Q, k] local
    parts = [torch.empty_like(vals) for _ in range(d)]
    dist.all_gather(parts, vals, group=group)
    cand = torch.cat(parts, dim=-1)  # [Q, D*k]
    kth = torch.topk(cand, top_k, dim=-1).values[:, -1:]
    row_max = cand.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    e = torch.where(vals >= kth, torch.exp(vals - row_max), 0.0)
    denom = e.sum(dim=-1, keepdim=True)
    dist.all_reduce(denom, group=group)
    w = e / denom.clamp_min(1e-30)
    out = topk_readout(idx, w, values.reshape(n, o * cv))  # [Q, O*Cv]
    dist.all_reduce(out, group=group)
    out = out.reshape(-1, o, cv).transpose(0, 1)
    if return_usage:
        usage = torch.zeros((n,), dtype=torch.float32, device=qk.device)
        usage.index_add_(0, idx.reshape(-1).long(), w.reshape(-1))
        return out, usage
    return out
