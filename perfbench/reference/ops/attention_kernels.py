"""Fused exact top-k memory attention: similarity + masked top-k, softmax over
the k values, sparse readout, usage. No dense [Q, N] matrix is built.

Port of the exact path of deva_tpu/ops/pallas_attention.py (`sim_topk`,
`topk_readout`, `attend_pallas`). Each function has its plain PyTorch twin
here (`*_plain`), with the same semantics:

- `sim_topk` -> (values [Q, K] descending, indices [Q, K] int32), with
  K = min(top_k, N): a ring of fewer tokens than top_k keeps all of them
  (as deva_tpu's Pallas route, which pads N and softmaxes over the real
  tokens), and an empty ring raises, on both devices. Ties go to the lowest
  index. Invalid slots are -inf; in a row with fewer valid tokens than K
  the -inf slots carry the lowest invalid indices, so every index is in
  range.
- `topk_readout` -> out[q] = sum_k w[q, k] * V[idx[q, k]], [Q, C] f32. The
  ring V may be one [N, C] tensor or a pair of segments (V_a, V_b), read in
  place: row i is V_a[i] for i < n_a, else V_b[i - n_a].
- `attend_topk` -> the composite of `attend_pallas`: out [O, Q, Cv] and,
  optionally, per-token usage [N] (the scatter-add of the weights). Its
  values may likewise be a pair of [n_i, O, Cv] rings ([long-term ;
  working]), which it never concatenates.

A video axis: every function also takes B videos at once, each with its
own rings (the batched propagator's lockstep step): qk/qe [B, Q, Ck], mk
[B, N, Ck], ms and valid [B, N], values [B, N, O, Cv] (or two segments
[B, n_a, O, Cv], [B, n_b, O, Cv]), indices and weights [B, Q, K]; results
gain the same leading B (out [B, O, Q, Cv], usage [B, N]). Indices are local
to their video. On a CUDA device one launch of each kernel serves all B
videos (a grid dimension, per-video bases), and each video's result is
bitwise that of its own launch; 2-D calls are the single-video form.

Ring dtypes: the rings (mk, ms and the value segments) may be f32 or bf16,
one dtype per call; the queries qk and qe f32 or bf16, widened to f32 by
the wrapper (Q x Ck, small). On bf16 rings sim_topk widens each key at
load, exactly, and topk_readout rounds each weight to bf16 before the
product (deva_tpu's `aff.astype(v_ref.dtype)`,
pallas_attention.py:265) and sums in f32; the twins do the same. Any other
dtype raises: a wrapper never casts a ring to make a call work.

Benchmark reference copy: only the plain twins are kept, on every device.
The entry points (`sim_topk`, `topk_readout`, `attend_topk`) call them, so
the reference launches no hand-written kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from reference.ops import memory_attention as ma

def _videos(t: torch.Tensor, ndim: int):
    """The leading video shape of t: () for the single-video form (ndim
    dimensions), (B,) for B videos (ndim + 1); raises for anything else."""
    if t.dim() == ndim:
        return ()
    if t.dim() == ndim + 1:
        return (t.shape[0],)
    raise ValueError(f"expected {ndim} or {ndim + 1} dimensions, got "
                     f"{tuple(t.shape)}")


# --------------------------------------------------------------------------
# sim_topk
# --------------------------------------------------------------------------

def _check_ring(n: int) -> None:
    if n == 0:
        raise ValueError("sim_topk: the ring holds no token")


def sim_topk_plain(qk, qe, mk, ms, valid, top_k: int):
    """Plain twin of sim_topk: the dense similarity and a stable sort (which
    keeps min(top_k, N) entries), per video when given B."""
    _check_ring(mk.shape[-2])
    sim = ma.mask_invalid(ma.get_similarity(mk, ms, qk, qe), valid)
    values, indices = ma.topk_sorted(sim, top_k)
    return values, indices.to(torch.int32)


def sim_topk(qk: torch.Tensor, qe: Optional[torch.Tensor], mk: torch.Tensor,
             ms: Optional[torch.Tensor], valid: Optional[torch.Tensor],
             top_k: int):
    """Exact masked top-k of the (never materialized) similarity.
    qk/qe: [Q, Ck]; mk: [N, Ck]; ms: [N] or None; valid: [N] bool or None
    (each with a leading B for B videos). Returns (values [Q, K] sorted
    descending, indices [Q, K] int32), K = min(top_k, N); raises for an
    empty ring."""
    return sim_topk_plain(qk, qe, mk, ms, valid, top_k)


# --------------------------------------------------------------------------
# topk_readout
# --------------------------------------------------------------------------

def _segments(values):
    """A ring given as one tensor or as a pair of segments -> a tuple."""
    return tuple(values) if isinstance(values, (tuple, list)) else (values,)


def _rows(seg: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """seg [..., n, C] at row indices local [..., Q, K] (in [0, n)), f32
    -> [..., Q, K, C]; per video when seg has a leading B."""
    seg = seg.float()
    if seg.dim() == 2:
        return seg[local]
    videos = torch.arange(seg.shape[0], device=seg.device)[:, None, None]
    return seg[videos, local]


def topk_readout_plain(indices, weights, values):
    """Plain twin of topk_readout: gather the k rows and sum. With two
    segments each row is gathered from its own segment by index arithmetic,
    so the result is bitwise that on the concatenated ring. Indices outside
    the ring contribute nothing. Each weight is rounded to the ring's dtype
    before the product."""
    idx = indices.long()
    rows, start = None, 0  # rows: [..., Q, K, C]
    for seg in _segments(values):
        n = seg.shape[-2]
        if n:
            local = idx - start
            got = _rows(seg, local.clamp(0, n - 1))
            rows = got if rows is None else torch.where(
                ((local >= 0) & (local < n))[..., None], got, rows)
        start += n
    w = weights.to(_segments(values)[0].dtype).float()
    w = torch.where((idx >= 0) & (idx < start), w, torch.zeros_like(w))
    return torch.einsum("...qk,...qkc->...qc", w, rows)


def topk_readout(indices: torch.Tensor, weights: torch.Tensor,
                 values) -> torch.Tensor:
    """indices/weights: [Q, K] (token ids and weights); values: the ring,
    [N, C] (token-major, C = O*Cv), or a pair of segments [n_a, C], [n_b, C]
    read as their concatenation. Returns [Q, C] f32. With a leading B on
    every tensor, B videos at once."""
    return topk_readout_plain(indices, weights, values)


# --------------------------------------------------------------------------
# the composite
# --------------------------------------------------------------------------

def _attend(select, read, mk, ms, values, qk, qe, top_k, valid,
            return_usage):
    segs = _segments(values)
    lead = _videos(qk, 2)
    o, cv = segs[0].shape[-2:]
    n = sum(v.shape[-3] for v in segs)
    q = qk.shape[-2]
    gv, gi = select(qk, qe, mk, ms, valid, top_k)
    w = ma.softmax_topk_values(gv)
    flat = tuple(v.reshape(*v.shape[:-2], o * cv) for v in segs)  # views
    out = read(gi, w, flat[0] if len(flat) == 1 else flat)
    out = out.reshape(*lead, q, o, cv).transpose(-3, -2)
    if return_usage:
        usage = torch.zeros((*lead, n), dtype=torch.float32,
                            device=qk.device)
        if lead:  # each video's usage in its own row
            at = gi.long() + n * torch.arange(lead[0], device=qk.device)[
                :, None, None]
            usage.view(-1).index_add_(0, at.reshape(-1), w.reshape(-1))
        else:
            usage.index_add_(0, gi.reshape(-1).long(), w.reshape(-1))
        return out, usage
    return out


def attend_topk(mk: torch.Tensor, ms: Optional[torch.Tensor],
                values: torch.Tensor, qk: torch.Tensor,
                qe: Optional[torch.Tensor], top_k: int,
                valid: Optional[torch.Tensor] = None,
                return_usage: bool = False):
    """Exact top-k attention with no dense [Q, N] affinity (the composite of
    pallas_attention.attend_pallas). values: [N, O, Cv] token-major, or a
    pair of rings [n_a, O, Cv], [n_b, O, Cv] read in place as their
    concatenation (mk, ms and valid cover all n_a + n_b tokens). Returns out
    [O, Q, Cv] (f32) and optionally the per-token usage [N]. With a leading
    B on every tensor, B videos in one launch of each kernel (out [B, O, Q,
    Cv], usage [B, N])."""
    return _attend(sim_topk, topk_readout, mk, ms, values, qk, qe, top_k,
                   valid, return_usage)
