"""Memory-attention math: anisotropic L2 similarity, top-k, readout.

Port of deva_tpu/ops/memory_attention.py, with the same tokens-major
layouts: keys [N, Ck], values [O, N, Cv], output [O, Q, Cv]. The
attention itself is ops/attention_kernels.py (exact) and
ops/approx_kernels.py (approx).

Similarity (XMem appendix): for memory key a (with shrinkage s) and query key
b with per-channel selection e:
    sim(a, b) = -s * sum_c e_c (a_c - b_c)^2 / sqrt(Ck)
expanded into two matmuls:  -a^2·e + 2 a·(b e) - sum(e b^2).

Matmuls run in true f32: on a CUDA device PyTorch leaves TF32 off for
matmuls unless told otherwise, and a top-k over the similarity is sensitive
to near-tie rounding.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def get_similarity(mk: torch.Tensor, ms: Optional[torch.Tensor],
                   qk: torch.Tensor, qe: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """mk [N, Ck], ms [N] or None, qk [Q, Ck], qe [Q, Ck] or None
    -> sim [Q, N] (query-major: the top-k reduces the last axis). A leading
    B on every tensor gives B videos' similarities [B, Q, N]."""
    ck = mk.shape[-1]
    mk = mk.float()
    qk = qk.float()
    mk_t = mk.transpose(-1, -2)
    if qe is not None:
        qe = qe.float()
        a_sq = qe @ (mk * mk).transpose(-1, -2)
        two_ab = 2.0 * ((qk * qe) @ mk_t)
        b_sq = torch.sum(qe * qk * qk, dim=-1, keepdim=True)
        sim = -a_sq + two_ab - b_sq
    else:
        a_sq = torch.sum(mk * mk, dim=-1)[..., None, :]
        two_ab = 2.0 * (qk @ mk_t)
        sim = -a_sq + two_ab
    if ms is not None:
        return sim * (ms.float()[..., None, :] / math.sqrt(ck))
    return sim / math.sqrt(ck)


def mask_invalid(sim: torch.Tensor, valid: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """-inf on the token slots where valid [N] (or [B, N] for sim [B, Q,
    N]) is False."""
    if valid is None:
        return sim
    return sim.masked_fill(~valid[..., None, :], float("-inf"))


def topk_sorted(x: torch.Tensor, k: int):
    """Top-k along the last axis, values descending and ties to the lowest
    index (lax.top_k's order). torch.topk promises no order among equal
    values; a stable descending sort does."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def softmax_topk_values(values: torch.Tensor) -> torch.Tensor:
    """Softmax over the k selected similarities [Q, K]. Shifting by the row
    max is the reference's unshifted exp up to rounding, without its
    all-underflow NaN; the max is clamped to 0 when the row holds no finite
    value (memory_attention.py:161-164 in deva_tpu). A row with no valid
    token at all still gives 0/0 = NaN, as in deva_tpu."""
    row_max = values[..., :1]
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    x_exp = torch.exp(values - row_max)
    return x_exp / torch.sum(x_exp, dim=-1, keepdim=True)


def full_softmax(sim: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense softmax over the token axis (consolidation / training path)."""
    sim = mask_invalid(sim, valid)
    maxes = torch.max(sim, dim=-1, keepdim=True).values
    x_exp = torch.exp(sim - maxes)
    return x_exp / torch.sum(x_exp, dim=-1, keepdim=True)


def readout(affinity: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """affinity [Q, N]; values [..., N, Cv] -> out [..., Q, Cv] (f32).
    The affinity is rounded down to the values' dtype, and the product is
    summed in f32 (deva_tpu/ops/memory_attention.py:184-194): on bf16 rings
    each term is a product of two bf16 numbers, exact in f32; f32 rings
    stay f32."""
    return torch.matmul(affinity.to(values.dtype).float(), values.float())
