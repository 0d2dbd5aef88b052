"""Soft-aggregation of per-object probabilities into joint logits.

Port of deva_tpu/ops/aggregate.py: background prob = prod(1 - p_i); concat;
clamp to [1e-7, 1-1e-7]; logit transform. Always computed in float32.
"""
from __future__ import annotations

import torch


def aggregate_logits(prob: torch.Tensor, axis: int) -> torch.Tensor:
    """prob: per-object probabilities in [0,1]; returns logits with a
    prepended background channel along `axis`."""
    prob = prob.float()
    bg = torch.prod(1.0 - prob, dim=axis, keepdim=True)
    new_prob = torch.cat([bg, prob], dim=axis).clamp(1e-7, 1 - 1e-7)
    return torch.log(new_prob / (1.0 - new_prob))
