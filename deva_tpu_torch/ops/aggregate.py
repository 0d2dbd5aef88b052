"""Soft-aggregation of per-object probabilities into joint logits, and the
argmax that hands a prediction to the host as ids.

Port of deva_tpu/ops/aggregate.py: background prob = prod(1 - p_i); concat;
clamp to [1e-7, 1-1e-7]; logit transform. Always computed in float32.
"""
from __future__ import annotations

import numpy as np
import torch


def argmax_ids(prob: torch.Tensor) -> np.ndarray:
    """[C, H, W] probabilities or logits (a tensor on any device) -> host
    uint8 (C <= 256) or int32 argmax ids over C, reduced on the tensor's
    device and moved to the host in one copy: 4*C times fewer bytes than
    the f32 tensor. torch.argmax returns the first maximum, as np.argmax
    does (deva_tpu/inference/result_saver.py:device_argmax_ids)."""
    dt = torch.uint8 if prob.shape[0] <= 256 else torch.int32
    return torch.argmax(prob, dim=0).to(dt).cpu().numpy()


def aggregate_logits(prob: torch.Tensor, axis: int) -> torch.Tensor:
    """prob: per-object probabilities in [0,1]; returns logits with a
    prepended background channel along `axis`."""
    prob = prob.float()
    bg = torch.prod(1.0 - prob, dim=axis, keepdim=True)
    new_prob = torch.cat([bg, prob], dim=axis).clamp(1e-7, 1 - 1e-7)
    return torch.log(new_prob / (1.0 - new_prob))
