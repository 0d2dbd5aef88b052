"""Soft-aggregation of per-object probabilities into joint logits, and the
argmax that hands a prediction to the host as ids.

Port of deva_tpu/ops/aggregate.py: background prob = prod(1 - p_i); concat;
clamp to [1e-7, 1-1e-7]; logit transform. Always computed in float32. Under
object sharding (parallel/object_sharding.py) the product runs over every
process's objects: a local product and one all_reduce.
"""
from __future__ import annotations

import numpy as np
import torch

from deva_tpu_torch.parallel.object_sharding import object_product


def argmax_ids(prob: torch.Tensor, dim: int = 0) -> np.ndarray:
    """[C, H, W] probabilities or logits (a tensor on any device; C on axis
    `dim`, e.g. [B, C, H, W] with dim=1) -> host uint8 (C <= 256) or int32
    argmax ids over C, reduced on the tensor's device and moved to the host
    in one copy: 4*C times fewer bytes than the f32 tensor. torch.argmax
    returns the first maximum, as np.argmax does
    (deva_tpu/inference/result_saver.py:device_argmax_ids)."""
    dt = torch.uint8 if prob.shape[dim] <= 256 else torch.int32
    return torch.argmax(prob, dim=dim).to(dt).cpu().numpy()


def aggregate_logits(prob: torch.Tensor, axis: int,
                     group=None) -> torch.Tensor:
    """prob: per-object probabilities in [0,1]; returns logits with a
    prepended background channel along `axis`. group: the object axis's
    process group when prob holds this process's objects only; the
    background then covers every process's."""
    prob = prob.float()
    bg = object_product(1.0 - prob, axis, group)
    new_prob = torch.cat([bg, prob], dim=axis).clamp(1e-7, 1 - 1e-7)
    return torch.log(new_prob / (1.0 - new_prob))
