"""Training losses: bootstrapped CE (hard-pixel mining with warm-up), dice,
and the stride-16 aux CE.

Port of deva_tpu/training/losses.py (reference:deva/model/losses.py:9-78).
Padded object channels (selector 0) get -1e9 logits, so they vanish from
the softmax, as deva_tpu does in place of the reference's per-sample class
slicing. `it` is a host int here, so the top-p hardest pixels of each
sample are a torch.topk with a host k: the same set as deva_tpu's sort and
masked prefix, summed in another order.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def _masked_ce(logits: torch.Tensor, cls_gt: torch.Tensor,
               selector: torch.Tensor) -> torch.Tensor:
    """logits [B, C, H, W] (C = 1 + max_obj); cls_gt [B, H, W] int;
    selector [B, max_obj] (1 = real object) -> per-pixel CE [B, H, W]."""
    chan_mask = selector[:, :, None, None] > 0
    logits = torch.cat([logits[:, :1], logits[:, 1:].masked_fill(
        ~chan_mask, -1e9)], dim=1)
    logp = F.log_softmax(logits, dim=1)
    return -torch.gather(logp, 1, cls_gt[:, None].long())[:, 0]


def top_p(it: int, start_warm: int, end_warm: int,
          p: float = 0.3) -> np.float32:
    """The share of hardest pixels the bootstrapped CE keeps at iteration
    `it`: all of them before start_warm, `p` after end_warm, linear in
    between; in f32, rounded where deva_tpu's jitted step rounds."""
    if it < start_warm:
        return np.float32(1.0)
    if it > end_warm:
        return np.float32(p)
    ramp = np.float32(end_warm - it) / np.float32(end_warm - start_warm)
    return np.float32(p) + np.float32(1 - p) * ramp


def bootstrapped_ce(logits: torch.Tensor, cls_gt: torch.Tensor,
                    selector: torch.Tensor, it: int, start_warm: int,
                    end_warm: int, top_p_final: float = 0.3):
    """-> (loss, this_p). The top-p pixels are chosen per sample and each
    sample's mean enters the batch mean (reference:deva/model/losses.py:
    24-45), so hard pixels in one clip cannot crowd out another's."""
    b = logits.shape[0]
    raw = _masked_ce(logits, cls_gt, selector).reshape(b, -1)
    n = raw.shape[1]
    this_p = top_p(it, start_warm, end_warm, top_p_final)
    # floor(n * p) in f32, as deva_tpu; a share that rounds to 0 keeps no
    # pixel and the sample's mean is 0
    k = int(np.floor(np.float32(n) * this_p))
    if k >= n:
        per_sample = raw.mean(dim=1)
    elif k <= 0:
        per_sample = raw.new_zeros(b)
    else:
        per_sample = torch.topk(raw, k, dim=1, sorted=False).values.mean(1)
    return per_sample.mean(), this_p


def dice_loss(masks: torch.Tensor, cls_gt: torch.Tensor) -> torch.Tensor:
    """masks [B, max_obj, H, W] probabilities (no background); cls_gt
    [B, H, W]. Padded channels are averaged in, contributing about 0, as
    in the reference (losses.py:9-20)."""
    b, o = masks.shape[:2]
    m = masks.reshape(b, o, -1)
    gt = F.one_hot(cls_gt.reshape(b, -1).long(), o + 1).to(m.dtype)
    gt = gt[..., 1:].transpose(1, 2)  # [B, O, HW]
    numerator = 2 * (m * gt).sum(-1)
    denominator = m.sum(-1) + gt.sum(-1)
    return (1 - (numerator + 1) / (denominator + 1)).mean()


def compute_losses(outputs: Dict, cls_gt_all: torch.Tensor,
                   selector: torch.Tensor, it: int, *, start_warm: int,
                   end_warm: int) -> Dict[str, torch.Tensor]:
    """outputs: {'logits': [T-1, B, C, H, W], 'masks': [T-1, B, O, H, W],
    'aux_logits': [T-1, B, C, H, W]}; cls_gt_all [B, T, H, W].
    Per frame: bootstrapped CE + 0.1 * aux CE + dice
    (reference:deva/model/losses.py:54-78). 'p' is a host float."""
    losses = {}
    total = 0.0
    p_sum = 0.0
    t_minus_1 = outputs["logits"].shape[0]
    for i in range(t_minus_1):
        ti = i + 1
        cls_gt = cls_gt_all[:, ti]
        ce, p = bootstrapped_ce(outputs["logits"][i], cls_gt, selector, it,
                                start_warm, end_warm)
        aux = _masked_ce(outputs["aux_logits"][i], cls_gt, selector).mean()
        dice = dice_loss(outputs["masks"][i], cls_gt)
        losses[f"ce_loss_{ti}"] = ce
        losses[f"aux_loss_{ti}"] = aux
        losses[f"dice_loss_{ti}"] = dice
        p_sum = p_sum + float(p) / t_minus_1
        total = total + ce + 0.1 * aux + dice
    losses["p"] = p_sum
    losses["total_loss"] = total
    return losses
