"""Center-pad spatial dims to a multiple of d, and undo it.

Port of deva_tpu/ops/pad.py. The pad tuple keeps the reference ordering
(left_w, right_w, top_h, bottom_h), and the padding is centred: a width of
854 becomes 864 with 5 columns on each side.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_amounts(h: int, w: int, d: int) -> Tuple[int, int, int, int]:
    """(left_w, right_w, top_h, bottom_h), reference pad_array ordering."""
    new_h = h + (d - h % d) % d
    new_w = w + (d - w % d) % d
    lh = (new_h - h) // 2
    uh = (new_h - h) - lh
    lw = (new_w - w) // 2
    uw = (new_w - w) - lw
    return (lw, uw, lh, uh)


def pad_divide_by(x: torch.Tensor, d: int, h_axis: int, w_axis: int):
    """Zero-pad axes (h_axis, w_axis) of x up to multiples of d, centred.

    Returns (padded, pad) with pad = (lw, uw, lh, uh) like the reference.
    """
    h_axis %= x.ndim
    w_axis %= x.ndim
    lw, uw, lh, uh = pad_amounts(x.shape[h_axis], x.shape[w_axis], d)
    # F.pad takes (before, after) pairs from the last axis backwards
    pads = [0] * (2 * x.ndim)
    for axis, (lo, hi) in ((h_axis, (lh, uh)), (w_axis, (lw, uw))):
        pads[2 * (x.ndim - 1 - axis)] = lo
        pads[2 * (x.ndim - 1 - axis) + 1] = hi
    return F.pad(x, pads), (lw, uw, lh, uh)


def unpad(x: torch.Tensor, pad: Tuple[int, int, int, int], h_axis: int,
          w_axis: int) -> torch.Tensor:
    lw, uw, lh, uh = pad
    idx = [slice(None)] * x.ndim
    if lh + uh > 0:
        idx[h_axis] = slice(lh, x.shape[h_axis] - uh)
    if lw + uw > 0:
        idx[w_axis] = slice(lw, x.shape[w_axis] - uw)
    return x[tuple(idx)]
