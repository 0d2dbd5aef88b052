"""Resize ops with the reference's F.interpolate semantics, on the last two
axes ([..., H, W], NCHW style).

Port of deva_tpu/ops/resize.py (which works on NHWC):
- area downsampling by an integer factor is average pooling (exact), in the
  input's dtype;
- bilinear upsampling with align_corners=False by an integer factor equals
  the JAX 2-tap stencil (deva_tpu/ops/resize.py:46-92). A bf16 input is
  upsampled in bf16 (deva_tpu/ops/resize.py:57-64), every other dtype in
  f32; the result has the input's dtype. deva_tpu rounds the stencil to
  bf16 after each multiply and add, F.interpolate once per output, so the
  two differ by a few bf16 ulps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def downsample_area(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool the last two axes by an integer factor."""
    h, w = x.shape[-2:]
    if h % factor or w % factor:
        raise ValueError(f"shape {tuple(x.shape)} not divisible by {factor}")
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape((-1, 1, h, w)), factor)
    return y.reshape(lead + y.shape[-2:])


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear (align_corners=False) upsample of the last two axes by an
    integer factor."""
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    cdt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    y = F.interpolate(x.reshape((-1, 1, h, w)).to(cdt), scale_factor=factor,
                      mode="bilinear", align_corners=False)
    return y.reshape(lead + y.shape[-2:]).to(x.dtype)
