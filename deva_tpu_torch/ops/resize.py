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

And the resizes that stand in for PIL's and jax.image.resize's in the
detector layer (deva_tpu_torch/ext): resize_bilinear_aa (the antialiased
bilinear filter of both: in f64 within 1e-7 of PIL's mode "F", or in f32
as jax.image.resize computes) and resize_image_uint8 (PIL's 8-bit BILINEAR
resize, bit for bit, a few taps per output).
"""
from __future__ import annotations

import functools

import numpy as np
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


def resize_bilinear_aa(x: torch.Tensor, size,
                       dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Bilinear resize of the last two axes to `size` (h, w), antialiased
    when it shrinks (align_corners=False): the filter of PIL's BILINEAR
    resample and of jax.image.resize(method="bilinear"), whose triangle
    widens by the scale when it downsamples. Computed in `dtype` on the
    tensor's device -> f32: f64 (the default) stays within 1e-7 of PIL's
    mode "F"; f32 is jax.image.resize's precision. The same size returns
    the input unchanged, as PIL does."""
    h, w = x.shape[-2:]
    size = (int(size[0]), int(size[1]))
    if size == (h, w):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1, h, w)).to(dtype), size=size,
                      mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(lead + size).float()


# PIL's fixed-point precision for 8-bit resampling (Pillow's Resample.c:
# PRECISION_BITS = 32 - 8 - 2)
_PRECISION_BITS = 22


@functools.lru_cache(maxsize=64)
def _pil_taps(in_size: int, out_size: int):
    """PIL's BILINEAR taps from in_size to out_size, banded: -> (the first
    input of each output [out_size], the taps [out_size, K] in units of
    2^-22, zero past each output's window; K the widest window). Pillow's
    precompute_coeffs (the triangle filter widened by the scale when it
    shrinks, each row's taps normalised by their sequential sum, in double
    precision) and normalize_coeffs_8bpc (rounded half up to 22 fractional
    bits)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    rows = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
             for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        rows.append((xmin, [int(0.5 + (v / ww if ww != 0.0 else v)
                                * (1 << _PRECISION_BITS)) for v in w]))
    first = np.array([r[0] for r in rows], np.int64)
    taps = np.zeros((out_size, max(len(r[1]) for r in rows)), np.int64)
    for xx, (_, t) in enumerate(rows):
        taps[xx, :len(t)] = t
    return first, taps


def _resample(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """One of PIL's 8-bit passes along `axis` of a uint8 image: for each
    output, its window's inputs times its taps, summed with the rounding
    half, shifted down to a level and clamped to [0, 255] -> uint8. A gather
    and a multiply-add per tap of the widest window (a few taps: 2 when it
    grows, about 2 x the scale + 1 when it shrinks), in int32, which is
    exact: every product and partial sum lies below 2^31."""
    first, taps = _pil_taps(x.shape[axis], out_size)
    last = x.shape[axis] - 1
    first = torch.from_numpy(first).to(x.device)
    taps = torch.from_numpy(taps).to(device=x.device, dtype=torch.int32)
    shape = [1] * x.dim()
    shape[axis] = out_size
    acc = torch.full((), 1 << (_PRECISION_BITS - 1), dtype=torch.int32,
                     device=x.device)
    for k in range(taps.shape[1]):
        acc = acc + x.index_select(axis, (first + k).clamp_(max=last)) \
            .to(torch.int32) * taps[:, k].reshape(shape)
    return (acc >> _PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


def resize_image_uint8(image: torch.Tensor, size) -> torch.Tensor:
    """PIL's BILINEAR resize of a uint8 RGB image [H, W, 3] to `size`
    (h, w), bit for bit, on the tensor's device -> uint8 [h, w, 3].

    PIL resamples 8-bit images in fixed point: the width first, then the
    height, each pass summing pixel x tap in 22-bit fixed point and
    rounding half up to uint8. resize_bilinear_aa's f32 or f64 filter is
    the same filter without the fixed point: it gives one level more or
    less than PIL where a pass's exact value lies at a rounding tie (0.46%
    of the values of a 1280x720 frame shrunk to 213x120, 2.75% of a
    480x854 frame grown to 576x1024), and with random weights such input
    changes move whole objects' labels downstream. So the taps here are
    PIL's own integers (_pil_taps), applied in integers (_resample)."""
    h, w = image.shape[:2]
    size = (int(size[0]), int(size[1]))
    x = image
    if size[1] != w:  # the width first, as PIL
        x = _resample(x, 1, size[1])
    if size[0] != h:
        x = _resample(x, 0, size[0])
    return x
