"""Layers with flax's `dtype=` semantics, and the switch that sets it.

deva_tpu builds every conv and dense layer with `dtype=compute_dtype`
(deva_tpu/config.py:ModelConfig.compute_dtype): the parameters stay f32,
and each call casts its input, kernel and bias to the compute dtype and
returns the compute dtype. These subclasses of nn.Conv2d and nn.Linear do
the same, so a bf16 model keeps upstream's state-dict keys and f32 weights.
At f32 they are nn.Conv2d and nn.Linear exactly. torch.autocast is not used:
it places its casts elsewhere (adds, normalisation, interpolation), and the
port follows deva_tpu's placement.

A module that casts declares a class attribute `compute_dtype`;
`set_compute_dtype` sets it on every such module of a tree. A plain
nn.Conv2d (the decoder's f32 prediction conv) has none and stays f32.

Each call casts the weights anew, as deva_tpu's jitted step does: keeping
bf16 copies of the weights cost 132 MiB of device memory at 480p and
moved no frame time beyond the host's spread on the H100 (PERF.md §5).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _cast(p: Optional[torch.Tensor],
          dtype: torch.dtype) -> Optional[torch.Tensor]:
    return p if p is None or p.dtype == dtype else p.to(dtype)


# Benchmark reference copy. One addition, for the control of the
# correctness check (a bf16 configuration's step down): `set_fp8` makes
# every conv and dense layer of a bf16 model quantise its input and weight
# to float8 e4m3, each with one scale per tensor (its largest magnitude
# maps to e4m3's largest finite value), and widen them back to bf16 before
# the bf16 product: an fp8 path with per-tensor scales, emulated. Biases
# stay bf16.
FP8 = torch.float8_e4m3fn


def _fp8(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = p.detach().abs().amax().float().clamp(min=1e-30) / \
        torch.finfo(FP8).max
    return ((p.float() / scale).to(FP8).float() * scale).to(dtype)


def _operands(layer, x, dt):
    if layer.fp8:
        return _fp8(x, dt), _fp8(layer.weight, dt)
    return x.to(dt), _cast(layer.weight, dt)


def set_fp8(module: nn.Module) -> nn.Module:
    """Every conv and dense layer of the tree that casts to a compute
    dtype quantises its operands to float8 first (see above)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.fp8 = True
    return module


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in `compute_dtype` (see the module note)."""
    compute_dtype = torch.float32
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(*_operands(self, x, dt),
                                  _cast(self.bias, dt))


class Linear(nn.Linear):
    """nn.Linear that computes in `compute_dtype` (see the module note)."""
    compute_dtype = torch.float32
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(*_operands(self, x, dt), _cast(self.bias, dt))


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every module of the tree that declares `compute_dtype` computes in
    `dtype` from now on. Returns the module."""
    for m in module.modules():
        if hasattr(type(m), "compute_dtype"):
            m.compute_dtype = dtype
    return module
