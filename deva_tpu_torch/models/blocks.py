"""Network blocks, NCHW; grouped tensors carry an object axis: [B, O, C, H, W].

Port of deva_tpu/models/blocks.py. Module and parameter names reproduce
upstream DEVA's state-dict keys (the ones deva_tpu/models/convert.py maps),
e.g. `fuser.attention.ChannelGate.mlp.1.weight` or `sensory_update.transform
.weight` (a GConv2D is an nn.Conv2d itself, with no inner `conv`).

deva_tpu's `_SharedCatResBlock` (blocks.py:163-204) is a TPU rescheduling of
a GroupResBlock over cat([x broadcast over objects, g]); it has that block's
parameters. Here the block computes the plain concatenated conv, upstream's
form; the two differ by float summation order only.

Dtypes follow flax's `dtype=` (models/layers.py): every conv and dense
layer computes in the compute dtype, and the blocks cast where deva_tpu's
cast (deva_tpu/models/blocks.py:95,181-182,267-268), so residual adds, CBAM
and the upsample run in the compute dtype. The GRU takes its gates in the
compute dtype and the sensory state h in f32, so the new state is f32 by
promotion (deva_tpu/models/blocks.py:301-307).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from deva_tpu_torch.models.layers import Conv2d, Linear
from deva_tpu_torch.ops.resize import upsample_bilinear


def distribute_cat(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Broadcast frame features x [B, C, H, W] over the objects of
    g [B, O, Cg, H, W] and concatenate on channels, x first."""
    o = g.shape[1]
    x = x[:, None].expand(-1, o, -1, -1, -1)
    return torch.cat([x, g], dim=2)


class GConv2D(Conv2d):
    """Conv over grouped tensors (object axis folded into the batch)."""

    def forward(self, g: torch.Tensor) -> torch.Tensor:
        b, o = g.shape[:2]
        out = super().forward(g.flatten(0, 1))
        return out.view(b, o, *out.shape[1:])


class GroupResBlock(nn.Module):
    """Pre-activation residual block over grouped tensors, with a 1x1
    projection shortcut when channels change. The input is cast to the
    compute dtype first, so the residual add runs in it."""
    compute_dtype = torch.float32

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.downsample = GConv2D(in_dim, out_dim, 1) \
            if in_dim != out_dim else None
        self.conv1 = GConv2D(in_dim, out_dim, 3, padding=1)
        self.conv2 = GConv2D(out_dim, out_dim, 3, padding=1)

    def forward(self, g: torch.Tensor) -> torch.Tensor:
        g = g.to(self.compute_dtype)
        out = self.conv1(F.relu(g))
        out = self.conv2(F.relu(out))
        if self.downsample is not None:
            g = self.downsample(g)
        return out + g


class ChannelGate(nn.Module):
    def __init__(self, gate_channels: int, reduction_ratio: int = 16):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Flatten(), Linear(gate_channels,
                                 gate_channels // reduction_ratio),
            nn.ReLU(), Linear(gate_channels // reduction_ratio,
                              gate_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=(2, 3))
        mx = x.amax(dim=(2, 3))
        att = self.mlp(avg) + self.mlp(mx)
        return x * torch.sigmoid(att)[:, :, None, None]


class BasicConv(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, kernel_size: int):
        super().__init__()
        self.conv = Conv2d(in_planes, out_planes, kernel_size,
                           padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class SpatialGate(nn.Module):
    def __init__(self):
        super().__init__()
        self.spatial = BasicConv(2, 1, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        compress = torch.cat([x.amax(dim=1, keepdim=True),
                              x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial(compress))


class CBAM(nn.Module):
    """Channel gate (avg+max pooled shared MLP), then a 7x7 spatial gate.
    Operates on folded [N, C, H, W]."""

    def __init__(self, gate_channels: int, reduction_ratio: int = 16):
        super().__init__()
        self.ChannelGate = ChannelGate(gate_channels, reduction_ratio)
        self.SpatialGate = SpatialGate()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SpatialGate(self.ChannelGate(x))


class GroupFeatureFusionBlock(nn.Module):
    """cat-distribute -> GroupResBlock -> CBAM residual -> GroupResBlock."""

    def __init__(self, x_in_dim: int, g_in_dim: int, mid_dim: int,
                 out_dim: int):
        super().__init__()
        self.block1 = GroupResBlock(x_in_dim + g_in_dim, mid_dim)
        self.attention = CBAM(mid_dim)
        self.block2 = GroupResBlock(mid_dim, out_dim)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        b, o = g.shape[:2]
        g = self.block1(distribute_cat(x, g))
        r = self.attention(g.flatten(0, 1))
        g = g + r.view(b, o, *r.shape[1:])
        return self.block2(g)


class KeyProjection(nn.Module):
    """Key / shrinkage / selection projections from pixel features.
    shrinkage = d_proj(x)^2 + 1; selection = sigmoid(e_proj(x))."""

    def __init__(self, in_dim: int, key_dim: int):
        super().__init__()
        self.key_proj = Conv2d(in_dim, key_dim, 3, padding=1)
        self.d_proj = Conv2d(in_dim, 1, 3, padding=1)
        self.e_proj = Conv2d(in_dim, key_dim, 3, padding=1)

    def forward(self, x: torch.Tensor, need_s: bool = True,
                need_e: bool = True):
        shrinkage = self.d_proj(x) ** 2 + 1.0 if need_s else None
        selection = torch.sigmoid(self.e_proj(x)) if need_e else None
        return self.key_proj(x), shrinkage, selection


class MaskUpsampleBlock(nn.Module):
    """x2 bilinear upsample of grouped features + skip add + GroupResBlock,
    in the compute dtype."""
    compute_dtype = torch.float32

    def __init__(self, up_dim: int, out_dim: int, scale_factor: int = 2):
        super().__init__()
        self.out_conv = GroupResBlock(up_dim, out_dim)
        self.scale_factor = scale_factor

    def forward(self, skip_f: torch.Tensor, up_g: torch.Tensor):
        dt = self.compute_dtype
        g = upsample_bilinear(up_g.to(dt), self.scale_factor)
        return self.out_conv(skip_f.to(dt)[:, None] + g)


class DecoderFeatureProcessor(nn.Module):
    """1x1 projections of the skip features."""

    def __init__(self, in_dims: Sequence[int], out_dims: Sequence[int]):
        super().__init__()
        self.transforms = nn.ModuleList(
            [Conv2d(i, o, 1) for i, o in zip(in_dims, out_dims)])

    def forward(self, multi_scale_features) -> List[torch.Tensor]:
        return [t(x) for t, x in zip(self.transforms, multi_scale_features)]


class LinearPredictor(nn.Module):
    """The training-only aux mask predictor: a per-object linear classifier
    over the frame features, whose weights (pix_dim of them and a bias) a
    1x1 GConv2D makes from the object's sensory state
    (deva_tpu/models/blocks.py:285-298)."""

    def __init__(self, x_dim: int, pix_dim: int):
        super().__init__()
        self.projection = GConv2D(x_dim, pix_dim + 1, 1)

    def forward(self, im_feat: torch.Tensor,
                pred_feat: torch.Tensor) -> torch.Tensor:
        """im_feat [B, Cp, h, w]; pred_feat [B, O, Cx, h, w]
        -> [B, O, 1, h, w] in the compute dtype."""
        params = self.projection(pred_feat)  # [B, O, Cp + 1, h, w]
        x = (im_feat[:, None].to(params.dtype) * params[:, :, :-1]).sum(
            dim=2, keepdim=True)
        return x + params[:, :, -1:]


def _gru_update(values: torch.Tensor, h: torch.Tensor,
                sensory_dim: int) -> torch.Tensor:
    """DEVA's GRU: the new value is made before the forget gate applies."""
    forget_gate = torch.sigmoid(values[:, :, :sensory_dim])
    update_gate = torch.sigmoid(values[:, :, sensory_dim:sensory_dim * 2])
    new_value = torch.tanh(values[:, :, sensory_dim * 2:])
    return forget_gate * h * (1.0 - update_gate) + update_gate * new_value


class SensoryUpdater(nn.Module):
    """Decoder-side multi-scale GRU update of the sensory memory. Takes all
    three scales already area-downsampled to stride 16, as deva_tpu does
    (blocks.py:310-333): area means commute with the 1x1 convs."""

    def __init__(self, g_dims: Sequence[int], mid_dim: int,
                 sensory_dim: int):
        super().__init__()
        self.sensory_dim = sensory_dim
        self.g16_conv = GConv2D(g_dims[0], mid_dim, 1)
        self.g8_conv = GConv2D(g_dims[1], mid_dim, 1)
        self.g4_conv = GConv2D(g_dims[2], mid_dim, 1)
        self.transform = GConv2D(mid_dim + sensory_dim, sensory_dim * 3, 3,
                                 padding=1)

    def forward(self, g16, g8, g4, h):
        g = self.g16_conv(g16) + self.g8_conv(g8) + self.g4_conv(g4)
        values = self.transform(torch.cat([g, h], dim=2))
        return _gru_update(values, h, self.sensory_dim)


class SensoryDeepUpdater(nn.Module):
    """Mask-encoder-side GRU update of the sensory memory."""

    def __init__(self, f_dim: int, sensory_dim: int):
        super().__init__()
        self.sensory_dim = sensory_dim
        self.transform = GConv2D(f_dim + sensory_dim, sensory_dim * 3, 3,
                                 padding=1)

    def forward(self, f, h):
        values = self.transform(torch.cat([f, h], dim=2))
        return _gru_update(values, h, self.sensory_dim)
