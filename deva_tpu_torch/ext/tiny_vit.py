"""TinyViT image encoder (MobileSAM / Light-HQ-SAM) as a torch module.

Port of deva_tpu/ext/tiny_vit.py. The module tree and parameter names are
those of MobileSAM's `tiny_vit_sam` (the keys that
deva_tpu/ext/tiny_vit.py:convert_tiny_vit_statedict reads), so a released
MobileSAM image encoder loads with load_state_dict and a seeded port
encoder converts to its deva_tpu twin:

  patch_embed.seq.{0,2}.{c,bn}             two stride-2 3x3 ConvBN (H/4)
  layers.0.blocks.{j}.conv{1,2,3}          MBConv blocks
  layers.{i}.downsample.conv{1,2,3}        PatchMerging (stride 1 into the
                                           320-channel stage: H/16 stays)
  layers.{i}.blocks.{j}.attn.{norm,qkv,proj,attention_biases}
  layers.{i}.blocks.{j}.local_conv         depthwise ConvBN
  layers.{i}.blocks.{j}.mlp.{norm,fc1,fc2}
  neck.{0,1,2,3}                           1x1 conv, LayerNorm2d, 3x3 conv,
                                           LayerNorm2d (256 channels)

Inference only (eval mode: BatchNorm on running statistics, no DropPath).
NCHW: input [B, 3, H, W] (H, W multiples of 32), output [B, 256, H/16,
W/16]; with return_interm also the post-stage-1 features [B, 160, H/16,
W/16] that Light-HQ-SAM's decoder fuses. GELU is the exact erf form. A
window block pads its grid to whole windows with zero tokens, which go
through the LayerNorm and take part in the attention unmasked, as in
deva_tpu (deva_tpu/ext/tiny_vit.py:166-193). The classifier head of
MobileSAM's TinyViT (norm_head, head) is not built: the SAM encoder never
runs it (mobile_sam.MobileSAM.from_checkpoint drops its keys).
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBN(nn.Sequential):
    """Conv (no bias) + BatchNorm: children `c` and `bn`."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 pad: int = 0, groups: int = 1):
        super().__init__()
        self.add_module("c", nn.Conv2d(cin, cout, kernel, stride, pad,
                                       groups=groups, bias=False))
        self.add_module("bn", nn.BatchNorm2d(cout, eps=1e-5))


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, embed_dim: int):
        super().__init__()
        self.seq = nn.Sequential(ConvBN(cin, embed_dim // 2, 3, 2, 1),
                                 nn.GELU(),
                                 ConvBN(embed_dim // 2, embed_dim, 3, 2, 1))

    def forward(self, x):
        return self.seq(x)


class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, expand_ratio: float):
        super().__init__()
        hidden = int(cin * expand_ratio)
        self.conv1 = ConvBN(cin, hidden)
        self.conv2 = ConvBN(hidden, hidden, 3, 1, 1, groups=hidden)
        self.conv3 = ConvBN(hidden, cout)

    def forward(self, x):
        y = F.gelu(self.conv1(x))
        y = F.gelu(self.conv2(y))
        return F.gelu(self.conv3(y) + x)


class PatchMerging(nn.Module):
    """Stride 1 (not 2) into the 320/448/576-channel stage, so the final
    grid stays at stride 16."""

    def __init__(self, cin: int, out_dim: int):
        super().__init__()
        stride = 1 if out_dim in (320, 448, 576) else 2
        self.conv1 = ConvBN(cin, out_dim)
        self.conv2 = ConvBN(out_dim, out_dim, 3, stride, 1, groups=out_dim)
        self.conv3 = ConvBN(out_dim, out_dim)

    def forward(self, x):
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x))
        return self.conv3(x)


def attention_bias_idxs(resolution: Tuple[int, int]):
    """The static relative-offset index table [N, N] and the number of
    distinct offsets (deva_tpu/ext/tiny_vit.py:95-108)."""
    points = list(itertools.product(range(resolution[0]),
                                    range(resolution[1])))
    offsets, idxs = {}, []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return torch.tensor(idxs, dtype=torch.long).view(n, n), len(offsets)


class Attention(nn.Module):
    """Multi-head attention with learned relative position biases over one
    window of tokens [B, N, C]."""

    def __init__(self, dim: int, key_dim: int, num_heads: int,
                 resolution: Tuple[int, int]):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.scale = key_dim ** -0.5
        self.d = key_dim  # attn_ratio 1
        dh = self.d * num_heads
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, dh + 2 * key_dim * num_heads)
        self.proj = nn.Linear(dh, dim)
        idxs, n_offsets = attention_bias_idxs(resolution)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads,
                                                         n_offsets))
        self.register_buffer("attention_bias_idxs", idxs, persistent=False)

    def forward(self, x):
        b, n, _ = x.shape
        qkv = self.qkv(self.norm(x)).view(b, n, self.num_heads, -1)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.d], dim=3)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, N, d]
        attn = (q @ k.transpose(-2, -1)) * self.scale
        attn = attn + self.attention_biases[:, self.attention_bias_idxs]
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(b, n, -1)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class TinyViTBlock(nn.Module):
    """Window attention + depthwise local conv + MLP, on NCHW."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 mlp_ratio: float, local_conv_size: int):
        super().__init__()
        self.window_size = window_size
        self.attn = Attention(dim, dim // num_heads, num_heads,
                              (window_size, window_size))
        self.local_conv = ConvBN(dim, dim, local_conv_size, 1,
                                 local_conv_size // 2, groups=dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):  # [B, C, H, W]
        b, c, h, w = x.shape
        ws = self.window_size
        t = x.permute(0, 2, 3, 1)  # [B, H, W, C]
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            t = F.pad(t, (0, 0, 0, pad_r, 0, pad_b))
        ph, pw = h + pad_b, w + pad_r
        nh, nw = ph // ws, pw // ws
        t = t.reshape(b, nh, ws, nw, ws, c).transpose(2, 3)
        t = self.attn(t.reshape(b * nh * nw, ws * ws, c))
        t = t.reshape(b, nh, nw, ws, ws, c).transpose(2, 3)
        t = t.reshape(b, ph, pw, c)[:, :h, :w]
        x = x + t.permute(0, 3, 1, 2)
        x = self.local_conv(x)
        t = x.permute(0, 2, 3, 1)
        return (t + self.mlp(t)).permute(0, 3, 1, 2)


class ConvLayer(nn.Module):
    """Stage 0: MBConv blocks, then the merge into stage 1."""

    def __init__(self, dim: int, out_dim: int, depth: int,
                 expand_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(MBConv(dim, dim, expand_ratio)
                                    for _ in range(depth))
        self.downsample = PatchMerging(dim, out_dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class BasicLayer(nn.Module):
    """A transformer stage, then the merge into the next (none after the
    last)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float, local_conv_size: int,
                 out_dim: int = 0):
        super().__init__()
        self.blocks = nn.ModuleList(
            TinyViTBlock(dim, num_heads, window_size, mlp_ratio,
                         local_conv_size) for _ in range(depth))
        self.downsample = PatchMerging(dim, out_dim) if out_dim else None

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class LayerNorm2d(nn.Module):
    """segment_anything's channel-wise LayerNorm over NCHW."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class TinyViT(nn.Module):
    """Defaults are MobileSAM's TinyViT-5M (64/128/160/320 wide, depths
    2/2/6/2). forward(x [B, 3, H, W], return_interm=False) ->
    [B, 256, H/16, W/16] (and [B, embed_dims[2], H/16, W/16])."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 160, 320),
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (2, 4, 5, 10),
                 window_sizes: Sequence[int] = (7, 7, 14, 7),
                 mlp_ratio: float = 4.0, mbconv_expand_ratio: float = 4.0,
                 local_conv_size: int = 3, in_chans: int = 3):
        super().__init__()
        self.patch_embed = PatchEmbed(in_chans, embed_dims[0])
        layers = [ConvLayer(embed_dims[0], embed_dims[1], depths[0],
                            mbconv_expand_ratio)]
        for i in range(1, len(depths)):
            last = i == len(depths) - 1
            layers.append(BasicLayer(
                embed_dims[i], depths[i], num_heads[i], window_sizes[i],
                mlp_ratio, local_conv_size,
                out_dim=0 if last else embed_dims[i + 1]))
        self.layers = nn.ModuleList(layers)
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dims[-1], 256, 1, bias=False), LayerNorm2d(256),
            nn.Conv2d(256, 256, 3, padding=1, bias=False), LayerNorm2d(256))

    def forward(self, x, return_interm: bool = False):
        x = self.layers[0](self.patch_embed(x))
        interm = None
        for i in range(1, len(self.layers)):
            x = self.layers[i](x)
            if i == 1:
                interm = x
        x = self.neck(x)
        return (x, interm) if return_interm else x
