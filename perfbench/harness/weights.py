"""Seeded random weights of DEVA's propagation network, made on the device.

The benchmark's own initialiser: the state dict is drawn from one
torch.Generator on the card, in two draws (one normal, one uniform) that
every tensor takes its slice of, with the distributions of upstream DEVA's
initialisation (He fan-out normal for the ResNet trunks' convolutions,
orthonormal rows for the key projection, Xavier normal for the sensory
GRUs' transforms, PyTorch's default uniform for the other layers and
biases, identity BatchNorm statistics). The names and shapes come from the
benchmark's reference copy of the network, so nothing of the program is
read. The same seed gives the same weights; the program and the reference
load the same state dict.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from reference.config import ModelConfig as RefModelConfig
from reference.models.network import DEVANetwork as RefNetwork


def _layout(model_kw: dict):
    """[(name, shape, kind, scale)] of every conv and dense weight and bias
    and every BatchNorm tensor, in the state dict's order."""
    with torch.device("meta"):
        net = RefNetwork(RefModelConfig(**model_kw))
    trunk = {id(m) for enc in (net.pixel_encoder, net.mask_encoder)
             for m in enc.modules()
             if isinstance(m, nn.Conv2d) and m.bias is None}
    out = []
    for name, m in net.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            for key, value in (("weight", 1.0), ("bias", 0.0),
                               ("running_mean", 0.0), ("running_var", 1.0)):
                out.append((f"{name}.{key}", tuple(m.weight.shape), "const",
                            value))
            out.append((f"{name}.num_batches_tracked", (), "count", 0))
            continue
        if not isinstance(m, (nn.Conv2d, nn.Linear)):
            continue
        w = m.weight
        receptive = w[0, 0].numel() if w.ndim == 4 else 1
        fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
        bound = 1.0 / math.sqrt(fan_in)
        if id(m) in trunk:
            kind, scale = "normal", math.sqrt(2.0 / fan_out)
        elif name == "key_proj.key_proj":
            kind, scale = "orthogonal", 1.0
        elif name.endswith("sensory_update.transform"):
            kind, scale = "normal", math.sqrt(2.0 / (fan_in + fan_out))
        else:
            kind, scale = "uniform", bound
        out.append((f"{name}.weight", tuple(w.shape), kind, scale))
        if m.bias is not None:
            out.append((f"{name}.bias", tuple(m.bias.shape),
                        "const" if name == "key_proj.key_proj" else "uniform",
                        0.0 if name == "key_proj.key_proj" else bound))
    return out


@torch.no_grad()
def make_state_dict(model_kw: dict, seed: int, device) -> dict:
    """The network's f32 state dict on `device`, drawn from `seed`."""
    layout = _layout(model_kw)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    numel = lambda shape: math.prod(shape)
    n_normal = sum(numel(s) for _, s, k, _ in layout
                   if k in ("normal", "orthogonal"))
    n_uniform = sum(numel(s) for _, s, k, _ in layout if k == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2 - 1
    sd, at_n, at_u = {}, 0, 0
    for name, shape, kind, scale in layout:
        size = numel(shape)
        if kind == "normal":
            sd[name] = normal[at_n:at_n + size].view(shape) * scale
            at_n += size
        elif kind == "orthogonal":
            # rows of a QR factor: orthonormal over the flattened fan-in
            rows, fan_in = shape[0], size // shape[0]
            g = normal[at_n:at_n + size].view(fan_in, rows)
            sd[name] = torch.linalg.qr(g)[0].T.reshape(shape).contiguous()
            at_n += size
        elif kind == "uniform":
            sd[name] = uniform[at_u:at_u + size].view(shape) * scale
            at_u += size
        elif kind == "count":
            sd[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            sd[name] = torch.full(shape, scale, device=device)
    return sd


def load_into(model_cls, config, state_dict: dict, device) -> nn.Module:
    """A model of `model_cls(config)` built without an initialisation of its
    own, holding a copy of `state_dict` on `device`, in eval mode."""
    with torch.device("meta"):
        net = model_cls(config)
    net = net.to_empty(device=device)
    net.load_state_dict(state_dict, strict=True)
    return net.eval()
