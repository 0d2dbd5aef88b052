"""Synthetic videos drawn from the seed: a bank of frames on the host.

A video is a smooth random background (8x8 blocks of a random image, plus a
little noise each frame) in front of which a few textured ellipses move in
straight lines; its first-frame mask paints the first ellipses as the
objects, each over the ones after it (the first is never hidden). Frames
are float32 [H, W, 3] arrays on the host, normalised as the port's readers
hand them
(deva_tpu_torch/data/video_reader.py). Each video is drawn on the card from
one torch.Generator seeded with the run's seed, and copied to the host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


@torch.no_grad()
def make_bank(videos: int, frames: int, height: int, width: int,
              ellipses: int, seed: int, device):
    """-> (bank [V, T, H, W, 3] f32 on the host, labels [V, T, H, W] uint8
    on the host: 0 for the background, i for the i-th ellipse)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    t, h, w, e = frames, height, width, ellipses
    hb, wb = -(-h // 8), -(-w // 8)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    steps = torch.arange(t, device=device, dtype=torch.float32)[:, None, None]
    bank = torch.empty((videos, t, h, w, 3))
    labels = torch.empty((videos, t, h, w), dtype=torch.uint8)
    for v in range(videos):
        base = randn(1, 3, hb, wb) + 0.1 * randn(t, 3, hb, wb)
        img = F.interpolate(base, scale_factor=8,
                            mode="nearest")[..., :h, :w]  # [T, 3, H, W]
        lab = torch.zeros((t, h, w), dtype=torch.uint8, device=device)
        # each ellipse: centre, half-axes, heading and speed (pixels a
        # frame), and a colour over a copy of the background's texture
        cy, cx, ry, rx, angle, speed = rand(6, e)
        colour = randn(e, 3)
        for i in reversed(range(e)):
            py = cy[i] * h + steps * (1 + 3 * speed[i]) * torch.sin(
                angle[i] * 2 * math.pi)
            px = cx[i] * w + steps * (1 + 3 * speed[i]) * torch.cos(
                angle[i] * 2 * math.pi)
            inside = ((ys - py) / ((0.08 + 0.12 * ry[i]) * h)) ** 2 + \
                ((xs - px) / ((0.06 + 0.10 * rx[i]) * w)) ** 2 <= 1.0
            lab[inside] = i + 1
            img = torch.where(inside[:, None],
                              colour[i][None, :, None, None] + 0.3 * img, img)
        bank[v] = img.permute(0, 2, 3, 1).cpu()
        labels[v] = lab.cpu()
    return bank, labels


def first_mask(labels0: torch.Tensor, n_objects: int):
    """The first-frame id mask of a video with `n_objects` objects (the
    first ellipses; the others stay background), int64 numpy [H, W]."""
    mask = labels0.long()
    return torch.where(mask <= n_objects, mask, 0).numpy()
