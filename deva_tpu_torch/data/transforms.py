"""Image/mask preprocessing for evaluation readers (host-side, numpy/PIL).

A copy of deva_tpu/data/transforms.py (host-only code: the port imports
nothing of deva_tpu). PIL is imported only inside the functions that decode
or resize images, so the package loads without it.

Matches the reference's torchvision pipeline
(reference:deva/inference/data/video_reader.py:133-155): ToTensor + ImageNet
normalization + min-side Resize (bilinear antialias for images / soft masks,
nearest for id masks). Normalization and antialiased bilinear resampling are
both linear, so resizing the PIL image first and normalizing after is
equivalent.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def min_side_size(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision Resize(size) semantics: scale the shorter side to `size`."""
    if h < w:
        return size, max(1, round(w * size / h))
    return max(1, round(h * size / w)), size


def load_image(path: str, size: int = -1) -> np.ndarray:
    """-> float32 [H, W, 3], ImageNet-normalized (optionally min-side resized)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if size > 0:
        th, tw = min_side_size(img.height, img.width, size)
        if (th, tw) != (img.height, img.width):
            img = img.resize((tw, th), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def normalize_image(arr: np.ndarray) -> np.ndarray:
    """uint8/float [H, W, 3] in [0,255] -> normalized float32."""
    arr = np.asarray(arr, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def resize_mask_nearest(mask: np.ndarray, size: int) -> np.ndarray:
    """Min-side nearest resize of an integer id mask (torch 'nearest'
    semantics: src index = floor(dst * in/out))."""
    h, w = mask.shape[-2:]
    th, tw = min_side_size(h, w, size)
    if (th, tw) == (h, w):
        return mask
    rows = np.floor(np.arange(th) * (h / th)).astype(np.int64)
    cols = np.floor(np.arange(tw) * (w / tw)).astype(np.int64)
    return mask[..., rows[:, None], cols[None, :]]


def resize_soft_mask(mask: np.ndarray, size: int) -> np.ndarray:
    """Min-side antialiased bilinear resize of a float [H, W] mask in [0,1]."""
    h, w = mask.shape
    th, tw = min_side_size(h, w, size)
    if (th, tw) == (h, w):
        return mask.astype(np.float32)
    from PIL import Image
    img = Image.fromarray((mask * 255).astype(np.uint8))
    img = img.resize((tw, th), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def resize_prob_to(prob: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Bilinear (align_corners=False, no antialias) resize of probabilities
    [C, h, w] to `shape`, matching the reference's output-side F.interpolate
    (reference:deva/inference/result_utils.py:98-100). Runs in numpy."""
    c, h, w = prob.shape
    th, tw = shape
    if (th, tw) == (h, w):
        return prob
    # half-pixel-center sampling
    ys = (np.arange(th) + 0.5) * (h / th) - 0.5
    xs = (np.arange(tw) + 0.5) * (w / tw) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
    top = prob[:, y0][:, :, x0] * (1 - wx) + prob[:, y0][:, :, x1] * wx
    bot = prob[:, y1][:, :, x0] * (1 - wx) + prob[:, y1][:, :, x1] * wx
    return top * (1 - wy[None, :, None]) + bot * wy[None, :, None]
