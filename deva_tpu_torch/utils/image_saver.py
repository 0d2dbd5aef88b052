"""Training visualization grids: per-sequence rows of (input image, GT,
prediction) for tensorboard.

A copy of deva_tpu/utils/image_saver.py (reference:deva/utils/image_saver.py:
116-148, pool_pairs), with PIL imported inside the resize.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from deva_tpu_torch.training.data.utils import IMAGENET_MEAN, IMAGENET_STD
from deva_tpu_torch.utils.palette import voc_colormap

_CMAP = voc_colormap()


def _denorm(img: np.ndarray) -> np.ndarray:
    """normalized [H,W,3] -> uint8."""
    x = img * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(x * 255, 0, 255).astype(np.uint8)


def _colorize(cls_mask: np.ndarray) -> np.ndarray:
    return _CMAP[np.clip(cls_mask, 0, 255)]


def _resize(img: np.ndarray, size) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((size[1], size[0]),
                                                  Image.NEAREST))


def pool_pairs(batch: Dict, outputs: Dict, size=(384, 384),
               max_rows: int = 4) -> np.ndarray:
    """batch: rgb [B,T,H,W,3] normalized, cls_gt [B,T,H,W];
    outputs: masks [T-1,B,O,H,W] probabilities (numpy).
    -> one uint8 grid: a row per sequence (at most max_rows), a column of
    (image | gt | prediction) per frame."""
    rgb = np.asarray(batch["rgb"])
    cls_gt = np.asarray(batch["cls_gt"])
    masks = np.asarray(outputs["masks"])  # [T-1, B, O, H, W]
    b, t = rgb.shape[:2]
    rows = []
    for bi in range(min(b, max_rows)):
        cols = []
        for ti in range(t):
            img = _resize(_denorm(rgb[bi, ti]), size)
            gt = _resize(_colorize(cls_gt[bi, ti]), size)
            if ti == 0:
                pred = gt
            else:
                prob = masks[ti - 1, bi]
                bg = 1.0 - prob.sum(0, keepdims=True)
                pred_cls = np.argmax(
                    np.concatenate([bg, prob], axis=0), axis=0)
                pred = _resize(_colorize(pred_cls), size)
            cols.append(np.concatenate([img, gt, pred], axis=0))
        rows.append(np.concatenate(cols, axis=1))
    return np.concatenate(rows, axis=0)
