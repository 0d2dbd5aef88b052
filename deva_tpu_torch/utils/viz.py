"""Visualization overlay: mask blending + box/label annotation in numpy/PIL.

A copy of deva_tpu/utils/viz.py (host-only code: the port imports nothing of
deva_tpu, whose package import loads jax), with PIL imported only where the
labels are drawn.

Replaces the reference's `supervision` annotators
(reference:deva/inference/result_utils.py:240-283) which aren't available in
this image.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def mask_to_box(mask: np.ndarray):
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())


def overlay_segmentation(image_np: np.ndarray,
                         id_mask: np.ndarray,
                         rgb_mask: np.ndarray,
                         segments_info: List[Dict],
                         prompts: Optional[List[str]] = None) -> np.ndarray:
    """Blend the colored mask over the image (50% where background) and draw
    per-segment boxes + labels when text prompts are given."""
    alpha = (id_mask == 0).astype(np.float32) * 0.5 + 0.5
    blend = (image_np.astype(np.float32) * alpha[..., None] +
             rgb_mask.astype(np.float32) * (1 - alpha[..., None]))
    blend = blend.astype(np.uint8)

    if prompts is None:
        return blend

    from PIL import Image, ImageDraw
    img = Image.fromarray(blend)
    draw = ImageDraw.Draw(img)
    for seg in segments_info:
        box = mask_to_box(id_mask == seg["id"])
        if box is None:
            continue
        cat = seg.get("category_id")
        label = None
        if cat is not None and 0 <= cat < len(prompts):
            score = seg.get("score")
            label = f"{prompts[cat]} {score:.2f}" if score is not None else \
                prompts[cat]
        color = tuple(int(c) for c in rgb_mask[id_mask == seg["id"]][0]) \
            if (id_mask == seg["id"]).any() else (255, 255, 255)
        draw.rectangle(box, outline=color, width=2)
        if label:
            tw = draw.textlength(label)
            x0, y0 = box[0], max(0, box[1] - 12)
            draw.rectangle([x0, y0, x0 + tw + 4, y0 + 12], fill=color)
            draw.text((x0 + 2, y0), label, fill=(0, 0, 0))
    return np.asarray(img)
