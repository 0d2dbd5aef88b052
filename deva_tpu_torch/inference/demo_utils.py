"""Demo helpers: raw RGB frame -> normalized resized array, and end-of-video
buffer flushing.

Port of deva_tpu/inference/demo_utils.py. The min-side resize is
ops/resize.py's resize_image_uint8 (PIL's BILINEAR passes in torch, within
one level of deva_tpu's PIL resize) instead of PIL, with deva_tpu's
truncating target size (int(h * scale), not data/transforms.min_side_size's
rounding: the two give different sizes).

Behavioral anchor: reference:deva/inference/demo_utils.py:10-46.
"""
from __future__ import annotations

import numpy as np
import torch

from deva_tpu_torch.data.transforms import normalize_image
from deva_tpu_torch.ops.resize import resize_image_uint8


def get_input_frame_for_deva(image_np: np.ndarray,
                             min_side: int) -> np.ndarray:
    """uint8 RGB [H,W,3] -> normalized float32 [H',W',3] (min-side resized)."""
    if min_side > 0:
        h, w = image_np.shape[:2]
        scale = min_side / min(h, w)
        new_h, new_w = int(h * scale), int(w * scale)
        if (new_h, new_w) != (h, w):
            image_np = resize_image_uint8(torch.from_numpy(
                np.array(image_np, np.uint8)), (new_h, new_w)).numpy()
    return normalize_image(image_np)


def flush_buffer(deva, result_saver, prompts=None) -> None:
    """Propagate any frames still waiting in the semi-online buffer.
    reference:deva/inference/demo_utils.py:23-46."""
    need_resize = deva.cfg.size > 0
    for frame_info in deva.frame_buffer:
        image_np = getattr(frame_info, "image_np", None)
        shape = frame_info.info.get("shape")
        prob = deva.step(frame_info.image, None, None)
        result_saver.save_mask(prob, frame_info.name,
                               need_resize=need_resize, shape=shape,
                               image_np=image_np, prompts=prompts)
    deva.clear_buffer()
