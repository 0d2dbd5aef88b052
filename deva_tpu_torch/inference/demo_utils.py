"""Demo helpers: raw RGB frame -> normalized resized array, end-of-video
buffer flushing, and the detector of an object-sharded demo.

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


class SharedSource:
    """A detector or mask generator of an object-sharded demo
    (--obj_shards): process 0 runs it (`inner`; None on the other
    processes) and broadcasts each result, so that every process fuses the
    same detections. Detections feed host decisions (matching, new
    objects), which must agree bit for bit, and the same network on two
    cards need not give the same bits."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):  # detect, masks_for_boxes, generate
        import torch.distributed as dist

        def call(*args, **kwargs):
            out = [getattr(self.inner, name)(*args, **kwargs)
                   if dist.get_rank() == 0 else None]
            dist.broadcast_object_list(out, src=0)
            return out[0]
        return call


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
