"""Per-frame state machine for automatic (grid-prompted) tracking: compute a
forward mask first so the generator only queries unclaimed regions, then fuse
with incremental=True (objects are only dropped when out of view too long).

A copy of deva_tpu/ext/automatic_processor.py with the port's imports:
estimate_forward_mask runs on the core's device (the port's
image_feature_store, pad_divide_by and _segment) and hands the forward
ids to the host; the probabilities go to the saver as device tensors, and
PIL is imported only where a frame must be read from its path.

Behavioral anchor: reference:deva/ext/automatic_processor.py:19-140.
"""
from __future__ import annotations

from os import path
from typing import Dict, Optional

import numpy as np
import torch

from deva_tpu_torch.ext.detectors import auto_segment
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.inference.demo_utils import get_input_frame_for_deva
from deva_tpu_torch.inference.frame_utils import FrameInfo
from deva_tpu_torch.inference.result_saver import ResultSaver
from deva_tpu_torch.ops.aggregate import argmax_ids
from deva_tpu_torch.ops.pad import pad_divide_by, unpad


@torch.no_grad()
def estimate_forward_mask(deva: InferenceCore, image: np.ndarray):
    """One forward prediction to find already-claimed regions -> the
    forward ids [H, W] on the host. reference:deva/ext/automatic_processor.py:
    131-140 (the feature cache at curr_ti+1 is reused by the subsequent
    step/incorporate call; in a semi-online buffer, whose frames do not
    advance curr_ti, the later frames find the first one's features, as in
    deva_tpu)."""
    image_t = torch.as_tensor(image, dtype=torch.float32, device=deva.device)
    padded, pad = pad_divide_by(image_t.permute(2, 0, 1), 16, -2, -1)
    ms_features, key, shrinkage, selection = \
        deva.image_feature_store.get_features(deva.curr_ti + 1, padded[None])
    prob = deva._segment(key, shrinkage, selection, ms_features)
    n = deva.object_manager.num_obj
    forward_mask = argmax_ids(prob[:n + 1]).astype(np.int64)
    return unpad(forward_mask, pad, -2, -1)


def process_frame_automatic(deva: InferenceCore,
                            generator,
                            ext_cfg: Dict,
                            frame_path: str,
                            result_saver: ResultSaver,
                            ti: int,
                            image_np: Optional[np.ndarray] = None) -> None:
    if image_np is None:
        from PIL import Image
        image_np = np.asarray(Image.open(frame_path).convert("RGB"))

    h, w = image_np.shape[:2]
    new_min_side = deva.cfg.size
    suppress_small_mask = ext_cfg["suppress_small_objects"]
    need_resize = new_min_side > 0
    image = get_input_frame_for_deva(image_np, new_min_side)

    frame_name = path.basename(frame_path)
    frame_info = FrameInfo(image, None, None, ti,
                           {"frame": frame_name, "shape": (h, w),
                            "save": True, "path_to_image": frame_path})

    temporal_setting = ext_cfg["temporal_setting"]
    if temporal_setting == "semionline":
        if ti + deva.cfg.num_voting_frames > deva.next_voting_frame:
            forward_mask = None
            if deva.memory is not None and deva.memory.engaged:
                forward_mask = estimate_forward_mask(deva, image)
            mask, segments_info = auto_segment(ext_cfg, generator, image_np,
                                               forward_mask, new_min_side,
                                               suppress_small_mask)
            frame_info.mask = mask
            frame_info.segments_info = segments_info
            frame_info.image_np = image_np
            deva.add_to_temporary_buffer(frame_info)

            if ti == deva.next_voting_frame:
                buf0 = deva.frame_buffer[0]
                _, mask, new_segments_info = deva.vote_in_temporary_buffer(
                    keyframe_selection="first")
                prob = deva.incorporate_detection(buf0.image, mask,
                                                  new_segments_info,
                                                  incremental=True)
                deva.next_voting_frame += ext_cfg["detection_every"]
                result_saver.save_mask(prob, buf0.name,
                                       need_resize=need_resize, shape=(h, w),
                                       image_np=buf0.image_np)
                for fi in deva.frame_buffer[1:]:
                    prob = deva.step(fi.image, None, None)
                    result_saver.save_mask(prob, fi.name,
                                           need_resize=need_resize,
                                           shape=(h, w),
                                           image_np=fi.image_np)
                deva.clear_buffer()
        else:
            prob = deva.step(image, None, None)
            result_saver.save_mask(prob, frame_name,
                                   need_resize=need_resize, shape=(h, w),
                                   image_np=image_np)

    elif temporal_setting == "online":
        if ti % ext_cfg["detection_every"] == 0:
            forward_mask = None
            if deva.memory is not None and deva.memory.engaged:
                forward_mask = estimate_forward_mask(deva, image)
            mask, segments_info = auto_segment(ext_cfg, generator, image_np,
                                               forward_mask, new_min_side,
                                               suppress_small_mask)
            prob = deva.incorporate_detection(image, mask, segments_info,
                                              incremental=True)
        else:
            prob = deva.step(image, None, None)
        result_saver.save_mask(prob, frame_name,
                               need_resize=need_resize, shape=(h, w),
                               image_np=image_np)
    else:
        raise NotImplementedError(temporal_setting)
