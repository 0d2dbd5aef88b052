"""Per-frame online/semi-online state machine for text-prompted tracking.

A copy of deva_tpu/ext/with_text_processor.py with the port's imports; the
probabilities go to the saver as the core's device tensors, as the port's
drivers pass them (the saver takes their argmax on the device, or copies
them to the host where it must resize them), and PIL is imported only
where a frame must be read from its path.

Behavioral anchor: reference:deva/ext/with_text_processor.py:22-122. The
detector is pluggable (deva_tpu_torch/ext/detectors.py) instead of
hard-wired GroundingDINO+SAM.
"""
from __future__ import annotations

from os import path
from typing import Dict, Optional

import numpy as np

from deva_tpu_torch.ext.detectors import segment_with_text
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.inference.demo_utils import get_input_frame_for_deva
from deva_tpu_torch.inference.frame_utils import FrameInfo
from deva_tpu_torch.inference.result_saver import ResultSaver


def process_frame_with_text(deva: InferenceCore,
                            detector,
                            ext_cfg: Dict,
                            frame_path: str,
                            result_saver: ResultSaver,
                            ti: int,
                            image_np: Optional[np.ndarray] = None) -> None:
    if image_np is None:
        from PIL import Image
        image_np = np.asarray(Image.open(frame_path).convert("RGB"))
    prompts = [p for p in ext_cfg["prompt"].split(".") if p.strip()]

    h, w = image_np.shape[:2]
    new_min_side = deva.cfg.size
    need_resize = new_min_side > 0
    image = get_input_frame_for_deva(image_np, new_min_side)

    frame_name = path.basename(frame_path)
    frame_info = FrameInfo(image, None, None, ti,
                           {"frame": frame_name, "shape": (h, w),
                            "save": True, "path_to_image": frame_path})

    temporal_setting = ext_cfg["temporal_setting"]
    if temporal_setting == "semionline":
        if ti + deva.cfg.num_voting_frames > deva.next_voting_frame:
            mask, segments_info = segment_with_text(ext_cfg, detector,
                                                    image_np, prompts,
                                                    new_min_side)
            frame_info.mask = mask
            frame_info.segments_info = segments_info
            frame_info.image_np = image_np  # visualization only
            deva.add_to_temporary_buffer(frame_info)

            if ti == deva.next_voting_frame:
                buf0 = deva.frame_buffer[0]
                _, mask, new_segments_info = deva.vote_in_temporary_buffer(
                    keyframe_selection="first")
                prob = deva.incorporate_detection(buf0.image, mask,
                                                  new_segments_info)
                deva.next_voting_frame += ext_cfg["detection_every"]
                result_saver.save_mask(prob, buf0.name,
                                       need_resize=need_resize, shape=(h, w),
                                       image_np=buf0.image_np,
                                       prompts=prompts)
                for fi in deva.frame_buffer[1:]:
                    prob = deva.step(fi.image, None, None)
                    result_saver.save_mask(prob, fi.name,
                                           need_resize=need_resize,
                                           shape=(h, w),
                                           image_np=fi.image_np,
                                           prompts=prompts)
                deva.clear_buffer()
        else:
            prob = deva.step(image, None, None)
            result_saver.save_mask(prob, frame_name,
                                   need_resize=need_resize, shape=(h, w),
                                   image_np=image_np, prompts=prompts)

    elif temporal_setting == "online":
        if ti % ext_cfg["detection_every"] == 0:
            mask, segments_info = segment_with_text(ext_cfg, detector,
                                                    image_np, prompts,
                                                    new_min_side)
            prob = deva.incorporate_detection(image, mask, segments_info)
        else:
            prob = deva.step(image, None, None)
        result_saver.save_mask(prob, frame_name,
                               need_resize=need_resize, shape=(h, w),
                               image_np=image_np, prompts=prompts)
    else:
        raise NotImplementedError(temporal_setting)
