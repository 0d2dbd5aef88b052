"""VPS postprocess: re-id things when their category changes; merge all stuff
of one category into one id.

A copy of deva_tpu/metrics/stuff_merging.py (host-only code: the port imports
nothing of deva_tpu, whose package import loads jax), with PIL imported
inside the function that reads and writes the PNGs, and its pool started
with the spawn method (a driver's process holds CUDA state and threads).

Behavioral anchor: reference:deva/vps_metrics/stuff_merging.py:29-105.
"""
from __future__ import annotations

import json
import os
from functools import partial
from multiprocessing import get_context
from os import path

import numpy as np

from deva_tpu_torch.utils.pano_utils import IDPostprocessor, id_to_rgb, rgb_to_id
from deva_tpu_torch.utils.vipseg_categories import vipseg_cat_to_isthing


def process_single_video(vid_ann, input_path: str, output_path: str):
    from PIL import Image
    video_id = vid_ann["video_id"]
    out_annotations = []
    out_video = {"video_id": video_id, "annotations": out_annotations}
    out_dir = path.join(output_path, "pan_pred", video_id)
    os.makedirs(out_dir, exist_ok=True)

    converter = IDPostprocessor()
    for ann in vid_ann["annotations"]:
        file_name = ann["file_name"]
        out_segments = []
        out_annotations.append({"file_name": file_name,
                                "segments_info": out_segments})
        mask = rgb_to_id(np.array(
            Image.open(path.join(input_path, "pan_pred", video_id,
                                 file_name.replace(".jpg", ".png")))
        ).astype(np.int32))
        output_mask = np.zeros_like(mask)

        for segment in ann["segments_info"]:
            sid = segment["id"]
            category_id = segment["category_id"]
            isthing = vipseg_cat_to_isthing[category_id]
            new_id = converter.convert(sid, category_id, isthing)
            output_mask[mask == sid] = new_id
            if isthing:
                out_segments.append({"id": new_id,
                                     "category_id": category_id,
                                     "isthing": 1})

        for cat, new_id in converter.stuff_to_id.items():
            if int((output_mask == new_id).sum()) > 0:
                assert not vipseg_cat_to_isthing[cat]
                out_segments.append({"id": new_id, "category_id": cat,
                                     "isthing": 0})

        Image.fromarray(id_to_rgb(output_mask)).save(
            path.join(out_dir, file_name.replace(".jpg", ".png")))
    return out_video


def merge_stuff(input_path: str, output_path: str,
                num_processes: int = 8) -> None:
    with open(path.join(input_path, "pred.json")) as f:
        annotations = json.load(f)["annotations"]

    if num_processes > 1 and len(annotations) > 1:
        with get_context("spawn").Pool(num_processes) as pool:
            out = list(pool.imap(
                partial(process_single_video, input_path=input_path,
                        output_path=output_path), annotations))
    else:
        out = [process_single_video(a, input_path, output_path)
               for a in annotations]

    with open(path.join(output_path, "pred.json"), "w") as f:
        json.dump({"annotations": out}, f)
