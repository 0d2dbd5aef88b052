"""Unsupervised DAVIS-17 postprocess: cap the number of predicted objects,
keeping the largest-area, first-seen ones.

A copy of deva_tpu/inference/postprocess_unsup_davis17.py (host-only code:
the port imports nothing of deva_tpu, whose package import loads jax), with
PIL imported inside the functions that read and write the PNGs.

Behavioral anchor: reference:deva/inference/postprocess_unsup_davis17.py:11-56
(including its big-endian RGB decode — ids are random so only distinctness
matters).
"""
from __future__ import annotations

import os
from os import path

import numpy as np

from deva_tpu_torch.utils.palette import davis_palette


def _load_id_mask(p: str) -> np.ndarray:
    from PIL import Image
    mask = np.array(Image.open(p)).astype(np.int32)
    if mask.ndim == 3:
        mask = (mask[:, :, 0] * 256 * 256 + mask[:, :, 1] * 256 +
                mask[:, :, 2])
    return mask


def limit_max_id(input_path: str, output_path: str,
                 max_num_objects: int = 20) -> None:
    from PIL import Image
    for video in sorted(os.listdir(input_path)):
        video_path = path.join(input_path, video)
        if not path.isdir(video_path):
            continue
        frames = sorted(os.listdir(video_path))

        existing_objects = []
        for frame in frames:
            mask = _load_id_mask(path.join(video_path, frame))
            labels = np.unique(mask)
            labels = labels[labels != 0]
            areas = [int((mask == l).sum()) for l in labels]
            by_area = [l for _, l in sorted(zip(areas, labels), reverse=True)]
            room = max_num_objects - len(existing_objects)
            existing_objects += by_area[:room]
            if len(existing_objects) == max_num_objects:
                break

        for frame in frames:
            mask = _load_id_mask(path.join(video_path, frame))
            new_mask = np.zeros_like(mask, dtype=np.uint8)
            for new_idx, label in enumerate(existing_objects):
                new_mask[mask == label] = new_idx + 1
            out = Image.fromarray(new_mask)
            out.putpalette(davis_palette())
            os.makedirs(path.join(output_path, video), exist_ok=True)
            out.save(path.join(output_path, video, frame))
