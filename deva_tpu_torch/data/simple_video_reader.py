"""Raw-frame reader for the demos (no masks).

A copy of deva_tpu/data/video_reader.py:SimpleVideoReader (re-exported by
deva_tpu/data/simple_video_reader.py), with PIL imported inside
__getitem__ only.

Behavioral anchor: reference:deva/inference/data/simple_video_reader.py:8-39.
"""
from __future__ import annotations

import os
from os import path

import numpy as np


class SimpleVideoReader:
    """The sorted image files of a folder, read as uint8 RGB frames."""

    def __init__(self, image_dir: str, size: int = -1):
        self.image_dir = image_dir
        self.frames = sorted(os.listdir(image_dir))
        self.size = size

    def __getitem__(self, idx: int):
        from PIL import Image
        frame = self.frames[idx]
        im_path = path.join(self.image_dir, frame)
        img = np.asarray(Image.open(im_path).convert("RGB"))
        return img, frame, im_path

    def __len__(self):
        return len(self.frames)
