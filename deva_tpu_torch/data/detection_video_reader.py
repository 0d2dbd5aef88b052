"""Reader for videos with precomputed per-frame detections (VIPSeg/BURST).

Behavioral anchor: reference:deva/inference/data/detection_video_reader.py:
14-126 — frames + per-frame detection masks (palette PNG or base-256 RGB PNG)
+ side-car JSON paths (json decoding is deferred to the driver).

A copy of deva_tpu/data/detection_video_reader.py (host-only code: the port
imports nothing of deva_tpu, whose package import loads jax), with PIL
imported inside the methods that decode images.
"""
from __future__ import annotations

import os
from os import path
from typing import Dict, List, Optional

import numpy as np

from deva_tpu_torch.data.transforms import load_image, resize_mask_nearest
from deva_tpu_torch.utils.pano_utils import rgb_to_id


class DetectionVideoReader:
    def __init__(self,
                 vid_name: str,
                 image_dir: str,
                 mask_dir: str,
                 size: int = -1,
                 to_save: Optional[List[str]] = None,
                 size_dir: Optional[str] = None,
                 start: int = -1,
                 end: int = -1,
                 reverse: bool = False):
        from PIL import Image
        self.vid_name = vid_name
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.to_save = to_save
        self.size_dir = size_dir if size_dir is not None else image_dir
        self.size = size
        self.is_rgb = None

        self.frames = sorted(os.listdir(image_dir))
        if start > 0:
            self.frames = self.frames[start:]
        if end > 0:
            self.frames = self.frames[:end]
        if reverse:
            self.frames = list(reversed(self.frames))

        first_mask = path.join(mask_dir, self.frames[0][:-4] + ".png")
        self.palette = Image.open(first_mask).getpalette()
        self.first_gt_path = first_mask

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image
        frame = self.frames[idx]
        info = {"frame": frame,
                "save": (self.to_save is None) or (frame[:-4] in self.to_save)}

        im_path = path.join(self.image_dir, frame)
        if self.image_dir == self.size_dir:
            with Image.open(im_path) as im:
                shape = (im.height, im.width)
        else:
            with Image.open(path.join(self.size_dir, frame)) as im:
                shape = (im.height, im.width)

        data = {"rgb": load_image(im_path, self.size)}

        mask_path = path.join(self.mask_dir, frame[:-4] + ".png")
        if path.exists(mask_path):
            mask_img = Image.open(mask_path)
            if mask_img.mode == "RGB":
                mask = rgb_to_id(np.asarray(mask_img, np.int64))
                self.is_rgb = True
            else:
                mask = np.asarray(mask_img.convert("P"), np.int64)
                self.is_rgb = False
            if self.size > 0:
                mask = resize_mask_nearest(mask, self.size)
            data["mask"] = mask.astype(np.int32)

        json_path = path.join(self.mask_dir, frame[:-4] + ".json")
        if path.exists(json_path):
            info["json"] = json_path

        info["is_rgb"] = self.is_rgb
        info["shape"] = shape
        info["need_resize"] = self.size > 0
        info["path_to_image"] = im_path
        data["info"] = info
        return data

    def get_palette(self):
        return self.palette

    def __len__(self):
        return len(self.frames)
