"""Evaluation video reader (host-side, numpy/PIL).

A copy of deva_tpu/data/video_reader.py:VideoReader (host-only code: the
port imports nothing of deva_tpu), with its RLE `segmentation_from_dict`
source (per-frame, per-object RLE masks, decoded by utils/rle.py). PIL is
imported inside the methods that decode files.

Behavioral anchor: reference:deva/inference/data/video_reader.py:17-239

Each item is a dict: {'rgb': float32 [H,W,3] normalized, 'mask': ..., 'info':
{...}} mirroring the reference's fields so drivers translate 1:1.
"""
from __future__ import annotations

import copy
import os
from os import path
from typing import Dict, List, Optional

import numpy as np

from deva_tpu_torch.data.transforms import (load_image, resize_mask_nearest,
                                            resize_soft_mask)
from deva_tpu_torch.utils import rle as rle_codec


class VideoReader:
    """Reads one video's frames (and ground-truth / provided masks)."""

    def __init__(self,
                 vid_name: str,
                 image_dir: str,
                 mask_dir: str,
                 *,
                 size: int = -1,
                 to_save: Optional[List[str]] = None,
                 use_all_masks: bool = False,
                 size_dir: Optional[str] = None,
                 start: int = -1,
                 end: int = -1,
                 num_sampled_frames: int = -1,
                 reverse: bool = False,
                 soft_mask: bool = False,
                 object_name: Optional[str] = None,
                 multi_object: bool = True,
                 segmentation_from_dict: Optional[Dict] = None,
                 enabled_frame_list: Optional[List[str]] = None):
        self.vid_name = vid_name
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.to_save = to_save
        self.use_all_masks = use_all_masks
        self.soft_mask = soft_mask
        self.object_name = object_name
        self.multi_object = multi_object
        self.segmentation_from_dict = segmentation_from_dict
        self.size_dir = size_dir if size_dir is not None else image_dir
        self.size = size

        if segmentation_from_dict is None:
            self.frames = sorted(os.listdir(image_dir))
        else:
            ext = sorted(os.listdir(image_dir))[0][-4:]
            self.frames = [f + ext for f in sorted(segmentation_from_dict)]

        if enabled_frame_list is not None:
            self.frames = [f for f in self.frames
                           if f[:-4] in enabled_frame_list]

        self._all_frames = copy.deepcopy(self.frames)
        if start >= 0:
            self.frames = self.frames[start:end] if end >= 0 else \
                self.frames[start:]
        elif end >= 0:
            self.frames = self.frames[:end]

        if num_sampled_frames > 0:
            assert start < 0 and end < 0
            n = len(self.frames)
            m = min(num_sampled_frames, n)
            idx = [i * n // m + n // (2 * m) for i in range(m)]
            self.frames = [self.frames[i] for i in idx]

        if reverse:
            self.frames = list(reversed(self.frames))

        self.palette = None
        if segmentation_from_dict is not None:
            self.first_mask_frame = self.frames[0]
        elif soft_mask:
            if multi_object and object_name is None:
                self.prob_folders = sorted(
                    f for f in os.listdir(mask_dir) if ".csv" not in f)
                self.first_mask_frame = sorted(
                    os.listdir(path.join(mask_dir, self.prob_folders[0])))[0]
            else:
                if object_name is not None:
                    self.mask_dir = path.join(mask_dir, object_name)
                self.first_mask_frame = sorted(os.listdir(self.mask_dir))[0]
        else:
            from PIL import Image
            first = sorted(os.listdir(mask_dir))[0]
            self.palette = Image.open(path.join(mask_dir, first)).getpalette()
            self.first_mask_frame = first

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
        img = load_image(im_path, self.size)

        data = {"rgb": img}
        load_mask = self.use_all_masks or (
            frame[:-4] == self.first_mask_frame[:-4])
        if load_mask:
            mask, valid_labels = self._load_mask(frame, info)
            if mask is not None:
                data["mask"] = mask
                data["valid_labels"] = valid_labels

        info["shape"] = shape
        info["need_resize"] = self.size > 0
        info["time_index"] = self._all_frames.index(frame)
        info["path_to_image"] = im_path
        data["info"] = info
        return data

    def _load_mask(self, frame: str, info: Dict):
        if self.segmentation_from_dict is not None:
            pred = self.segmentation_from_dict[frame[:-4]][self.object_name]
            mask = rle_codec.decode(pred["segmentation"]).astype(np.float32)
            if self.size > 0:
                mask = resize_soft_mask(mask, self.size)
            return mask[None], np.arange(1, 2)

        from PIL import Image
        if self.soft_mask:
            masks = []
            if self.object_name is not None or not self.multi_object:
                mask_path = path.join(self.mask_dir, frame[:-4] + ".png")
                m = np.asarray(Image.open(mask_path), np.float32) / 255
                if self.size > 0:
                    m = resize_soft_mask(m, self.size)
                masks.append(m)
                if self.object_name is not None:
                    info["object_name"] = self.object_name
            else:
                for prob_folder in self.prob_folders:
                    mask_path = path.join(self.mask_dir, prob_folder,
                                          frame[:-4] + ".png")
                    m = np.asarray(Image.open(mask_path), np.float32) / 255
                    if self.size > 0:
                        m = resize_soft_mask(m, self.size)
                    masks.append(m)
            all_masks = np.stack(masks, 0)
            return all_masks, np.arange(1, len(masks) + 1)

        mask_path = path.join(self.mask_dir, frame[:-4] + ".png")
        if not path.exists(mask_path):
            return None, None
        mask = np.asarray(Image.open(mask_path).convert("P"), np.int64)
        if self.size > 0:
            mask = resize_mask_nearest(mask, self.size)
        valid_labels = np.unique(mask)
        valid_labels = valid_labels[valid_labels != 0]
        return mask, valid_labels

    def get_palette(self):
        return self.palette

    def mask_frame_indices(self) -> List[int]:
        """Indices whose __getitem__ would carry a mask, WITHOUT decoding
        anything (file-existence probe). Lets drivers plan lockstep batching
        around mid-stream mask arrivals up front."""
        cand = [i for i, f in enumerate(self.frames)
                if self.use_all_masks or
                f[:-4] == self.first_mask_frame[:-4]]
        if self.segmentation_from_dict is not None or self.soft_mask:
            return cand
        return [i for i in cand
                if path.exists(path.join(self.mask_dir,
                                         self.frames[i][:-4] + ".png"))]

    def __len__(self):
        return len(self.frames)

