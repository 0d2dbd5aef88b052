"""Benchmark meta-datasets for semi-supervised VOS evaluation.

A copy of deva_tpu/data/vos_test_datasets.py (host-only code: the port
imports nothing of deva_tpu): the generic, DAVIS and YouTube-VOS layouts.

Behavioral anchor: reference:deva/inference/data/vos_test_datasets.py:8-97 —
these enumerate videos and hand out per-video readers.
"""
from __future__ import annotations

import json
import os
from os import path

from deva_tpu_torch.data.video_reader import VideoReader


class GeneralVOSTestDataset:
    def __init__(self, data_root: str, size: int = -1,
                 use_all_masks: bool = False):
        self.image_dir = path.join(data_root, "JPEGImages")
        self.mask_dir = path.join(data_root, "Annotations")
        self.size = size
        self.use_all_masks = use_all_masks
        self.vid_list = sorted(os.listdir(self.mask_dir))

    def get_datasets(self):
        for video in self.vid_list:
            mask_dir = path.join(self.mask_dir, video)
            yield VideoReader(
                video,
                path.join(self.image_dir, video),
                mask_dir,
                to_save=[n[:-4] for n in os.listdir(mask_dir)],
                size=self.size,
                use_all_masks=self.use_all_masks)

    def __len__(self):
        return len(self.vid_list)


class DAVISTestDataset:
    def __init__(self, data_root: str, imset: str = "2017/val.txt",
                 size: int = -1):
        if size != 480:
            self.image_dir = path.join(data_root, "JPEGImages",
                                       "Full-Resolution")
            self.mask_dir = path.join(data_root, "Annotations",
                                      "Full-Resolution")
            if not path.exists(self.image_dir):
                self.image_dir = path.join(data_root, "JPEGImages", "1080p")
                self.mask_dir = path.join(data_root, "Annotations", "1080p")
            assert path.exists(self.image_dir), "path not found"
        else:
            self.image_dir = path.join(data_root, "JPEGImages", "480p")
            self.mask_dir = path.join(data_root, "Annotations", "480p")
        self.size_dir = path.join(data_root, "JPEGImages", "480p")
        self.size = size
        with open(path.join(data_root, "ImageSets", imset)) as f:
            self.vid_list = sorted(line.strip() for line in f)

    def get_datasets(self):
        for video in self.vid_list:
            yield VideoReader(
                video,
                path.join(self.image_dir, video),
                path.join(self.mask_dir, video),
                size=self.size,
                size_dir=path.join(self.size_dir, video))

    def __len__(self):
        return len(self.vid_list)


class YouTubeVOSTestDataset:
    def __init__(self, data_root: str, split: str, size: int = 480):
        self.image_dir = path.join(data_root, "all_frames",
                                   split + "_all_frames", "JPEGImages")
        self.mask_dir = path.join(data_root, split, "Annotations")
        self.size = size
        self.vid_list = sorted(os.listdir(self.image_dir))
        self.req_frame_list = {}
        with open(path.join(data_root, split, "meta.json")) as f:
            meta = json.load(f)["videos"]
        for vid in self.vid_list:
            req = []
            for value in meta[vid]["objects"].values():
                req.extend(value["frames"])
            self.req_frame_list[vid] = list(set(req))

    def get_datasets(self):
        for video in self.vid_list:
            yield VideoReader(
                video,
                path.join(self.image_dir, video),
                path.join(self.mask_dir, video),
                size=self.size,
                to_save=self.req_frame_list[video],
                use_all_masks=True)

    def __len__(self):
        return len(self.vid_list)
