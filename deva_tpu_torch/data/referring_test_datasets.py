"""Referring-VOS meta-datasets (Ref-DAVIS, Ref-YouTubeVOS): soft per-object
probability masks + detector confidence scores from side-car csv files.

A copy of deva_tpu/data/referring_test_datasets.py (host-only code: the port
imports nothing of deva_tpu); the readers are the port's VideoReader.

Behavioral anchor: reference:deva/inference/data/referring_test_datasets.py:
10-141.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from os import path

import numpy as np

from deva_tpu_torch.data.video_reader import VideoReader


class ReferringDAVISTestDataset:
    def __init__(self, image_dir: str, mask_dir: str, size: int = -1):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.size = size
        self.vid_list = sorted(os.listdir(mask_dir))

    def get_videos(self):
        return self.vid_list

    def get_offline_sampled_frames(self, video, num_sampled_frames):
        return VideoReader(
            video,
            path.join(self.image_dir, video),
            path.join(self.mask_dir, video),
            to_save=[n[:-4]
                     for n in os.listdir(path.join(self.mask_dir, video))],
            size=self.size,
            soft_mask=True,
            num_sampled_frames=num_sampled_frames,
            use_all_masks=True)

    def get_partial_video_loader(self, video, *, start, end, reverse):
        return VideoReader(
            video,
            path.join(self.image_dir, video),
            path.join(self.mask_dir, video),
            to_save=[n[:-4]
                     for n in os.listdir(path.join(self.mask_dir, video))],
            size=self.size,
            soft_mask=True,
            start=start,
            end=end,
            reverse=reverse)

    def get_scores(self, video):
        with open(path.join(self.mask_dir, video, "scores.csv")) as f:
            lines = f.read().splitlines()
        scores = defaultdict(dict)
        for line in lines:
            frame, obj, score = line.split(",")
            scores[frame[:-4]][obj] = float(score)
        return {frame: float(np.mean(list(objs.values())))
                for frame, objs in scores.items()}

    def __len__(self):
        return len(self.vid_list)


class ReferringYouTubeVOSTestDataset:
    def __init__(self, image_dir: str, mask_dir: str, json_dir: str,
                 size: int = -1):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.size = size
        self.vid_list = sorted(os.listdir(mask_dir))
        self.req_frame_list = {}
        with open(json_dir) as f:
            meta = json.load(f)["videos"]
        for vid in self.vid_list:
            self.req_frame_list[vid] = list(set(meta[vid]["frames"]))

    def get_videos(self):
        return self.vid_list

    def get_objects(self, video):
        return [o for o in sorted(os.listdir(path.join(self.mask_dir, video)))
                if ".csv" not in o]

    def get_offline_sampled_frames(self, video, object_name,
                                   num_sampled_frames):
        return VideoReader(
            video,
            path.join(self.image_dir, video),
            path.join(self.mask_dir, video),
            size=self.size,
            soft_mask=True,
            num_sampled_frames=num_sampled_frames,
            use_all_masks=True,
            to_save=self.req_frame_list[video],
            object_name=object_name)

    def get_partial_video_loader(self, video, object_name, *, start, end,
                                 reverse):
        return VideoReader(
            video,
            path.join(self.image_dir, video),
            path.join(self.mask_dir, video),
            size=self.size,
            soft_mask=True,
            start=start,
            end=end,
            reverse=reverse,
            to_save=self.req_frame_list[video],
            object_name=object_name)

    def get_scores(self, video):
        with open(path.join(self.mask_dir, video, "scores.csv")) as f:
            lines = f.read().splitlines()
        scores = defaultdict(dict)
        for line in lines:
            frame, obj, score = line.split(",")
            scores[obj][frame[:-4]] = float(score)
        return scores

    def __len__(self):
        return len(self.vid_list)
