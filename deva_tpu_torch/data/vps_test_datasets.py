"""Meta-datasets for detection-driven evaluation (VIPSeg / BURST / demo).

A copy of deva_tpu/data/vps_test_datasets.py (host-only code: the port
imports nothing of deva_tpu, whose package import loads jax). The BURST
video order file burst_{split}.txt is looked up beside this module, as in
deva_tpu, and neither package ships one.

Behavioral anchor: reference:deva/inference/data/vps_test_datasets.py:8-85.
"""
from __future__ import annotations

import json
import os
from os import path

from deva_tpu_torch.data.detection_video_reader import DetectionVideoReader


class VIPSegDetectionTestDataset:
    def __init__(self, image_dir: str, mask_dir: str, size: int = -1):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.size = size
        self.vid_list = sorted(v for v in os.listdir(mask_dir)
                               if not v.endswith(".json"))

    def get_datasets(self):
        for video in self.vid_list:
            mask_dir = path.join(self.mask_dir, video)
            yield DetectionVideoReader(
                video,
                path.join(self.image_dir, video),
                mask_dir,
                to_save=[n[:-4] for n in os.listdir(mask_dir)],
                size=self.size)

    def __len__(self):
        return len(self.vid_list)


class BURSTDetectionTestDataset:
    def __init__(self, image_dir: str, mask_dir: str, gt_json_dir: str,
                 size: int = -1, *, start=None, count=None,
                 video_list_path: str = None):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.size = size

        with open(gt_json_dir) as f:
            json_file = json.load(f)
        sequences = json_file["sequences"]
        split = json_file["split"]
        assert split in ("test", "val")

        # a randomized video ordering balances the manual shards
        # (reference:vps_test_datasets.py:42-51)
        if video_list_path is None:
            video_list_path = path.join(path.dirname(__file__),
                                        f"burst_{split}.txt")
        if path.exists(video_list_path):
            with open(video_list_path) as f:
                randomized_videos = f.read().splitlines()
        else:
            randomized_videos = sorted(
                path.join(s["dataset"], s["seq_name"]) for s in sequences)

        if start is not None and count is not None:
            randomized_videos = randomized_videos[start:start + count]
            print(f"Start: {start}, Count: {count}, End: {start + count}")

        self.vid_list = []
        self.frames_to_save = {}
        for sequence in sequences:
            video_name = path.join(sequence["dataset"], sequence["seq_name"])
            if video_name not in randomized_videos:
                continue
            self.vid_list.append(video_name)
            self.frames_to_save[video_name] = [
                p[:-4] for p in sequence["annotated_image_paths"]]
            assert path.exists(path.join(image_dir, video_name))
            assert path.exists(path.join(mask_dir, video_name))

        assert len(self.vid_list) == len(randomized_videos)
        self.vid_list = randomized_videos

    def get_datasets(self):
        for video in self.vid_list:
            yield DetectionVideoReader(
                video,
                path.join(self.image_dir, video),
                path.join(self.mask_dir, video),
                to_save=self.frames_to_save[video],
                size=self.size)

    def __len__(self):
        return len(self.vid_list)
