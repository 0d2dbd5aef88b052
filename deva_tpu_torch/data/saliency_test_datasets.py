"""DAVIS16-style saliency meta-dataset (single-object soft masks).

A copy of deva_tpu/data/saliency_test_datasets.py (host-only code: the port
imports nothing of deva_tpu); the readers are the port's VideoReader.

Behavioral anchor: reference:deva/inference/data/saliency_test_datasets.py:7-63.
"""
from __future__ import annotations

import os
from os import path

from deva_tpu_torch.data.video_reader import VideoReader


class DAVISSaliencyTestDataset:
    def __init__(self, image_dir: str, mask_dir: str, imset=None,
                 size: int = -1):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.size = size
        if imset is None:
            self.vid_list = sorted(os.listdir(mask_dir))
        else:
            with open(imset) as f:
                self.vid_list = sorted(line.strip() for line in f)

    def _reader(self, video, **kw):
        return VideoReader(
            video,
            path.join(self.image_dir, video),
            path.join(self.mask_dir, video),
            to_save=[n[:-4]
                     for n in os.listdir(path.join(self.mask_dir, video))],
            size=self.size,
            soft_mask=True,
            use_all_masks=True,
            multi_object=False,
            **kw)

    def get_datasets(self):
        for video in self.vid_list:
            yield self._reader(video)

    def get_videos(self):
        return self.vid_list

    def get_offline_sampled_frames(self, video, num_sampled_frames):
        return self._reader(video, num_sampled_frames=num_sampled_frames)

    def get_partial_video_loader(self, video, *, start, end, reverse):
        r = VideoReader(
            video,
            path.join(self.image_dir, video),
            path.join(self.mask_dir, video),
            to_save=[n[:-4]
                     for n in os.listdir(path.join(self.mask_dir, video))],
            size=self.size,
            soft_mask=True,
            start=start,
            end=end,
            reverse=reverse,
            multi_object=False)
        return r

    def __len__(self):
        return len(self.vid_list)
