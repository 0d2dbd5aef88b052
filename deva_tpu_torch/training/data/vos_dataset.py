"""VOS training dataset: sample num_frames frames with bounded temporal jump,
sequence-consistent + per-frame augmentation via seed replay, <= max_num_obj
objects.

A copy of deva_tpu/training/data/vos_dataset.py, with PIL imported where
an image is read (the card's machine has no PIL).

Behavioral anchor: reference:deva/dataset/vos_dataset.py:14-203. The
augmentation runs on the host over PIL images; the batch leaves as numpy
NHWC, deva_tpu's layout, which the trainer takes.
"""
from __future__ import annotations

import os
from os import path
from typing import Optional

import numpy as np

from deva_tpu_torch.training.data.utils import im_mean, normalize_chw, reseed


class VOSDataset:
    def __init__(self,
                 im_root: str,
                 gt_root: str,
                 max_jump: int,
                 *,
                 size: int = 384,
                 subset: Optional[set] = None,
                 num_frames: int = 3,
                 max_num_obj: int = 3,
                 data_ratio: float = 1.0):
        from deva_tpu_torch.training.data import transforms as T

        self.im_root = im_root
        self.gt_root = gt_root
        self.max_jump = max_jump
        self.num_frames = num_frames
        self.max_num_obj = max_num_obj
        self.size = size

        self.videos = []
        self.frames = {}
        vid_list = sorted(os.listdir(im_root))
        for vid in vid_list:
            if subset is not None and vid not in subset:
                continue
            frames = sorted(os.listdir(path.join(im_root, vid)))
            if len(frames) < num_frames:
                continue
            self.frames[vid] = frames
            self.videos.append(vid)
        self.videos = self.videos[:int(len(self.videos) * data_ratio)]
        print(f"{len(self.videos)} out of {len(vid_list)} videos accepted "
              f"in {im_root}.")

        # per-frame photometric jitter (reference:vos_dataset.py:60-62)
        self.pair_im_lone_transform = T.ColorJitter(0.1, 0.05, 0.05, 0)
        # sequence-consistent transforms (reference:vos_dataset.py:65-91)
        self.all_im_lone_transform = T.Compose([
            T.ColorJitter(0.1, 0.03, 0.03, 0),
            T.RandomGrayscale(0.05),
        ])
        self.all_im_dual_transform = T.Compose([
            T.RandomHorizontalFlip(),
            T.RandomAffine(degrees=25, shear=20, interpolation=T.BILINEAR,
                           fill=im_mean),
            T.RandomResizedCrop((size, size), scale=(0.16, 2.0),
                                interpolation=T.BILINEAR),
        ])
        self.all_gt_dual_transform = T.Compose([
            T.RandomHorizontalFlip(),
            T.RandomAffine(degrees=25, shear=20, interpolation=T.NEAREST,
                           fill=0),
            T.RandomResizedCrop((size, size), interpolation=T.NEAREST,
                                scale=(0.16, 2.0)),
        ])

    def _sample_frame_indices(self, length: int):
        """Iterative acceptable-set sampling with bounded jump + 50% time
        reversal (reference:vos_dataset.py:114-132)."""
        this_max_jump = min(length, self.max_jump)
        idx = [np.random.randint(length)]
        acceptable = set(range(max(0, idx[-1] - this_max_jump),
                               min(length, idx[-1] + this_max_jump + 1)))
        acceptable -= set(idx)
        while len(idx) < self.num_frames:
            new = int(np.random.choice(list(acceptable)))
            idx.append(new)
            acceptable |= set(range(max(0, new - this_max_jump),
                                    min(length, new + this_max_jump + 1)))
            acceptable -= set(idx)
        idx = sorted(idx)
        if np.random.rand() < 0.5:
            idx = idx[::-1]
        return idx

    def __getitem__(self, idx: int):
        from PIL import Image
        video = self.videos[idx]
        info = {"name": video}
        vid_im_path = path.join(self.im_root, video)
        vid_gt_path = path.join(self.gt_root, video)
        frames = self.frames[video]

        trials = 0
        target_objects = []
        while trials < 5:
            info["frames"] = []
            frames_idx = self._sample_frame_indices(len(frames))
            sequence_seed = np.random.randint(2147483647)
            images, masks = [], []
            for f_idx in frames_idx:
                jpg_name = frames[f_idx][:-4] + ".jpg"
                png_name = frames[f_idx][:-4] + ".png"
                info["frames"].append(jpg_name)

                reseed(sequence_seed)
                im = Image.open(path.join(vid_im_path,
                                          jpg_name)).convert("RGB")
                im = self.all_im_dual_transform(im)
                im = self.all_im_lone_transform(im)
                reseed(sequence_seed)
                gt = Image.open(path.join(vid_gt_path,
                                          png_name)).convert("P")
                gt = self.all_gt_dual_transform(gt)
                im = self.pair_im_lone_transform(im)

                images.append(normalize_chw(
                    np.asarray(im, np.float32).transpose(2, 0, 1) / 255.0))
                masks.append(np.array(gt))

            labels = np.unique(masks[0])
            labels = labels[labels != 0]
            if len(labels) == 0:
                trials += 1
            else:
                target_objects = labels.tolist()
                break

        if len(target_objects) > self.max_num_obj:
            target_objects = np.random.choice(
                target_objects, size=self.max_num_obj, replace=False)
        info["num_objects"] = max(1, len(target_objects))

        masks = np.stack(masks, 0)
        cls_gt = np.zeros((self.num_frames, self.size, self.size), np.int32)
        first_frame_gt = np.zeros((self.max_num_obj, self.size, self.size),
                                  np.float32)
        for i, l in enumerate(target_objects):
            this_mask = masks == l
            cls_gt[this_mask] = i + 1
            first_frame_gt[i] = this_mask[0]
        selector = np.array([1 if i < info["num_objects"] else 0
                             for i in range(self.max_num_obj)], np.float32)

        # NHWC, deva_tpu's batch layout
        rgb = np.stack(images, 0).transpose(0, 2, 3, 1)
        return {"rgb": rgb, "first_frame_gt": first_frame_gt,
                "cls_gt": cls_gt, "selector": selector, "info": info}

    def __len__(self):
        return len(self.videos)
