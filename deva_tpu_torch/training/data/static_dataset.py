"""Pseudo-video training data from static saliency images: per-frame
affine/crop jitter + occasional thin-plate-spline warp, multi-object
composition by pasting additional samples.

A copy of deva_tpu/training/data/static_dataset.py, with PIL imported
where an image is read (the card's machine has no PIL).

Behavioral anchor: reference:deva/dataset/static_dataset.py:15-191.
"""
from __future__ import annotations

import os
from os import path
from typing import List, Tuple

import numpy as np

from deva_tpu_torch.training.data.tps import random_tps_warp
from deva_tpu_torch.training.data.utils import im_mean, normalize_chw, reseed


class StaticTransformDataset:
    """parameters: list of (data_root, method, multiplier); method 0 = FSS
    style (class/1.jpg class/1.png), 1 = flat (XXX.jpg XXX.png)."""

    def __init__(self, parameters: List[Tuple[str, int, int]], *,
                 size: int = 384, num_frames: int = 3, max_num_obj: int = 1):
        from deva_tpu_torch.training.data import transforms as T

        self.num_frames = num_frames
        self.max_num_obj = max_num_obj
        self.size = size

        self.im_list = []
        for root, method, multiplier in parameters:
            if method == 0:
                for c in os.listdir(root):
                    jpgs = [im for im in os.listdir(path.join(root, c))
                            if im[-3:].lower() == "jpg"]
                    self.im_list.extend(
                        [path.join(root, c, im) for im in jpgs] * multiplier)
            elif method == 1:
                self.im_list.extend(
                    [path.join(root, im) for im in os.listdir(root)
                     if ".jpg" in im] * multiplier)
        print(f"{len(self.im_list)} images found.")

        self.pair_im_lone_transform = T.ColorJitter(0.1, 0.05, 0.05, 0)
        self.pair_im_dual_transform = T.Compose([
            T.RandomAffine(degrees=20, scale=(0.5, 2.0), shear=10,
                           interpolation=T.BICUBIC, fill=im_mean),
            T.Resize(size, T.BICUBIC),
            T.RandomCrop((size, size), pad_if_needed=True, fill=im_mean),
        ])
        self.pair_gt_dual_transform = T.Compose([
            T.RandomAffine(degrees=20, scale=(0.5, 2.0), shear=10,
                           interpolation=T.BICUBIC, fill=0),
            T.Resize(size, T.NEAREST),
            T.RandomCrop((size, size), pad_if_needed=True, fill=0),
        ])
        self.all_im_lone_transform = T.Compose([
            T.ColorJitter(0.1, 0.05, 0.05, 0.05),
            T.RandomGrayscale(0.05),
        ])
        self.all_im_dual_transform = T.Compose([
            T.RandomAffine(degrees=0, scale=(0.5, 2.0), fill=im_mean),
            T.RandomHorizontalFlip(),
        ])
        self.all_gt_dual_transform = T.Compose([
            T.RandomAffine(degrees=0, scale=(0.5, 2.0), fill=0),
            T.RandomHorizontalFlip(),
        ])

    def _get_sample(self, idx: int):
        from PIL import Image
        im = Image.open(self.im_list[idx]).convert("RGB")
        gt = Image.open(self.im_list[idx][:-3] + "png").convert("L")

        sequence_seed = np.random.randint(2147483647)
        images, masks = [], []
        for _ in range(self.num_frames):
            reseed(sequence_seed)
            this_im = self.all_im_dual_transform(im)
            this_im = self.all_im_lone_transform(this_im)
            reseed(sequence_seed)
            this_gt = self.all_gt_dual_transform(gt)

            pairwise_seed = np.random.randint(2147483647)
            reseed(pairwise_seed)
            this_im = self.pair_im_dual_transform(this_im)
            this_im = self.pair_im_lone_transform(this_im)
            reseed(pairwise_seed)
            this_gt = self.pair_gt_dual_transform(this_gt)

            # TPS applied only sometimes (it is slow; reference notes the same)
            if np.random.rand() < 0.33:
                this_im, this_gt = random_tps_warp(this_im, this_gt,
                                                   scale=0.02)

            images.append(normalize_chw(
                np.asarray(this_im, np.float32).transpose(2, 0, 1) / 255.0))
            masks.append(np.asarray(this_gt, np.float32)[None] / 255.0)

        return np.stack(images, 0), np.stack(masks, 0)

    def __getitem__(self, idx: int):
        additional_objects = np.random.randint(self.max_num_obj)
        indices = [idx, *np.random.randint(len(self), size=additional_objects)]

        merged_images = None
        merged_masks = np.zeros((self.num_frames, self.size, self.size),
                                np.int64)
        for i, list_id in enumerate(indices):
            images, masks = self._get_sample(int(list_id))
            if merged_images is None:
                merged_images = images
            else:
                merged_images = merged_images * (1 - masks) + images * masks
            merged_masks[masks[:, 0] > 0.5] = i + 1

        labels = np.unique(merged_masks[0])
        labels = labels[labels != 0]
        target_objects = labels.tolist()

        cls_gt = np.zeros((self.num_frames, self.size, self.size), np.int32)
        first_frame_gt = np.zeros((self.max_num_obj, self.size, self.size),
                                  np.float32)
        for i, l in enumerate(target_objects):
            this_mask = merged_masks == l
            cls_gt[this_mask] = i + 1
            first_frame_gt[i] = this_mask[0]

        info = {"name": self.im_list[idx],
                "num_objects": max(1, len(target_objects))}
        selector = np.array([1 if i < info["num_objects"] else 0
                             for i in range(self.max_num_obj)], np.float32)

        rgb = merged_images.transpose(0, 2, 3, 1)
        return {"rgb": rgb.astype(np.float32),
                "first_frame_gt": first_frame_gt,
                "cls_gt": cls_gt, "selector": selector, "info": info}

    def __len__(self):
        return len(self.im_list)
