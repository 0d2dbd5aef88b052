"""Training-data helpers.

A copy of deva_tpu/training/data/utils.py (reference:deva/dataset/utils.py):
host-only code, which the port copies because it imports nothing of
deva_tpu. The augmentation runs on the host over PIL images and gives
numpy batches to the train step.
"""
import random

import numpy as np

im_mean = (124, 116, 104)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def reseed(seed: int) -> None:
    """Seed the stdlib RNG that drives the PIL transforms; calling this with
    the same seed before transforming an image and its mask replays the same
    geometric transform (reference:deva/dataset/utils.py reseed)."""
    random.seed(seed)


def normalize_chw(img_chw: np.ndarray) -> np.ndarray:
    """float [3,H,W] in [0,1] -> ImageNet-normalized."""
    return (img_chw - IMAGENET_MEAN[:, None, None]) / \
        IMAGENET_STD[:, None, None]


def all_to_onehot(masks: np.ndarray, labels) -> np.ndarray:
    shape = (len(labels), *masks.shape)
    out = np.zeros(shape, dtype=np.uint8)
    for ni, l in enumerate(labels):
        out[ni] = (masks == l).astype(np.uint8)
    return out
