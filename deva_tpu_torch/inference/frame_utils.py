"""Buffered frame record for online/semi-online processing.

A copy of deva_tpu/inference/frame_utils.py
(host-only code: the port imports nothing of deva_tpu, whose package
import loads jax).

Behavioral anchor: reference:deva/inference/frame_utils.py:7-30 (fields are
host numpy here; the reference keeps single-element batch lists from its
DataLoader, we store scalars directly).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from deva_tpu_torch.inference.object_info import ObjectInfo


class FrameInfo:
    def __init__(self, image: np.ndarray, mask: Optional[np.ndarray],
                 segments_info: List[ObjectInfo], ti: int, info: Dict):
        self.image = image          # [H, W, 3] normalized float32
        self.mask = mask            # [H, W] int id mask or None
        self.segments_info = segments_info
        self.ti = ti
        self.info = info

    @property
    def name(self):
        return self.info["frame"]

    @property
    def shape(self):
        return self.info["shape"]

    @property
    def save_needed(self):
        return self.info["save"]

    @property
    def path_to_image(self):
        return self.info.get("path_to_image")
