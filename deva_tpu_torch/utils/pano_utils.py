"""Panoptic id <-> RGB codecs and VPS id postprocessing.

A copy of deva_tpu/utils/pano_utils.py
(host-only code: the port imports nothing of deva_tpu, whose package
import loads jax).

Behavioral anchor: reference:deva/utils/pano_utils.py:7-83 — ids are encoded
base-256 into RGB (r least significant), the converter hands out random unique
ids, and the postprocessor re-ids things/stuff for VPS evaluation.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def id_to_rgb(id_arr):
    """int (or int array [...]) -> uint8 rgb [... , 3], base-256 little-endian."""
    id_arr = np.asarray(id_arr)
    rgb = np.zeros(id_arr.shape + (3,), dtype=np.uint8)
    rem = id_arr.copy()
    for i in range(3):
        rgb[..., i] = rem % 256
        rem = rem // 256
    return rgb


def rgb_to_id(rgb: np.ndarray) -> np.ndarray:
    """uint8 rgb [..., 3] -> int32 id [...]."""
    rgb = rgb.astype(np.int64)
    return (rgb[..., 0] + rgb[..., 1] * 256 + rgb[..., 2] * 256 * 256)


class ID2RGBConverter:
    """Hands out collision-free random ids with their RGB encoding."""

    def __init__(self, rng=None):
        self.all_id = set()
        self.obj_to_id: Dict[int, int] = {}
        self._rng = rng if rng is not None else np.random.default_rng()

    def _id_to_rgb(self, id: int) -> np.ndarray:
        return id_to_rgb(id)

    def convert(self, obj: int) -> Tuple[int, np.ndarray]:
        if obj in self.obj_to_id:
            id = self.obj_to_id[obj]
        else:
            while True:
                id = int(self._rng.integers(255, 256**3))
                if id not in self.all_id:
                    break
            self.obj_to_id[obj] = id
            self.all_id.add(id)
        return id, self._id_to_rgb(id)


class IDPostprocessor:
    """Thing/stuff re-id for VPS evaluation: a (thing, category) pair keeps a
    stable id; all stuff of one category maps to one id; collisions re-draw.
    reference:deva/utils/pano_utils.py:44-83."""

    def __init__(self, rng=None):
        self.thing_obj_to_id: Dict[Tuple[int, int], int] = {}
        self.stuff_to_id: Dict[int, int] = {}
        self.used_ids = set()
        self._rng = rng if rng is not None else np.random.default_rng()

    def _find_new_id(self, default: int) -> int:
        id = default
        while id in self.used_ids:
            id = int(self._rng.integers(256, 256**3))
        self.used_ids.add(id)
        return id

    def convert(self, obj: int, category_id: int, isthing: bool) -> int:
        if isthing:
            key = (obj, category_id)
            if key not in self.thing_obj_to_id:
                self.thing_obj_to_id[key] = self._find_new_id(obj)
            return self.thing_obj_to_id[key]
        if category_id not in self.stuff_to_id:
            self.stuff_to_id[category_id] = self._find_new_id(obj)
        return self.stuff_to_id[category_id]
