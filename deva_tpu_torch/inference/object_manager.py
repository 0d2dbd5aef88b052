"""Host-side object table: immutable object ids <-> dense tensor slots.

A copy of deva_tpu/inference/object_manager.py (host-only code: the port
imports nothing of deva_tpu, whose package import loads jax).

Behavioral anchor: reference:deva/inference/object_manager.py:8-168. Object
(real) ids are immutable; "tmp ids" are 1-based positions in the device
tensors and get re-packed densely on deletion. The port keeps the same dense
packing (device arrays are gathered on deletion, a rare host-driven event) and
additionally pads the object axis to a bucket size (InferenceConfig.
obj_pad_buckets) so per-frame compiled steps never retrace as objects churn.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from deva_tpu_torch.inference.object_info import ObjectInfo


class ObjectManager:
    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.obj_to_tmp_id: Dict[ObjectInfo, int] = {}
        self.tmp_id_to_obj: Dict[int, ObjectInfo] = {}
        self.obj_id_to_obj: Dict[int, ObjectInfo] = {}
        # historical ids survive deletion to avoid collisions
        # (reference:object_manager.py:18-20)
        self.all_historical_object_ids: set = set()
        self.use_long_id = False
        self._rng = rng if rng is not None else np.random.default_rng()

    def _rebuild_obj_id_map(self) -> None:
        self.obj_id_to_obj = {obj.id: obj for obj in self.obj_to_tmp_id}

    def add_new_objects(
        self, objects: Union[List[ObjectInfo], ObjectInfo, List[int]]
    ) -> Tuple[List[int], List[int]]:
        if not isinstance(objects, list):
            objects = [objects]

        tmp_ids, obj_ids = [], []
        for obj in objects:
            if isinstance(obj, (int, np.integer)):
                obj = ObjectInfo(id=int(obj))
            new_obj = ObjectInfo(id=obj.id)
            tries = 0
            # re-draw on collision; long ids (RGB PNG regime) must be >= 256
            # (reference:object_manager.py:38-53)
            while (new_obj.id in self.all_historical_object_ids
                   or (self.use_long_id and new_obj.id < 256)):
                if self.use_long_id:
                    new_obj = ObjectInfo(id=int(self._rng.integers(256, 256**3)))
                else:
                    new_obj = ObjectInfo(id=int(self._rng.integers(1, 256)))
                tries += 1
                if tries > 5000:
                    raise ValueError(
                        "Could not find a free object id; use long ids?")
            new_obj.copy_meta_info(obj)

            tmp_id = len(self.obj_to_tmp_id) + 1
            self.obj_to_tmp_id[new_obj] = tmp_id
            self.tmp_id_to_obj[tmp_id] = new_obj
            self.all_historical_object_ids.add(new_obj.id)
            tmp_ids.append(tmp_id)
            obj_ids.append(new_obj.id)

        self._rebuild_obj_id_map()
        assert tmp_ids == sorted(tmp_ids)
        return tmp_ids, obj_ids

    def delete_objects(self, obj_ids_to_remove: Union[int, List[int]]) -> None:
        if isinstance(obj_ids_to_remove, int):
            obj_ids_to_remove = [obj_ids_to_remove]
        removed = set(obj_ids_to_remove)
        survivors = [self.tmp_id_to_obj[t]
                     for t in sorted(self.tmp_id_to_obj)
                     if self.tmp_id_to_obj[t].id not in removed]
        self.obj_to_tmp_id = {o: i + 1 for i, o in enumerate(survivors)}
        self.tmp_id_to_obj = {i + 1: o for i, o in enumerate(survivors)}
        self._rebuild_obj_id_map()

    def purge_inactive_objects(
            self, max_missed_detection_count: int
    ) -> Tuple[bool, List[int], List[int]]:
        """Returns (purge_activated, surviving old tmp ids, surviving obj ids).
        reference:object_manager.py:91-110."""
        to_delete, tmp_keep, obj_keep = [], [], []
        for obj, tmp in self.obj_to_tmp_id.items():
            if obj.poke_count > max_missed_detection_count:
                to_delete.append(obj.id)
            else:
                tmp_keep.append(tmp)
                obj_keep.append(obj.id)
        if to_delete:
            self.delete_objects(to_delete)
        return bool(to_delete), tmp_keep, obj_keep

    def tmp_cls_to_obj_cls(self, mask: np.ndarray) -> np.ndarray:
        """Remap a tmp-id class mask to real object ids (host, vectorized).
        reference:object_manager.py:112-117."""
        lut = np.zeros(len(self.tmp_id_to_obj) + 1, dtype=np.int64)
        for tmp_id, obj in self.tmp_id_to_obj.items():
            lut[tmp_id] = obj.id
        return lut[np.clip(mask, 0, len(lut) - 1)]

    def get_tmp_to_obj_mapping(self) -> Dict[int, ObjectInfo]:
        return dict(self.tmp_id_to_obj)

    def get_current_segments_info(self) -> List[Dict]:
        return [{
            "category_id": obj.vote_category_id(),
            "id": int(obj.id),
            "score": obj.vote_score(),
        } for obj in self.obj_to_tmp_id]

    @property
    def all_obj_ids(self) -> List[int]:
        return [o.id for o in self.obj_to_tmp_id]

    @property
    def num_obj(self) -> int:
        return len(self.obj_to_tmp_id)

    def has_all(self, objects: List[int]) -> bool:
        return all(o in self.obj_id_to_obj for o in objects)

    def find_object_by_id(self, obj_id: int) -> ObjectInfo:
        return self.obj_id_to_obj[obj_id]

    def tmp_rows_of(self, obj_ids: List[int]) -> List[int]:
        """0-based device rows of the given object ids."""
        return [self.obj_to_tmp_id[self.obj_id_to_obj[o]] - 1 for o in obj_ids]
