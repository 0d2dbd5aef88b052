"""Segment matching & merging between propagated and detected masks
(paper Section 3.2.2).

A copy of deva_tpu/inference/segment_merging.py
(host-only code: the port imports nothing of deva_tpu, whose package
import loads jax).

Behavioral anchor: reference:deva/inference/segment_merging.py:17-143. Exact
same greedy IoU>0.5 bipartite matching per isthing group ({None, False, True}),
largest-area-first rendering (small objects end up on top), poke/unpoke
lifecycle, and global max_num_objects denial. The per-pair mask reductions are
replaced by one joint histogram (np.bincount) over (tmp_id, new_id) labels —
identical IoUs, one pass over the pixels.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np

from deva_tpu_torch.inference.object_info import ObjectInfo
from deva_tpu_torch.inference.object_manager import ObjectManager


def match_and_merge(our_mask: np.ndarray,
                    new_mask: np.ndarray,
                    object_manager: ObjectManager,
                    new_segments_info: List[ObjectInfo],
                    *,
                    max_num_objects: int = -1,
                    incremental_mode: bool = False) -> np.ndarray:
    """our_mask: [H, W] in tmp ids; new_mask: [H, W] in real (json) ids.
    Updates the object manager in place; returns one-hot [num_obj, H, W]
    float32 ordered by tmp id."""
    our_mask = np.asarray(our_mask).astype(np.int64)
    new_mask = np.asarray(new_mask).astype(np.int64)

    if max_num_objects > 0 and (
            len(object_manager.obj_to_tmp_id) + len(new_segments_info)
            > max_num_objects):
        warnings.warn("Number of objects exceeded maximum "
                      "(--max_num_objects); discarding new objects")
        new_segments_info = []

    # joint intersection histogram over (tmp_id, new_id_index)
    new_ids = [obj.id for obj in new_segments_info]
    new_index = {oid: i + 1 for i, oid in enumerate(new_ids)}
    k = len(new_ids) + 1
    new_idx_mask = np.zeros_like(new_mask)
    for oid, i in new_index.items():
        new_idx_mask[new_mask == oid] = i
    n_tmp = len(object_manager.obj_to_tmp_id)
    joint = our_mask * k + new_idx_mask
    counts = np.bincount(joint.ravel(), minlength=(n_tmp + 1) * k)
    inter = counts.reshape(n_tmp + 1, k)  # [tmp_id, new_index]
    our_sums = inter.sum(axis=1)          # per tmp id (incl. 0 = bg)
    new_sums = inter.sum(axis=0)          # per new index (incl. 0 = bg)

    merged = np.zeros_like(our_mask)
    for isthing_status in (None, False, True):
        _merge_group(merged, our_mask, new_mask, inter, our_sums, new_sums,
                     new_index, object_manager, new_segments_info,
                     isthing_status, incremental_mode)

    # one-hot in tmp order (reference:object_manager.py:133-141)
    out = []
    for _, obj in sorted(object_manager.tmp_id_to_obj.items()):
        out.append(merged == obj.id)
    if not out:
        return np.zeros((0, *merged.shape), np.float32)
    return np.stack(out).astype(np.float32)


def _merge_group(merged, our_mask, new_mask, inter, our_sums, new_sums,
                 new_index, object_manager: ObjectManager,
                 new_segments_info: List[ObjectInfo],
                 isthing_status: Optional[bool],
                 incremental_mode: bool) -> None:
    """One isthing group of the greedy match + render.
    reference:segment_merging.py:25-86."""
    our_to_new: Dict[ObjectInfo, ObjectInfo] = {}
    matched_area = {}
    for new_obj in new_segments_info:
        if new_obj.isthing != isthing_status:
            continue
        ni = new_index[new_obj.id]
        matched = False
        for our_obj, tmp in object_manager.obj_to_tmp_id.items():
            if (our_obj.isthing != isthing_status) or (our_obj in our_to_new):
                continue
            i = int(inter[tmp, ni])
            if i == 0:
                continue
            union = int(our_sums[tmp]) + int(new_sums[ni]) - i
            if i / union > 0.5:
                our_to_new[our_obj] = new_obj
                matched_area[(our_obj, False)] = union
                matched = True
                break
        if not matched:
            matched_area[(new_obj, True)] = int(new_sums[ni])

    for our_obj, tmp in object_manager.obj_to_tmp_id.items():
        if (our_obj.isthing != isthing_status) or (our_obj in our_to_new):
            continue
        matched_area[(our_obj, False)] = int(our_sums[tmp])

    # render largest-area first so small objects stay on top
    for (obj, is_new), _ in sorted(matched_area.items(),
                                   key=lambda x: x[1], reverse=True):
        if is_new:
            _, new_obj_ids = object_manager.add_new_objects(obj)
            merged[new_mask == obj.id] = new_obj_ids[0]
        else:
            tmp = object_manager.obj_to_tmp_id[obj]
            if obj in our_to_new:
                new_obj = our_to_new[obj]
                merged[our_mask == tmp] = obj.id
                merged[new_mask == new_obj.id] = obj.id
                obj.merge(new_obj)
                obj.unpoke()
            else:
                merged[our_mask == tmp] = obj.id
                if incremental_mode:
                    if our_sums[tmp] < 1:
                        obj.poke()
                    else:
                        obj.unpoke()
                else:
                    obj.poke()
