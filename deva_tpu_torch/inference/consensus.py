"""In-clip consensus: spatial alignment onto a keyframe, pairwise tube IoU,
and segment selection.

A copy of deva_tpu/inference/consensus.py (host-only code: the port imports
nothing of deva_tpu, whose package import loads jax). Both functions call
back into the core's spatial_alignment with padded HWC numpy frames.

Behavioral anchors:
  spatial alignment + known association:
    reference:deva/inference/consensus_associated.py:16-147
  unknown association (re-index, project, pairwise IoU, integer program):
    reference:deva/inference/consensus_automatic.py:82-272

Split: the alignment (encode mask -> top-k attention -> decode) runs on the
core's device (InferenceCore.spatial_alignment); mask bookkeeping and the
tiny integer program (deva_tpu_torch/inference/ilp.py) run on the host. The
reference's per-pair `(combined == label).sum()` scan is replaced by one joint
np.bincount histogram per frame pair — identical intersections.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Literal, Optional, Tuple

import numpy as np

from deva_tpu_torch.inference.frame_utils import FrameInfo
from deva_tpu_torch.inference.ilp import solve_consensus_ilp
from deva_tpu_torch.inference.object_info import ObjectInfo
from deva_tpu_torch.ops.pad import pad_amounts


def _pad_hw(arr: np.ndarray, pad) -> np.ndarray:
    lw, uw, lh, uh = pad
    pads = [(0, 0)] * (arr.ndim - 2) + [(lh, uh), (lw, uw)]
    return np.pad(arr, pads)


def _unpad_hw(arr: np.ndarray, pad) -> np.ndarray:
    lw, uw, lh, uh = pad
    h, w = arr.shape[-2:]
    return arr[..., lh:h - uh or None, lw:w - uw or None]


def find_consensus_auto_association(
        frames: List[FrameInfo],
        core,
        keyframe_selection: Literal["last", "middle", "score",
                                    "first"] = "last",
        precomputed_proj: Optional[Dict[int, np.ndarray]] = None,
) -> Tuple[int, np.ndarray, List[ObjectInfo]]:
    """frames: buffered FrameInfos with id masks + segments_info.
    Returns (keyframe_ti, consensus id mask [H, W], merged ObjectInfos).
    reference:consensus_automatic.py:82-272.

    precomputed_proj: optional {frame_index: argmaxed channel-index map
    [H, W] int, padded domain} — spatial alignments computed elsewhere
    (inference/batched_detection.py: BatchedDetectionPropagator.
    align_consensus_batched, one batched call with the argmax on the
    device) instead of one core.spatial_alignment call per frame. Frames
    missing from the dict fall back to core.spatial_alignment."""
    time_indices = [f.ti for f in frames]
    h, w = frames[0].image.shape[:2]
    pad = pad_amounts(h, w, 16)

    # images and one-hot stacks are built LAZILY: with precomputed_proj
    # covering every non-keyframe frame (the batched-alignment fast path)
    # only the keyframe's one-hot is ever materialized, skipping ~8 full-res
    # pad copies + bool->f32 stacks per video per cycle on the host
    def padded_image(i):
        im = _pad_hw(np.moveaxis(frames[i].image, -1, 0), pad)
        return np.moveaxis(im, 0, -1)

    def padded_mask(i):
        return _pad_hw(np.asarray(frames[i].mask, np.int64), pad)

    def one_hot(i):
        m = padded_mask(i)
        return np.stack([m == seg.id for seg in frames[i].segments_info]
                        ).astype(np.float32)

    # re-index all segments with globally unique internal ids (1-based)
    internal_id = 0
    all_new_segments_info: Dict[int, ObjectInfo] = {}
    frame_index_to_seg_info = defaultdict(list)
    channel_mappings = []
    for i, f in enumerate(frames):
        mapping = {}
        for si, seg in enumerate(f.segments_info):
            internal_id += 1
            new_seg = ObjectInfo(internal_id)
            new_seg.copy_meta_info(seg)
            all_new_segments_info[internal_id] = new_seg
            mapping[si] = internal_id
            frame_index_to_seg_info[i].append(new_seg)
        channel_mappings.append(mapping)

    if keyframe_selection == "last":
        keyframe_i = len(time_indices) - 1
    elif keyframe_selection == "first":
        keyframe_i = 0
    elif keyframe_selection == "middle":
        keyframe_i = (len(time_indices) + 1) // 2
    else:
        raise NotImplementedError(keyframe_selection)
    keyframe_ti = time_indices[keyframe_i]

    total_segments = internal_id
    if total_segments == 0:
        return keyframe_ti, np.zeros_like(np.asarray(frames[0].mask)), []

    # project every frame's segments onto the keyframe
    projected_masks: List[Optional[np.ndarray]] = []
    seg_areas: Dict[int, int] = {}
    seg_mask: Dict[int, np.ndarray] = {}
    for i, ti in enumerate(time_indices):
        if not frame_index_to_seg_info[i]:
            projected_masks.append(None)
            continue
        if ti == keyframe_ti:
            mask = one_hot(i)
            proj = np.concatenate(
                [np.full_like(mask[:1], 0.5), mask], axis=0)
            proj = np.argmax(proj, axis=0)
        elif precomputed_proj is not None and i in precomputed_proj:
            proj = np.asarray(precomputed_proj[i])  # already argmaxed ids
        else:
            proj = core.spatial_alignment(ti, padded_image(i), one_hot(i),
                                          keyframe_ti,
                                          padded_image(keyframe_i))
            proj = np.argmax(proj, axis=0)  # padded domain, channel indices
        remapped = np.zeros_like(proj)
        for channel_id, object_id in channel_mappings[i].items():
            m = proj == (channel_id + 1)
            remapped[m] = object_id
            seg_areas[object_id] = int(m.sum())
            seg_mask[object_id] = m
        projected_masks.append(remapped.astype(np.int64))

    pairwise_iou, conflict, matching_table = pairwise_support(
        projected_masks, frame_index_to_seg_info, seg_areas, total_segments)
    results = solve_consensus_ilp(pairwise_iou, conflict)

    output_mask = np.zeros_like(np.asarray(frames[0].mask))
    output_info: List[ObjectInfo] = []
    selected_areas = {}
    for channel_id, selected in enumerate(results):
        if selected:
            object_id = channel_id + 1
            selected_areas[object_id] = seg_areas[object_id]
            info = all_new_segments_info[object_id]
            for other in matching_table[object_id]:
                info.merge(all_new_segments_info[other])
            output_info.append(info)

    # paint largest first (small objects on top), then unpad
    painted = np.zeros_like(projected_masks[keyframe_i]
                            if projected_masks[keyframe_i] is not None
                            else padded_mask(0))
    for object_id, _ in sorted(selected_areas.items(), key=lambda x: x[1],
                               reverse=True):
        painted[seg_mask[object_id]] = object_id
    output_mask = _unpad_hw(painted, pad)
    return keyframe_ti, output_mask, output_info


def pairwise_support(projected_masks: List[Optional[np.ndarray]],
                     frame_index_to_seg_info: Dict[int, List[ObjectInfo]],
                     seg_areas: Dict[int, int], total_segments: int):
    """The vote's IoU tables: one joint histogram per pair of projected
    frames (internal ids 1..total_segments, None for a frame without
    segments), greedy IoU > 0.5 matching within each isthing group. ->
    (pairwise_iou [N, N] f32, symmetric, zero outside conflicts; conflict
    bool [N, N]; matching_table {id: matched ids}), the integer program's
    input."""
    pairwise_iou = np.zeros((total_segments, total_segments), np.float32)
    matching_table = defaultdict(list)
    n_ids = total_segments + 1
    for i in range(len(projected_masks)):
        if projected_masks[i] is None:
            continue
        for j in range(i + 1, len(projected_masks)):
            if projected_masks[j] is None:
                continue
            joint = projected_masks[i] * n_ids + projected_masks[j]
            counts = np.bincount(joint.ravel(), minlength=n_ids * n_ids)
            inter = counts.reshape(n_ids, n_ids)
            for isthing_status in (None, False, True):
                matched_j = set()
                for obj1 in frame_index_to_seg_info[i]:
                    if obj1.isthing != isthing_status:
                        continue
                    id1 = obj1.id
                    for obj2 in frame_index_to_seg_info[j]:
                        id2 = obj2.id
                        if (obj2.isthing != isthing_status) or \
                                (id2 in matched_j):
                            continue
                        inter_ij = int(inter[id1, id2])
                        if inter_ij == 0:
                            continue
                        union = seg_areas[id1] + seg_areas[id2] - inter_ij
                        iou = inter_ij / union
                        if iou > 0.5:
                            matching_table[id1].append(id2)
                            matching_table[id2].append(id1)
                            matched_j.add(id2)
                            pairwise_iou[id1 - 1, id2 - 1] = iou
                            break

    pairwise_iou = pairwise_iou + pairwise_iou.T
    conflict = pairwise_iou > 0.49
    pairwise_iou = pairwise_iou * conflict

    return pairwise_iou, conflict, matching_table


def find_consensus_with_established_association(
        time_indices: List[int],
        images: List[np.ndarray],
        masks: List[np.ndarray],
        core,
        scores: Optional[List[float]] = None) -> Tuple[int, np.ndarray]:
    """Soft consensus when channel correspondence is known (referring VOS /
    saliency). images: [H,W,3]; masks: [num_obj,H,W] float.
    reference:consensus_associated.py:82-147."""
    h, w = images[0].shape[:2]
    pad = pad_amounts(h, w, 16)
    images = [_pad_hw(np.moveaxis(im, -1, 0), pad) for im in images]
    images = [np.moveaxis(im, 0, -1) for im in images]
    masks = [_pad_hw(np.asarray(m, np.float32), pad) for m in masks]

    use_score = scores is not None
    if scores is None:
        scores = [1.0 for _ in time_indices]
    s = np.exp(np.asarray(scores, np.float64) * 2)
    scores = (s / s.sum()).tolist()

    keyframe_objective = float("-inf")
    keyframe_i = 0
    for i, (mask, score) in enumerate(zip(masks, scores)):
        objective = score if use_score else float((mask > 0.8).mean())
        if objective > keyframe_objective:
            keyframe_objective = objective
            keyframe_i = i
    keyframe_ti = time_indices[keyframe_i]
    keyframe_score = scores[keyframe_i]

    total = masks[keyframe_i] * keyframe_score
    for i, (ti, score) in enumerate(zip(time_indices, scores)):
        if ti == keyframe_ti:
            continue
        proj = core.spatial_alignment(ti, images[i], masks[i], keyframe_ti,
                                      images[keyframe_i])
        total = total + proj[1:] * score
    return keyframe_ti, _unpad_hw(total, pad)
