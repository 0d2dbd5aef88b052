"""Pluggable image-level mask sources and the fusion of their outputs into
DEVA detections.

A copy of deva_tpu/ext/detectors.py with the port's imports: the
ObjectInfo and pano codecs of deva_tpu_torch, the port's MobileSAM
(ext/mobile_sam.py) for the "mobile" and "sam_hq_light" variants, and
ops/resize.py's antialiased bilinear resize in place of PIL's (within
1e-5 of PIL's BILINEAR on float masks, with PIL's same-size copy kept).
transformers and PIL are imported only inside the functions that use them.
The HF detectors (HFGroundedSAM, HFAutomaticSAM) run on `cuda` unless the
caller asks for the CPU (deva_tpu's default is the CPU); the variant
factories take the device from the driver's --device.

Protocols (deva_tpu's):
  TextPromptDetector.detect(image_np, prompts) -> (boxes, scores, class_ids)
    + a box-prompted mask head masks_for_boxes(image_np, boxes) -> masks
  GridMaskGenerator.generate(image_np, positive_points) ->
    {'masks': [N,H,W] float, 'iou_preds': [N]}

Implementations: HFGroundedSAM (Grounding DINO + SAM through
`transformers`), HFAutomaticSAM (SAM grid prompting through
`transformers`), MobileSAM (the port's own, on the card),
SavedDetectionSource, RecordingDetector / ReplayDetector. The fusion
(box_nms, _mask_nms, segment_with_text, auto_segment) is deva_tpu's numpy,
with its np.argsort ties and ids kept as they are (ROADMAP C-4:
auto_segment's default branch numbers the ObjectInfos of the masks that
won a pixel, but paints mask k as k + 1).

Behavioral anchors: reference:deva/ext/grounding_dino.py:32-142,
reference:deva/ext/automatic_sam.py:16-145.
"""
from __future__ import annotations

import json
import os
from os import path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deva_tpu_torch.inference.object_info import ObjectInfo
from deva_tpu_torch.ops.resize import resize_bilinear_aa
from deva_tpu_torch.utils.pano_utils import rgb_to_id


# --------------------------------------------------------------------------
# small numpy helpers
# --------------------------------------------------------------------------

def box_nms(boxes: np.ndarray, scores: np.ndarray,
            iou_threshold: float) -> List[int]:
    """Greedy box NMS (torchvision.ops.nms semantics)."""
    order = np.argsort(-scores)
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) * \
            (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / (area_i + area_r - inter + 1e-9)
        order = rest[iou <= iou_threshold]
    return keep


def _resize_bilinear(mask: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """float [H,W] -> [new_h,new_w] bilinear, antialiased when it shrinks
    (PIL's BILINEAR; the same size is a copy)."""
    out = resize_bilinear_aa(torch.from_numpy(
        np.array(mask, np.float32)), shape)
    return out.numpy()


def _target_shape(h: int, w: int, min_side: int) -> Tuple[int, int]:
    if min_side <= 0:
        return h, w
    scale = min_side / min(h, w)
    return int(h * scale), int(w * scale)


# --------------------------------------------------------------------------
# detector implementations
# --------------------------------------------------------------------------

class HFGroundedSAM:
    """Grounding DINO (text -> boxes) + a pluggable box->mask source.

    mask_source: an object with masks_for_boxes(image_np, boxes) — e.g. the
    port's MobileSAM — replacing the HF SAM (sam_path is then ignored). The
    reference's 4 SAM variants behind one predictor interface:
    reference:deva/ext/grounding_dino.py:41-73."""

    def __init__(self, gdino_path: str, sam_path: str, device: str = "cuda",
                 mask_source=None):
        import torch
        from transformers import (AutoProcessor,
                                  GroundingDinoForObjectDetection)
        self.torch = torch
        self.device = device
        self.gd_processor = AutoProcessor.from_pretrained(gdino_path)
        self.gd_model = GroundingDinoForObjectDetection.from_pretrained(
            gdino_path).to(device).eval()
        self.mask_source = mask_source
        if mask_source is None:
            from transformers import SamModel, SamProcessor
            self.sam_processor = SamProcessor.from_pretrained(sam_path)
            self.sam_model = SamModel.from_pretrained(sam_path).to(
                device).eval()

    def detect(self, image_np: np.ndarray, prompts: List[str],
               box_threshold: float, text_threshold: float):
        torch = self.torch
        text = ". ".join(p.strip() for p in prompts if p.strip()) + "."
        inputs = self.gd_processor(images=image_np, text=text,
                                   return_tensors="pt").to(self.device)
        with torch.no_grad():
            outputs = self.gd_model(**inputs)
        res = self.gd_processor.post_process_grounded_object_detection(
            outputs, inputs.input_ids, threshold=box_threshold,
            text_threshold=text_threshold,
            target_sizes=[image_np.shape[:2]])[0]
        boxes = res["boxes"].cpu().numpy()
        scores = res["scores"].cpu().numpy()
        labels = res.get("text_labels", res.get("labels"))
        norm = [p.strip().lower() for p in prompts]
        class_ids = np.array(
            [norm.index(l.strip().lower()) if l.strip().lower() in norm else 0
             for l in labels], np.int64)
        return boxes, scores, class_ids

    def masks_for_boxes(self, image_np: np.ndarray,
                        boxes: np.ndarray) -> np.ndarray:
        """Best-of-3 SAM masks per box -> [N, H, W] bool."""
        if self.mask_source is not None:
            return self.mask_source.masks_for_boxes(image_np, boxes)
        torch = self.torch
        out = []
        for box in boxes:
            inputs = self.sam_processor(
                image_np, input_boxes=[[box.tolist()]],
                return_tensors="pt").to(self.device)
            with torch.no_grad():
                o = self.sam_model(**inputs, multimask_output=True)
            # post-processed where the logits are; only the best mask
            # comes to the host
            masks = self.sam_processor.image_processor.\
                post_process_masks(o.pred_masks, inputs["original_sizes"],
                                   inputs["reshaped_input_sizes"])[0][0]
            scores = o.iou_scores[0, 0].cpu().numpy()
            out.append(masks[int(np.argmax(scores))].cpu().numpy())
        return np.stack(out) if out else np.zeros((0, *image_np.shape[:2]),
                                                  bool)


class HFAutomaticSAM:
    """SAM grid prompting via transformers: points -> 3 masks each ->
    predicted-IoU filter -> mask NMS; supports external positive points
    (the region-restricted querying of reference:deva/ext/automatic_sam.py:
    67-89)."""

    def __init__(self, sam_path: str, device: str = "cuda",
                 points_per_side: int = 32, points_per_batch: int = 64,
                 pred_iou_thresh: float = 0.88, nms_iou: float = 0.7):
        import torch
        from transformers import SamModel, SamProcessor
        self.torch = torch
        self.device = device
        self.processor = SamProcessor.from_pretrained(sam_path)
        self.model = SamModel.from_pretrained(sam_path).to(device).eval()
        self.points_per_side = points_per_side
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.nms_iou = nms_iou

    def _grid(self, h: int, w: int) -> np.ndarray:
        n = self.points_per_side
        offset = 1 / (2 * n)
        side = np.linspace(offset, 1 - offset, n)
        xs, ys = np.meshgrid(side, side)
        return np.stack([xs.ravel() * w, ys.ravel() * h], -1)

    def generate(self, image_np: np.ndarray,
                 positive_points: Optional[np.ndarray] = None) -> Dict:
        torch = self.torch
        h, w = image_np.shape[:2]
        if positive_points is None:
            points = self._grid(h, w)
        else:
            points = positive_points * np.array([w, h], np.float32)
        all_masks, all_ious = [], []
        for i in range(0, len(points), self.points_per_batch):
            chunk = points[i:i + self.points_per_batch]
            inputs = self.processor(
                image_np,
                input_points=[[[p.tolist()] for p in chunk]],
                return_tensors="pt").to(self.device)
            with torch.no_grad():
                o = self.model(**inputs, multimask_output=True)
            # post-processed where the logits are ([P, 3, H, W]); only the
            # best mask of each prompt that passes the filter comes to the
            # host
            masks = self.processor.image_processor.post_process_masks(
                o.pred_masks, inputs["original_sizes"],
                inputs["reshaped_input_sizes"])[0]
            ious = o.iou_scores[0].cpu().numpy()          # [P, 3]
            best = ious.argmax(-1)
            rows = np.nonzero(ious[np.arange(len(best)), best]
                              >= self.pred_iou_thresh)[0]
            if len(rows):
                kept = masks[torch.as_tensor(rows, device=masks.device),
                             torch.as_tensor(best[rows],
                                             device=masks.device)]
                all_masks.extend(kept.cpu().numpy())
                all_ious.extend(float(ious[pi, best[pi]]) for pi in rows)
        if not all_masks:
            return {"masks": np.zeros((0, h, w), np.float32),
                    "iou_preds": np.zeros((0,), np.float32)}
        masks = np.stack(all_masks).astype(np.float32)
        ious = np.asarray(all_ious, np.float32)
        keep = _mask_nms(masks > 0.5, ious, self.nms_iou)
        return {"masks": masks[keep], "iou_preds": ious[keep]}


def _mask_nms(masks: np.ndarray, scores: np.ndarray, thresh: float):
    order = np.argsort(-scores)
    areas = masks.reshape(len(masks), -1).sum(-1)
    keep = []
    for i in order:
        ok = True
        for j in keep:
            inter = (masks[i] & masks[j]).sum()
            if inter / (areas[i] + areas[j] - inter + 1e-9) > thresh:
                ok = False
                break
        if ok:
            keep.append(int(i))
    return keep


class SavedDetectionSource:
    """Per-frame precomputed detections from disk (palette/RGB PNG + JSON),
    the same contract as the reference's detection readers."""

    def __init__(self, mask_dir: str):
        self.mask_dir = mask_dir

    def load(self, frame_name: str):
        from PIL import Image
        base = path.join(self.mask_dir, frame_name.rsplit(".", 1)[0])
        mask_img = Image.open(base + ".png")
        if mask_img.mode == "RGB":
            mask = rgb_to_id(np.asarray(mask_img, np.int64))
        else:
            mask = np.asarray(mask_img.convert("P"), np.int64)
        segments_info = None
        if os.path.exists(base + ".json"):
            with open(base + ".json") as f:
                segments_info = json.load(f)
        return mask, segments_info


# --------------------------------------------------------------------------
# fusion of detector outputs into DEVA detections
# --------------------------------------------------------------------------

def segment_with_text(cfg: Dict, detector, image_np: np.ndarray,
                      prompts: List[str],
                      min_side: int) -> Tuple[np.ndarray, List[ObjectInfo]]:
    """Text-prompted detection -> NMS -> best mask per box -> id mask sorted
    by descending area (small objects on top).
    reference:deva/ext/grounding_dino.py:78-142."""
    boxes, scores, class_ids = detector.detect(
        image_np, prompts, cfg["DINO_THRESHOLD"], cfg["DINO_THRESHOLD"])
    if len(boxes):
        keep = box_nms(boxes, scores, cfg["DINO_NMS_THRESHOLD"])
        boxes, scores, class_ids = boxes[keep], scores[keep], class_ids[keep]
    masks = detector.masks_for_boxes(image_np, boxes)

    h, w = image_np.shape[:2]
    new_h, new_w = _target_shape(h, w, min_side)
    output_mask = np.zeros((new_h, new_w), np.int64)
    segments_info: List[ObjectInfo] = []
    curr_id = 1
    areas = masks.reshape(len(masks), -1).sum(-1) if len(masks) else []
    for i in np.flip(np.argsort(areas)) if len(masks) else []:
        m = _resize_bilinear(masks[i].astype(np.float32), (new_h, new_w))
        m = m > 0.5
        if m.sum() > 0:
            output_mask[m] = curr_id
            segments_info.append(ObjectInfo(id=curr_id,
                                            category_id=int(class_ids[i]),
                                            score=float(scores[i])))
            curr_id += 1
    return output_mask, segments_info


def auto_segment(cfg: Dict, generator, image_np: np.ndarray,
                 forward_mask: Optional[np.ndarray], min_side: int,
                 suppress_small_mask: bool
                 ) -> Tuple[np.ndarray, List[ObjectInfo]]:
    """Automatic grid-prompted segmentation, optionally restricted to regions
    the forward (propagated) mask leaves unclaimed.
    reference:deva/ext/automatic_sam.py:47-145."""
    h, w = image_np.shape[:2]
    new_h, new_w = _target_shape(h, w, min_side)

    positive_points = None
    if forward_mask is not None:
        fg = (np.asarray(forward_mask) > 0).astype(np.float32)
        blurred = _resize_bilinear(fg, (max(1, fg.shape[0] // 16),
                                        max(1, fg.shape[1] // 16)))
        n = cfg["SAM_NUM_POINTS_PER_SIDE"]
        offset = 1 / (2 * n)
        side = np.linspace(offset, 1 - offset, n)
        xs, ys = np.meshgrid(side, side)
        pts = np.stack([xs.ravel(), ys.ravel()], -1)  # normalized (x, y)
        bh, bw = blurred.shape
        sample = blurred[np.clip((pts[:, 1] * bh).astype(int), 0, bh - 1),
                         np.clip((pts[:, 0] * bw).astype(int), 0, bw - 1)]
        positive_points = pts[sample < 0.01]
        if len(positive_points) == 0:
            return np.zeros((new_h, new_w), np.int64), []

    mask_data = generator.generate(image_np, positive_points)
    pred_masks = np.asarray(mask_data["masks"], np.float32)
    predicted_iou = np.asarray(mask_data["iou_preds"], np.float32)

    segments_info: List[ObjectInfo] = []
    if pred_masks.shape[0] == 0:
        return np.zeros((new_h, new_w), np.int64), segments_info

    pred_masks = np.stack(
        [_resize_bilinear(m, (new_h, new_w)) for m in pred_masks])
    curr_id = 1
    if suppress_small_mask:
        # large masks eat small ones; keep survivors above overlap threshold
        areas = pred_masks.reshape(len(pred_masks), -1).sum(-1)
        scored = pred_masks * areas[:, None, None]
        with_bg = np.concatenate(
            [np.full((1, new_h, new_w), 0.1, np.float32), scored])
        hard = np.argmax(with_bg, axis=0)
        output_mask = np.zeros((new_h, new_w), np.int64)
        for k in range(len(pred_masks)):
            mask_area = int((hard == k + 1).sum())
            original_area = int((pred_masks[k] > 0.5).sum())
            m = (hard == k + 1) & (pred_masks[k] >= 0.5)
            if mask_area > 0 and original_area > 0 and m.sum() > 0:
                if mask_area / original_area < cfg["SAM_OVERLAP_THRESHOLD"]:
                    continue
                output_mask[m] = curr_id
                segments_info.append(
                    ObjectInfo(id=curr_id, score=float(predicted_iou[k])))
                curr_id += 1
    else:
        # prefer smaller objects (score = 2*max_area - area)
        areas = pred_masks.reshape(len(pred_masks), -1).sum(-1)
        scores = areas.max() * 2 - areas
        scored = pred_masks * scores[:, None, None]
        with_bg = np.concatenate(
            [np.full((1, new_h, new_w), 0.1, np.float32), scored])
        output_mask = np.argmax(with_bg, axis=0).astype(np.int64)
        for k in range(len(pred_masks)):
            if (output_mask == k + 1).sum() > 0:
                segments_info.append(
                    ObjectInfo(id=curr_id, score=float(predicted_iou[k])))
                curr_id += 1
    return output_mask, segments_info


# --------------------------------------------------------------------------
# record / replay (fixture-driven detector outputs)
# --------------------------------------------------------------------------

def _image_key(image_np: np.ndarray) -> str:
    import hashlib
    a = np.ascontiguousarray(image_np)
    return hashlib.sha1(a.tobytes() + str(a.shape).encode()).hexdigest()


class RecordingDetector:
    """Wraps a real TextPromptDetector and records every (detect,
    masks_for_boxes) result keyed by image content, so runs with real
    GDINO/SAM weights can be captured once and replayed in environments
    without them (this image has no downloadable checkpoints). Save with
    `.save(path)`; replay with ReplayDetector(path)."""

    def __init__(self, inner):
        self.inner = inner
        self.records: Dict[str, Dict] = {}

    def detect(self, image_np, prompts, box_threshold, text_threshold):
        boxes, scores, class_ids = self.inner.detect(
            image_np, prompts, box_threshold, text_threshold)
        self.records[_image_key(image_np)] = {
            "boxes": boxes, "scores": scores, "class_ids": class_ids}
        return boxes, scores, class_ids

    def masks_for_boxes(self, image_np, boxes):
        masks = self.inner.masks_for_boxes(image_np, boxes)
        self.records[_image_key(image_np)]["masks"] = masks
        return masks

    def save(self, out_path: str) -> None:
        flat = {}
        for key, rec in self.records.items():
            for name, arr in rec.items():
                if name == "masks":
                    arr = np.packbits(np.asarray(arr, bool), axis=None)
                    flat[f"{key}/masks_shape"] = np.asarray(
                        rec["masks"].shape)
                flat[f"{key}/{name}"] = np.asarray(arr)
        np.savez_compressed(out_path, **flat)


class ReplayDetector:
    """Replays recorded detector outputs (RecordingDetector.save format or
    scripts/make_detector_fixture.py). Keyed by image content hash, so the
    frame order / detection cadence need not match the recording run."""

    def __init__(self, npz_path: str):
        self.records: Dict[str, Dict] = {}
        with np.load(npz_path) as data:
            for k in data.files:
                key, name = k.split("/", 1)
                self.records.setdefault(key, {})[name] = data[k]

    def _rec(self, image_np):
        key = _image_key(image_np)
        if key not in self.records:
            raise KeyError(
                f"no recorded detection for this frame (key {key[:12]}…); "
                f"recorded keys: {[k[:12] for k in self.records]}")
        return self.records[key]

    def detect(self, image_np, prompts, box_threshold, text_threshold):
        r = self._rec(image_np)
        return (np.asarray(r["boxes"], np.float32),
                np.asarray(r["scores"], np.float32),
                np.asarray(r["class_ids"], np.int64))

    def masks_for_boxes(self, image_np, boxes):
        r = self._rec(image_np)
        shape = tuple(int(x) for x in r["masks_shape"])
        n = int(np.prod(shape))
        masks = np.unpackbits(r["masks"], count=n).reshape(shape)
        return masks.astype(bool)

    # GridMaskGenerator protocol (automatic mode): replay ignores the point
    # restriction and returns every recorded mask; auto_segment's own
    # filtering still applies
    def generate(self, image_np, positive_points=None):
        r = self._rec(image_np)
        masks = self.masks_for_boxes(image_np, None).astype(np.float32)
        return {"masks": masks,
                "iou_preds": np.asarray(r["scores"], np.float32)}


# --------------------------------------------------------------------------
# variant factories (the reference's 4-way SAM dispatch,
# reference:deva/ext/grounding_dino.py:32-75 / automatic_sam.py:16-44)
# --------------------------------------------------------------------------

# --sam_variant values that select the port's MobileSAM / Light-HQ-SAM
MOBILE_VARIANTS = ("mobile", "sam_hq_light", "light_hq")


def _mobile_sam_from_args(args, variant: str, **kw):
    from deva_tpu_torch.ext.mobile_sam import MobileSAM
    hq = variant in ("sam_hq_light", "light_hq")
    ckpt = getattr(args, "LIGHT_HQ_SAM_CHECKPOINT_PATH" if hq
                   else "MOBILE_SAM_CHECKPOINT_PATH", None)
    device = getattr(args, "device", "cuda")
    if ckpt and os.path.exists(ckpt):
        return MobileSAM.from_checkpoint(ckpt, hq=hq, device=device, **kw)
    print(f"SAM checkpoint {ckpt!r} not found; using random-init "
          f"MobileSAM(hq={hq}) (protocol mode)")
    return MobileSAM(hq=hq, device=device, **kw)


def build_text_detector(args):
    """--sam_variant -> text-pipeline detector (detect + masks_for_boxes).
    'mobile'/'sam_hq_light' run the port's MobileSAM / Light-HQ-SAM;
    'original'/'sam_hq'/'hf' use the HF SAM at SAM_HF_PATH."""
    variant = getattr(args, "sam_variant", "original").lower()
    device = getattr(args, "device", "cuda")
    if variant in MOBILE_VARIANTS:
        ms = _mobile_sam_from_args(args, variant)
        return HFGroundedSAM(args.GROUNDING_DINO_HF_PATH, None,
                             device=device, mask_source=ms)
    return HFGroundedSAM(args.GROUNDING_DINO_HF_PATH, args.SAM_HF_PATH,
                         device=device)


def build_auto_generator(args):
    """--sam_variant -> automatic grid-prompting generator (.generate)."""
    variant = getattr(args, "sam_variant", "original").lower()
    kw = dict(points_per_side=args.SAM_NUM_POINTS_PER_SIDE,
              points_per_batch=args.SAM_NUM_POINTS_PER_BATCH,
              pred_iou_thresh=args.SAM_PRED_IOU_THRESHOLD)
    if variant in MOBILE_VARIANTS:
        return _mobile_sam_from_args(args, variant, **kw)
    return HFAutomaticSAM(args.SAM_HF_PATH,
                          device=getattr(args, "device", "cuda"), **kw)
