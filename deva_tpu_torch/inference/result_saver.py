"""Asynchronous result writer: the argmax happens on the caller thread, on
the probabilities' device; id remapping, JSON assembly, RLE, PNG writing and
visualization run on a daemon worker thread fed by a bounded queue (so disk
IO overlaps device compute).

A copy of deva_tpu/inference/result_saver.py (host-only code: the port
imports nothing of deva_tpu, whose package import loads jax). deva_tpu's
jitted `device_argmax_ids` becomes ops/aggregate.argmax_ids (torch.argmax on
the tensor's device, with the same dtype and tie rules), and PIL is imported
inside the worker only.

Behavioral anchor: reference:deva/inference/result_utils.py:22-285. The
supervision-based box/label overlay is replaced by a small numpy/PIL renderer
(deva_tpu_torch/utils/viz.py) since `supervision` isn't available here.
"""
from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass, field
from os import path
from queue import Queue
from threading import Thread
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deva_tpu_torch.data.transforms import resize_prob_to
from deva_tpu_torch.inference.object_manager import ObjectManager
from deva_tpu_torch.ops.aggregate import argmax_ids
from deva_tpu_torch.utils import rle as rle_codec
from deva_tpu_torch.utils.pano_utils import ID2RGBConverter, id_to_rgb
from deva_tpu_torch.utils.viz import overlay_segmentation


class ResultSaver:
    def __init__(self,
                 output_root: str,
                 video_name: Optional[str],
                 *,
                 dataset: str,
                 object_manager: ObjectManager,
                 palette: Optional[bytes] = None):
        self.output_root = output_root
        self.video_name = video_name
        self.dataset = dataset.lower()
        self.palette = palette
        self.object_manager = object_manager

        self.need_remapping = False
        self.json_style = None
        self.output_postfix = None
        self.visualize = False
        self.writer = None  # for gradio-style streaming

        if self.dataset == "vipseg":
            self.all_annotations = []
            self.video_json = {"video_id": video_name,
                               "annotations": self.all_annotations}
            self.need_remapping = True
            self.json_style = "vipseg"
            self.output_postfix = "pan_pred"
        elif self.dataset == "burst":
            self.all_annotations = []
            self.video_json = {
                "dataset": path.dirname(video_name),
                "seq_name": path.basename(video_name),
                "segmentations": self.all_annotations,
            }
            self.need_remapping = True
            self.json_style = "burst"
        elif self.dataset == "unsup_davis17":
            self.need_remapping = True
        elif self.dataset == "ref_davis":
            pass
        elif self.dataset == "demo":
            self.all_annotations = []
            self.video_json = {"annotations": self.all_annotations}
            self.need_remapping = True
            self.json_style = "vipseg"
            self.visualize = True
            self.visualize_postfix = "Visualizations"
            self.output_postfix = "Annotations"
        elif self.dataset == "gradio":
            self.need_remapping = True
            self.visualize = True
        else:
            raise NotImplementedError(dataset)

        self.id2rgb_converter = ID2RGBConverter()

        self.queue: Queue = Queue(maxsize=10)
        self._errors: List[BaseException] = []
        self.thread = Thread(target=_worker,
                             args=(self.queue, self._errors), daemon=True)
        self.thread.start()

    def save_mask(self,
                  prob,
                  frame_name: str,
                  need_resize: bool = False,
                  shape: Optional[Tuple[int, int]] = None,
                  save_the_mask: bool = True,
                  image_np: Optional[np.ndarray] = None,
                  prompts: Optional[List[str]] = None,
                  path_to_image: Optional[str] = None) -> None:
        """prob: [C, H, W] probabilities (bg first), a tensor or numpy."""
        if (not need_resize or shape is None) and not isinstance(
                prob, np.ndarray):
            # device fast path: pull argmax ids, not the f32 prob tensor
            mask = argmax_ids(prob)
        else:
            if isinstance(prob, torch.Tensor):
                prob = prob.float().cpu().numpy()
            prob = np.asarray(prob, np.float32)
            if need_resize and shape is not None:
                prob = resize_prob_to(prob, tuple(int(s) for s in shape))
            mask = np.argmax(prob, axis=0)

        args = _SaveArgs(
            saver=self,
            mask=mask,
            frame_name=frame_name,
            save_the_mask=save_the_mask,
            image_np=image_np,
            prompts=prompts,
            path_to_image=path_to_image,
            tmp_id_to_obj=copy.deepcopy(self.object_manager.tmp_id_to_obj),
            obj_to_tmp_id=copy.deepcopy(self.object_manager.obj_to_tmp_id),
            segments_info=copy.deepcopy(
                self.object_manager.get_current_segments_info()),
        )
        self._raise_worker_error()
        self.queue.put(args)

    def end(self) -> None:
        self.queue.put(None)
        self.queue.join()
        self.thread.join()
        self._raise_worker_error()

    def _raise_worker_error(self) -> None:
        """Surface a save failure on the caller thread. The worker keeps
        draining after an error (it never dies mid-queue), so a failed
        write becomes an exception at the next save_mask()/end() instead
        of a silent wedge: a dead consumer would fill the bounded queue
        and deadlock the eval driver on queue.join()."""
        if self._errors:
            raise RuntimeError(
                f"async result writer failed: {self._errors[0]!r}"
            ) from self._errors[0]

    def flush_video_json(self, out_path: str) -> None:
        os.makedirs(path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(self.video_json, f)


@dataclass
class _SaveArgs:
    saver: ResultSaver
    mask: np.ndarray
    frame_name: str
    save_the_mask: bool
    image_np: Optional[np.ndarray]
    prompts: Optional[List[str]]
    path_to_image: Optional[str]
    tmp_id_to_obj: Dict
    obj_to_tmp_id: Dict
    segments_info: List[Dict] = field(default_factory=list)


def _worker(queue: Queue, errors: List[BaseException]) -> None:
    while True:
        args: Optional[_SaveArgs] = queue.get()
        if args is None:
            queue.task_done()
            break
        try:
            _save_one(args)
        except Exception as e:  # recorded, re-raised on the caller thread
            errors.append(e)
        finally:
            queue.task_done()


def _save_one(args: _SaveArgs) -> None:
    from PIL import Image
    saver = args.saver
    mask = args.mask
    segments_info = args.segments_info
    all_obj_ids = [k.id for k in args.obj_to_tmp_id]

    if saver.need_remapping:
        # tmp ids -> real object ids via a lookup table
        max_tmp = max(args.tmp_id_to_obj.keys(), default=0)
        lut = np.zeros(max_tmp + 1, dtype=np.int64)
        for tmp_id, obj in args.tmp_id_to_obj.items():
            lut[tmp_id] = obj.id
        mask = lut[np.clip(mask, 0, max_tmp)]

    if saver.json_style == "vipseg":
        for seg in segments_info:
            seg["area"] = int((mask == seg["id"]).sum())
        segments_info = [s for s in segments_info if s["area"] > 0]
        saver.all_annotations.append({
            "file_name": args.frame_name[:-4] + ".jpg",
            "segments_info": segments_info,
        })
    elif saver.json_style == "burst":
        for seg in segments_info:
            m = (mask == seg["id"])
            seg["area"] = int(m.sum())
            seg["rle_mask"] = rle_codec.encode(m)
        segments_info = [s for s in segments_info if s["area"] > 0]
        saver.all_annotations.append({
            "file_name": args.frame_name[:-4] + ".jpg",
            "segmentations": [{
                "id": s["id"],
                "score": s["score"],
                "rle": s["rle_mask"],
            } for s in segments_info],
        })
    elif saver.visualize:
        for seg in segments_info:
            seg["area"] = int((mask == seg["id"]).sum())
        segments_info = [s for s in segments_info if s["area"] > 0]

    if not args.save_the_mask:
        return

    rgb_mask = None
    if saver.object_manager.use_long_id:
        out_mask = mask.astype(np.uint32)
        rgb_mask = np.zeros((*out_mask.shape, 3), dtype=np.uint8)
        for oid in all_obj_ids:
            rgb_mask[out_mask == oid] = id_to_rgb(oid)
        out_img = Image.fromarray(rgb_mask)
    else:
        out_img = Image.fromarray(mask.astype(np.uint8))
        if saver.palette is not None:
            out_img.putpalette(saver.palette)

    if saver.dataset != "gradio":
        out_dir = saver.output_root
        if saver.output_postfix is not None:
            out_dir = path.join(out_dir, saver.output_postfix)
        if saver.video_name is not None:
            out_dir = path.join(out_dir, saver.video_name)
        os.makedirs(out_dir, exist_ok=True)
        out_img.save(path.join(out_dir, args.frame_name[:-4] + ".png"))

    if saver.visualize and saver.object_manager.use_long_id:
        image_np = args.image_np
        if image_np is None:
            if args.path_to_image is None:
                raise ValueError("Cannot visualize without an image")
            image_np = np.array(Image.open(args.path_to_image))
        blend = overlay_segmentation(image_np, mask, rgb_mask, segments_info,
                                     prompts=args.prompts)
        if saver.dataset != "gradio":
            out_dir = saver.output_root
            if saver.visualize_postfix is not None:
                out_dir = path.join(out_dir, saver.visualize_postfix)
            if saver.video_name is not None:
                out_dir = path.join(out_dir, saver.video_name)
            os.makedirs(out_dir, exist_ok=True)
            Image.fromarray(blend).save(
                path.join(out_dir, args.frame_name[:-4] + ".jpg"))
        elif saver.writer is not None:
            saver.writer.write(blend[:, :, ::-1])
