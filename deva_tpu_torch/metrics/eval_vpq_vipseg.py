"""Video Panoptic Quality (VPQ) for VIPSeg: tube matching over sliding windows
of k frames, parallelized over videos.

A copy of deva_tpu/metrics/eval_vpq_vipseg.py (host-only code: the port
imports nothing of deva_tpu, whose package import loads jax), with PIL
imported inside the function that reads the PNGs, and its pool started
with the spawn method (a driver's process holds CUDA state and threads).

Semantics anchor: reference:deva/vps_metrics/eval_vpq_vipseg.py:33-405 (itself
the official VIPSeg evaluation): for every window, concatenate k frames into
tubes, match gt/pred tubes of the same category at tube-IoU > 0.5 (VOID- and
crowd-corrected), and aggregate PQ = IoU_sum / (TP + FP/2 + FN/2) per
category. Windows k in {1, 2, 4, 6, 8, 10, 999}.
"""
from __future__ import annotations

import copy
import json
import os
import time
from collections import defaultdict
from functools import partial
from multiprocessing import get_context
from typing import Dict, List, Optional

import numpy as np

from deva_tpu_torch.utils.pano_utils import rgb_to_id

_OFFSET = 256 ** 3
_VOID = 0


class PQStat:
    """Per-category running (iou_sum, tp, fp, fn)."""

    def __init__(self):
        self.stats: Dict[int, np.ndarray] = defaultdict(
            lambda: np.zeros(4))  # [iou, tp, fp, fn]

    def add(self, cat: int, iou=0.0, tp=0, fp=0, fn=0):
        self.stats[cat] += np.array([iou, tp, fp, fn], np.float64)

    def merge(self, other: "PQStat"):
        for cat, s in other.stats.items():
            self.stats[cat] += s
        return self

    def average(self, categories: Dict[int, Dict], isthing: Optional[bool]):
        pq = sq = rq = n = 0
        per_class = {}
        for label, info in categories.items():
            if isthing is not None and (info["isthing"] == 1) != isthing:
                continue
            iou, tp, fp, fn = self.stats[label]
            if tp + fp + fn == 0:
                per_class[label] = {"pq": 0.0, "sq": 0.0, "rq": 0.0,
                                    "iou": 0.0, "tp": 0, "fp": 0, "fn": 0}
                continue
            n += 1
            pq_c = iou / (tp + 0.5 * fp + 0.5 * fn)
            sq_c = iou / tp if tp else 0.0
            rq_c = tp / (tp + 0.5 * fp + 0.5 * fn)
            per_class[label] = {"pq": pq_c, "sq": sq_c, "rq": rq_c,
                                "iou": iou, "tp": int(tp), "fp": int(fp),
                                "fn": int(fn)}
            pq += pq_c
            sq += sq_c
            rq += rq_c
        n = max(n, 1)
        return ({"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n},
                per_class)


def _read_pan(path: str) -> np.ndarray:
    from PIL import Image
    return rgb_to_id(np.array(Image.open(path)).astype(np.uint32))


def _collect_segms(json_ann: Dict) -> Dict[int, Dict]:
    segms = {}
    for el in json_ann["segments_info"]:
        if el["id"] in segms:
            segms[el["id"]]["area"] = segms[el["id"]].get("area", 0) + \
                el.get("area", 0)
        else:
            segms[el["id"]] = copy.deepcopy(el)
    return segms


def vpq_video(categories: Dict[int, Dict], nframes: int,
              gt_pred_set: List) -> PQStat:
    """Tube matching over one video's sliding windows.
    gt_pred_set: per-frame (gt_json, pred_json, gt_png, pred_png)."""
    stat = PQStat()
    pans = {}
    for gt_json, pred_json, gt_name, pred_name in gt_pred_set:
        pans[gt_name] = _read_pan(gt_name).astype(np.uint64)
        pans[pred_name] = _read_pan(pred_name).astype(np.uint64)

    for idx in range(max(len(gt_pred_set) - nframes + 1, 1)):
        window = gt_pred_set[idx:idx + nframes]
        gt_tube, pred_tube = [], []
        vid_gt_segms: Dict[int, Dict] = {}
        vid_pred_segms: Dict[int, Dict] = {}
        for gt_json, pred_json, gt_name, pred_name in window:
            pan_gt = pans[gt_name]
            pan_pred = pans[pred_name]
            gt_segms = _collect_segms(gt_json)
            pred_segms = _collect_segms(pred_json)

            # prediction sanity checks + true per-frame pred areas
            png_labels, cnts = np.unique(pan_pred, return_counts=True)
            remaining = set(pred_segms)
            for label, cnt in zip(png_labels.tolist(), cnts.tolist()):
                if label == _VOID:
                    continue
                if label not in pred_segms:
                    raise KeyError(
                        f"Segment {label} in PNG but not in JSON")
                if pred_segms[label]["category_id"] not in categories:
                    raise KeyError(
                        f"Segment {label} has unknown category "
                        f"{pred_segms[label]['category_id']}")
                pred_segms[label]["area"] = cnt
                remaining.discard(label)
            if remaining:
                raise KeyError(
                    f"Segments {sorted(remaining)} in JSON but not in PNG")

            gt_tube.append(pan_gt)
            pred_tube.append(pan_pred)
            for k, v in gt_segms.items():
                if k in vid_gt_segms:
                    vid_gt_segms[k]["area"] += v["area"]
                else:
                    vid_gt_segms[k] = v
            for k, v in pred_segms.items():
                if k in vid_pred_segms:
                    vid_pred_segms[k]["area"] += v["area"]
                else:
                    vid_pred_segms[k] = v

        joint = np.stack(gt_tube).ravel() * _OFFSET + \
            np.stack(pred_tube).ravel()
        labels, cnts = np.unique(joint, return_counts=True)
        inter = {(int(l // _OFFSET), int(l % _OFFSET)): int(c)
                 for l, c in zip(labels, cnts)}

        gt_matched, pred_matched = set(), set()
        for (gt_label, pred_label), intersection in inter.items():
            if gt_label not in vid_gt_segms or \
                    pred_label not in vid_pred_segms:
                continue
            if vid_gt_segms[gt_label].get("iscrowd", 0) == 1:
                continue
            if vid_gt_segms[gt_label]["category_id"] != \
                    vid_pred_segms[pred_label]["category_id"]:
                continue
            union = (vid_pred_segms[pred_label]["area"] +
                     vid_gt_segms[gt_label]["area"] - intersection -
                     inter.get((_VOID, pred_label), 0))
            iou = intersection / union
            assert iou <= 1.0, f"INVALID IOU VALUE: {gt_label}"
            if iou > 0.5:
                cat = vid_gt_segms[gt_label]["category_id"]
                stat.add(cat, iou=iou, tp=1)
                gt_matched.add(gt_label)
                pred_matched.add(pred_label)

        crowd_by_cat = {}
        for gt_label, info in vid_gt_segms.items():
            if gt_label in gt_matched:
                continue
            if info.get("iscrowd", 0) == 1:
                crowd_by_cat[info["category_id"]] = gt_label
                continue
            stat.add(info["category_id"], fn=1)

        for pred_label, info in vid_pred_segms.items():
            if pred_label in pred_matched:
                continue
            void_inter = inter.get((_VOID, pred_label), 0)
            if info["category_id"] in crowd_by_cat:
                void_inter += inter.get(
                    (crowd_by_cat[info["category_id"]], pred_label), 0)
            if void_inter / info["area"] > 0.5:
                continue  # mostly VOID/crowd: ignored
            stat.add(info["category_id"], fp=1)
    return stat


def vpq_compute(gt_pred_split, categories, nframes, output_dir,
                num_processes=8):
    start = time.time()
    total = PQStat()
    if num_processes and num_processes > 1:
        with get_context("spawn").Pool(num_processes) as p:
            for s in p.imap(partial(vpq_video, categories, nframes),
                            gt_pred_split):
                total.merge(s)
    else:
        for item in gt_pred_split:
            total.merge(vpq_video(categories, nframes, item))

    print(f"==> {nframes}-frame vpq_stat: {time.time() - start:.1f} sec")
    metrics = [("All", None), ("Things", True), ("Stuff", False)]
    results = {}
    for name, isthing in metrics:
        results[name], per_class = total.average(categories, isthing)
        if name == "All":
            results["per_class"] = per_class

    if output_dir is not None:
        with open(os.path.join(output_dir, f"vpq-{nframes}.txt"), "w") as f:
            f.write("=" * 48 + "\n")
            f.write("{:10s}| {:>5s}  {:>5s}  {:>5s} {:>5s}\n".format(
                "", "PQ", "SQ", "RQ", "N"))
            f.write("-" * 38 + "\n")
            for name, _ in metrics:
                r = results[name]
                f.write("{:10s}| {:5.1f}  {:5.1f}  {:5.1f} {:5d}\n".format(
                    name, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"],
                    r["n"]))
            for idx, r in results["per_class"].items():
                f.write("{:4d} | {:5.1f} {:5.1f} {:5.1f} {:6.1f} "
                        "{:7d} {:7d} {:7d}\n".format(
                            idx, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"],
                            r["iou"], r["tp"], r["fp"], r["fn"]))

    return (100 * results["All"]["pq"], 100 * results["Things"]["pq"],
            100 * results["Stuff"]["pq"])


def eval_vpq(submit_dir: str, truth_dir: str, pan_gt_json_file: str,
             num_processes: int = 8,
             windows=(1, 2, 4, 6, 8, 10, 999)) -> List:
    with open(os.path.join(submit_dir, "pred.json")) as f:
        pred_jsons = json.load(f)
    with open(pan_gt_json_file) as f:
        gt_jsons = json.load(f)

    categories = {el["id"]: el for el in gt_jsons["categories"]}
    pred_j = {a["video_id"]: a["annotations"]
              for a in pred_jsons["annotations"]}
    gt_j = {a["video_id"]: a["annotations"] for a in gt_jsons["annotations"]}

    gt_pred_split = []
    for video in gt_jsons["videos"]:
        vid = video["video_id"]
        gt_ann, pred_ann = gt_j[vid], pred_j[vid]
        assert len(gt_ann) == len(pred_ann)
        items = []
        for g, p, img in zip(gt_ann, pred_ann, video["images"]):
            name = img["file_name"]
            items.append((g, p,
                          os.path.join(truth_dir, vid, name),
                          os.path.join(submit_dir, "pan_pred", vid, name)))
        gt_pred_split.append(items)

    all_results = []
    for nframes in windows:
        res = vpq_compute(gt_pred_split, categories, nframes, submit_dir,
                          num_processes)
        print(res)
        all_results.append(res)

    with open(os.path.join(submit_dir, "vpq-simple.txt"), "w") as f:
        for a, t, s in all_results:
            f.write(f"{a:.1f}/{t:.1f}/{s:.1f},")
    return all_results
