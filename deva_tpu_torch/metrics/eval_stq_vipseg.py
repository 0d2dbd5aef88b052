"""STQ driver for VIPSeg: maps gt/pred jsons + RGB panoptic PNGs into
bit-packed (semantic << 16) + instance maps and accumulates STQuality.

A copy of deva_tpu/metrics/eval_stq_vipseg.py (host-only code: the port
imports nothing of deva_tpu, whose package import loads jax), with PIL
imported inside eval_stq.

Behavioral anchor: reference:deva/vps_metrics/eval_stq_vipseg.py:50-169.
"""
from __future__ import annotations

import json
import os

import numpy as np

from deva_tpu_torch.metrics.stq import STQuality
from deva_tpu_torch.utils.pano_utils import rgb_to_id

N_CLASSES = 124
IGNORE_LABEL = 255
BIT_SHIFT = 16


def eval_stq(submit_dir: str, truth_dir: str, pan_gt_json_file: str) -> dict:
    from PIL import Image
    with open(os.path.join(submit_dir, "pred.json")) as f:
        pred_jsons = json.load(f)
    with open(pan_gt_json_file) as f:
        gt_jsons = json.load(f)

    thing_list = [c["id"] for c in gt_jsons["categories"] if c["isthing"]]
    stq = STQuality(N_CLASSES, thing_list, IGNORE_LABEL, BIT_SHIFT, 2 ** 24)

    pred_j = {a["video_id"]: a["annotations"]
              for a in pred_jsons["annotations"]}
    gt_j = {a["video_id"]: a["annotations"] for a in gt_jsons["annotations"]}

    for seq_id, video in enumerate(gt_jsons["videos"]):
        vid = video["video_id"]
        gt_ann, pred_ann = gt_j[vid], pred_j[vid]
        assert len(gt_ann) == len(pred_ann)

        def id_table(anns):
            table = {}
            for segm in anns:
                for info in segm["segments_info"]:
                    if info["id"] not in table:
                        table[info["id"]] = len(table)
            return table

        gt_ins, pred_ins = id_table(gt_ann), id_table(pred_ann)

        for g, p, img in zip(gt_ann, pred_ann, video["images"]):
            name = img["file_name"]
            pan_gt = rgb_to_id(np.uint32(np.array(
                Image.open(os.path.join(truth_dir, vid, name)))))
            pan_pred = rgb_to_id(np.uint32(np.array(
                Image.open(os.path.join(submit_dir, "pan_pred", vid,
                                        name)))))

            def pack(pan, anns, ins_table):
                sem = np.full_like(pan, 255)
                ins = np.full_like(pan, 255)
                for el in anns["segments_info"]:
                    m = pan == el["id"]
                    sem[m] = el["category_id"]
                    ins[m] = ins_table[el["id"]]
                return ((sem << BIT_SHIFT) + ins).astype(np.int32)

            stq.update_state(pack(pan_gt, g, gt_ins),
                             pack(pan_pred, p, pred_ins), seq_id)

    result = stq.result()
    print("*" * 100)
    print(f"STQ : {result['STQ']}")
    print(f"AQ :{result['AQ']}")
    print(f"IoU:{result['IoU']}")
    print("STQ_per_seq", result["STQ_per_seq"])
    print("AQ_per_seq", result["AQ_per_seq"])
    print("ID_per_seq", result["ID_per_seq"])
    print("Length_per_seq", result["Length_per_seq"])
    print("*" * 100)
    with open(os.path.join(submit_dir, "stq.txt"), "w") as f:
        f.write(f"{result['STQ']*100:.1f},{result['AQ']*100:.1f},"
                f"{result['IoU']*100:.1f}\n")
    return result
