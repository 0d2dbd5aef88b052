"""JSON detections -> ObjectInfo list.

A copy of deva_tpu/inference/object_utils.py
(host-only code: the port imports nothing of deva_tpu, whose package
import loads jax).

Behavioral anchor: reference:deva/inference/object_utils.py (category/isthing
from the VIPSeg table; scores only for burst/demo; fall back to mask labels).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from deva_tpu_torch.inference.object_info import ObjectInfo
from deva_tpu_torch.utils.vipseg_categories import vipseg_cat_to_isthing


def convert_json_dict_to_objects_info(mask: Optional[np.ndarray],
                                      segments_info: Optional[List],
                                      dataset: str = None
                                      ) -> List[ObjectInfo]:
    if segments_info is not None:
        return [
            ObjectInfo(
                id=segment["id"],
                category_id=segment.get("category_id"),
                isthing=vipseg_cat_to_isthing[segment.get("category_id")]
                if dataset == "vipseg" else None,
                score=float(segment["score"])
                if (dataset in ("burst", "demo") and "score" in segment)
                else None)
            for segment in segments_info
        ]
    labels = np.unique(np.asarray(mask))
    return [ObjectInfo(int(l)) for l in labels if l != 0]
