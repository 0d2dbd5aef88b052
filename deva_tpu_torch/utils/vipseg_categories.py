"""VIPSeg 124-category table (dataset metadata: id, name, isthing).

A copy of deva_tpu/utils/vipseg_categories.py
(host-only code: the port imports nothing of deva_tpu, whose package
import loads jax).

Stored as JSON data (vipseg_categories.json) instead of inline code; the
mapping matches reference:deva/utils/vipseg_categories.py.
"""
import json
import os

with open(os.path.join(os.path.dirname(__file__),
                       "vipseg_categories.json")) as _f:
    VIPSEG_CATEGORIES = json.load(_f)

vipseg_cat_to_isthing = {d["id"]: d["isthing"] == 1 for d in VIPSEG_CATEGORIES}
