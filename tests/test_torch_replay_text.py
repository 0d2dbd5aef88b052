"""The replayed detections of example/vipseg
(tests/fixtures/replay_dets_vipseg.npz, the recorded Grounding DINO + SAM
outputs for its 4 frames) through the port's text processor
(ext/with_text_processor.py), against deva_tpu's run of the same fixture:
semi-online at size 240 with identity alignment in both packages
(tests/test_replay_detector.py's set-up: random weights align noise), the
two cores on the same seeded weights and object-id generators.

Budget: equal object tables after every frame and equal JSON segments;
each frame's probabilities (logits on the voted frame) within 3e-3, and
its argmax equal, except where the forward predictions paint another id
or deva_tpu's top two lie within 2 x 3e-3 (tests/test_torch_ext_processors
.py's budget), on at most 1% of the frame.
"""
import os

import numpy as np
import torch

from deva_tpu.config import InferenceConfig as JaxInferenceConfig
from deva_tpu.ext import detectors as jax_det
from deva_tpu.ext.with_text_processor import \
    process_frame_with_text as jax_with_text
from deva_tpu.inference.core import InferenceCore as JaxInferenceCore
from deva_tpu.inference.demo_utils import flush_buffer as jax_flush
from deva_tpu.inference.result_saver import ResultSaver as JaxResultSaver

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.detection_clips import (RecordingSaver, paint_flips,
                                           run_processor)
from deva_tpu_torch.ext import detectors as det
from deva_tpu_torch.ext.with_text_processor import process_frame_with_text
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.inference.demo_utils import flush_buffer
from deva_tpu_torch.inference.result_saver import ResultSaver

from test_torch_ext_processors import ATOL
from torch_detection_common import models  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "replay_dets_vipseg.npz")
CLIP = os.path.join(ROOT, "example", "vipseg", "images", "12_1mWNahzcsAc")

torch.set_num_threads(2)


def _run_replay(core, package, tmp_path):
    from PIL import Image
    out = str(tmp_path / package)
    saver_cls = ResultSaver if package == "port" else JaxResultSaver
    saver = RecordingSaver(saver_cls(out, None, dataset="demo",
                                     object_manager=core.object_manager))
    process = process_frame_with_text if package == "port" else \
        jax_with_text
    source = (det if package == "port" else jax_det).ReplayDetector(FIXTURE)
    ext_cfg = {"prompt": "person.bench.tree", "temporal_setting":
               "semionline", "detection_every": 5, "DINO_THRESHOLD": 0.35,
               "DINO_NMS_THRESHOLD": 0.8}
    frames = [np.asarray(Image.open(os.path.join(CLIP, name)).convert("RGB"))
              for name in sorted(os.listdir(CLIP))]
    forwards = {}
    tables = run_processor(
        core, process, flush_buffer if package == "port" else jax_flush,
        source, ext_cfg, frames, saver, forwards, prompts=["person"])
    saver.saver.end()
    anns = saver.saver.video_json["annotations"]
    return ([saver.probs[f"{ti:05d}.jpg"] for ti in range(len(frames))],
            forwards, tables,
            [sorted(s["id"] for s in a["segments_info"]) for a in anns])


def test_replayed_detections_through_text_processor(tmp_path, models):
    net, jmodel, variables = models
    cfg = dict(mem_every=2, top_k=8, enable_long_term=False,
               enable_long_term_count_usage=False, detection_every=5,
               num_voting_frames=3, max_missed_detection_count=5, size=240)
    ours = InferenceCore(net, InferenceConfig(**cfg))
    ref = JaxInferenceCore(jmodel, variables, JaxInferenceConfig(**cfg))
    for core in (ours, ref):
        core.object_manager._rng = np.random.default_rng(5)
    r_probs, r_fwd, r_tables, r_segs = _run_replay(ref, "jax", tmp_path)
    probs, fwd, tables, segs = _run_replay(ours, "port", tmp_path)
    assert tables == r_tables and segs == r_segs
    assert len(segs[0]) >= 4  # the consensus admits the replayed objects
    for ti, (p, r) in enumerate(zip(probs, r_probs)):
        assert p.shape == r.shape and p.shape[1:] == (240, 426)
        top2 = np.sort(r, axis=0)[-2:]
        allowed = (top2[1] - top2[0]) <= 2 * ATOL
        flips = paint_flips(fwd.get(ti), r_fwd.get(ti))
        if flips is not None:
            allowed |= flips
        assert not (((np.abs(p - r) > ATOL).any(0)) & ~allowed).any(), ti
        differ = p.argmax(0) != r.argmax(0)
        assert not (differ & ~allowed).any(), ti
        assert differ.mean() <= 0.01, (ti, differ.mean())
