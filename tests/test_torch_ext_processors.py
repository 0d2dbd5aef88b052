"""deva_tpu_torch's detector fusion (ext/detectors.py) and its text and
automatic frame processors (ext/with_text_processor.py,
ext/automatic_processor.py) against deva_tpu's, on the same inputs.

Fusion: box_nms and _mask_nms (ties included: both keep numpy's argsort),
segment_with_text and auto_segment (both branches, with and without a
forward mask, with and without a resize), and ROADMAP C-4: auto_segment's
default branch paints mask k as id k + 1 but numbers the ObjectInfos of the
masks that won a pixel, so a mask that wins none shifts the ids; the port
keeps deva_tpu's ids.

Processors (the automatic one in tests/test_torch_ext_automatic.py, which
runs this file's check_processor): the synthetic detectors of tests/test_ext_processors.py, the
two packages' cores on the same seeded weights with equal seeded object-id
generators (tests/torch_detection_common.py), the same 64x96 frames and
tests/test_ext_processors.py's configuration, each writing through its
package's ResultSaver (dataset "demo": RGB id PNGs and the JSON). As in
tests/test_ext_processors.py, the semi-online vote aligns by identity in
both packages (random weights align noise, and the vote would select
nothing).

Budgets: every saved id map equal to deva_tpu's on at least 99% of its
pixels; a pixel may differ only where the two runs' forward predictions
have another argmax (detection frames: match_and_merge paints from them,
detection_clips.paint_flips) or where deva_tpu's top two saved
probabilities lie within 2 x 3e-3 (propagated frames: with random weights
a detection that matches no object makes a near-copy of it, and the two
tie); the probabilities within 3e-3 elsewhere
(compare_prob's budget of tests/torch_detection_common.py). Strict case:
both cores merge each detection against a perfect forward prediction, and
then every frame is within 3e-3 and no pixel may differ but where two of
deva_tpu's channels lie within 2 x 3e-3. Resized masks: hard masks equal except where deva_tpu's resized
value lies within 1e-5 of the 0.5 threshold (the resize's budget,
tests/test_torch_mobile_sam.py). The automatic processor makes as many
image encodes (the feature store's) as deva_tpu's on every frame.
"""
import os

import numpy as np
import pytest

from deva_tpu.ext import detectors as jax_det
from deva_tpu.ext.automatic_processor import \
    process_frame_automatic as jax_automatic
from deva_tpu.ext.with_text_processor import \
    process_frame_with_text as jax_with_text
from deva_tpu.inference.demo_utils import flush_buffer as jax_flush
from deva_tpu.inference.result_saver import ResultSaver as JaxResultSaver

from deva_tpu_torch.detection_clips import (RecordingSaver, paint_flips,
                                           run_processor)
from deva_tpu_torch.ext import detectors as det
from deva_tpu_torch.ext.automatic_processor import process_frame_automatic
from deva_tpu_torch.ext.with_text_processor import process_frame_with_text
from deva_tpu_torch.inference.demo_utils import flush_buffer
from deva_tpu_torch.inference.result_saver import ResultSaver
from deva_tpu_torch.utils.pano_utils import rgb_to_id

from test_ext_processors import (H, W, SyntheticGenerator,
                                 SyntheticTextDetector, _frames)
from torch_detection_common import cores, models  # noqa: F401

ATOL = 3e-3
RESIZE_TOL = 1e-5
CFG = dict(mem_every=2, top_k=8, enable_long_term=False,
           enable_long_term_count_usage=False, detection_every=3,
           num_voting_frames=2, max_missed_detection_count=3, size=-1)


def _infos(infos):
    return [(o.id, o.category_ids, o.scores) for o in infos]


# --------------------------------------------------------------------------
# the fusion functions
# --------------------------------------------------------------------------

def test_box_nms_matches():
    rng = np.random.default_rng(0)
    for n in (1, 5, 40):
        xy = rng.uniform(0, 80, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))], 1)
        scores = rng.choice([0.9, 0.5, 0.3], n).astype(np.float32)  # ties
        for thr in (0.3, 0.8):
            assert det.box_nms(boxes, scores, thr) == \
                jax_det.box_nms(boxes, scores, thr)


def test_mask_nms_matches():
    rng = np.random.default_rng(1)
    base = rng.random((24, 32, 40)) > 0.5
    masks = np.concatenate([base, base[:8] | (rng.random((8, 32, 40))
                                              > 0.9)])
    scores = rng.choice([0.9, 0.7, 0.2], len(masks)).astype(np.float32)
    for thr in (0.5, 0.7, 0.95):
        assert det._mask_nms(masks, scores, thr) == \
            jax_det._mask_nms(masks, scores, thr)


class OverlappingDetector(SyntheticTextDetector):
    """Five boxes, two near-duplicates that NMS drops, masks of different
    areas (painted small on top)."""

    def detect(self, image_np, prompts, box_threshold, text_threshold):
        boxes = np.array([[10, 8, 40, 28], [11, 8, 40, 29], [50, 36, 90, 60],
                          [0, 0, 95, 63], [30, 20, 70, 50]], np.float32)
        scores = np.array([0.9, 0.85, 0.8, 0.6, 0.7], np.float32)
        return boxes, scores, np.array([0, 0, 1, 1, 0], np.int64)


def _near_half(masks, shape):
    """Pixels where any of deva_tpu's resized masks lies within RESIZE_TOL
    of the 0.5 threshold."""
    near = np.zeros(shape, bool)
    for m in masks:
        near |= np.abs(jax_det._resize_bilinear(m.astype(np.float32), shape)
                       - 0.5) < RESIZE_TOL
    return near


@pytest.mark.parametrize("min_side", [-1, 48, 100])
@pytest.mark.parametrize("detector", [SyntheticTextDetector(),
                                      OverlappingDetector()],
                         ids=["two", "overlapping"])
def test_segment_with_text_matches(detector, min_side):
    cfg = {"DINO_THRESHOLD": 0.35, "DINO_NMS_THRESHOLD": 0.8}
    img = np.zeros((H, W, 3), np.uint8)
    mask, infos = det.segment_with_text(cfg, detector, img, ["a", "b"],
                                        min_side)
    want, want_infos = jax_det.segment_with_text(cfg, detector, img,
                                                 ["a", "b"], min_side)
    assert mask.shape == want.shape and mask.dtype == want.dtype
    assert _infos(infos) == _infos(want_infos)
    boxes, scores, _ = detector.detect(img, None, 0, 0)
    keep = jax_det.box_nms(boxes, scores, 0.8)
    near = _near_half(detector.masks_for_boxes(img, boxes[keep]),
                      mask.shape) if min_side > 0 else \
        np.zeros(mask.shape, bool)
    assert not ((mask != want) & ~near).any()
    if min_side < 0:
        assert np.array_equal(mask, want)


class SoftGenerator:
    """Soft masks (a ramp inside each region), so that resizes and the
    scored argmax get non-trivial values."""

    def generate(self, image_np, positive_points=None):
        h, w = image_np.shape[:2]
        yy, xx = np.mgrid[:h, :w] / max(h, w)
        out = []
        for y0, y1, x0, x1 in ((8, 28, 10, 40), (36, 60, 50, 90),
                               (0, 64, 0, 96), (20, 50, 30, 70)):
            m = np.zeros((h, w), np.float32)
            m[y0:y1, x0:x1] = 0.6 + 0.4 * (yy + xx)[y0:y1, x0:x1] / 2
            out.append(m)
        return {"masks": np.stack(out),
                "iou_preds": np.array([0.95, 0.9, 0.8, 0.85], np.float32)}


@pytest.mark.parametrize("suppress", [False, True])
@pytest.mark.parametrize("min_side", [-1, 48])
@pytest.mark.parametrize("generator", [SyntheticGenerator(),
                                       SoftGenerator()],
                         ids=["boxes", "soft"])
def test_auto_segment_matches(generator, min_side, suppress):
    cfg = {"SAM_NUM_POINTS_PER_SIDE": 8, "SAM_OVERLAP_THRESHOLD": 0.8}
    img = np.zeros((H, W, 3), np.uint8)
    forward = np.zeros((H, W), np.int64)
    forward[:, :40] = 1  # the left part is claimed: fewer points
    for fwd in (None, forward, np.ones((H, W), np.int64)):
        mask, infos = det.auto_segment(cfg, generator, img, fwd, min_side,
                                       suppress)
        want, want_infos = jax_det.auto_segment(cfg, generator, img, fwd,
                                                min_side, suppress)
        assert _infos(infos) == _infos(want_infos)
        near = _near_half(generator.generate(img)["masks"], mask.shape) \
            if min_side > 0 else np.zeros(mask.shape, bool)
        assert not ((mask != want) & ~near).any()


def test_auto_segment_ids_c4():
    """ROADMAP C-4, as deva_tpu does it: mask 0 (the largest) is covered
    by masks 1 and 2 and, smaller objects preferred, wins no pixel. The
    default branch still paints mask k as k + 1 (ids 2 and 3 on the frame)
    but numbers the ObjectInfos of the winners 1 and 2, so id 3 has no
    ObjectInfo and id 2's carries mask 2's score. The suppress branch
    (larger masks preferred: mask 0 takes all) numbers what it paints."""
    class Covered:
        def generate(self, image_np, positive_points=None):
            m = np.zeros((3, H, W), np.float32)
            m[0, 10:50, 10:80] = 1
            m[1, 10:50, 10:45] = 1
            m[2, 10:50, 45:80] = 1
            return {"masks": m,
                    "iou_preds": np.array([0.9, 0.8, 0.7], np.float32)}

    cfg = {"SAM_NUM_POINTS_PER_SIDE": 8, "SAM_OVERLAP_THRESHOLD": 0.8}
    img = np.zeros((H, W, 3), np.uint8)
    for package in (det, jax_det):
        mask, infos = package.auto_segment(cfg, Covered(), img, None, -1,
                                           False)
        assert sorted(np.unique(mask).tolist()) == [0, 2, 3]
        assert [(o.id, o.scores) for o in infos] == [(1, [np.float32(0.8)]),
                                                     (2, [np.float32(0.7)])]
        mask, infos = package.auto_segment(cfg, Covered(), img, None, -1,
                                           True)
        assert sorted(np.unique(mask).tolist()) == [0, 1]
        assert [(o.id, o.scores) for o in infos] == [(1, [np.float32(0.9)])]


# --------------------------------------------------------------------------
# the frame processors
# --------------------------------------------------------------------------

def _count_encodes(core, encodes):
    """Count the feature store's encodes into encodes[-1]."""
    store = core.image_feature_store
    encode = store._encode

    def counted(image):
        encodes[-1] += 1
        return encode(image)

    store._encode = counted


def _run(core, package, tmp_path, mode, setting, frames, perfect=False):
    """One package's processor over the frames -> (probabilities per frame,
    forward predictions per detection frame, encodes per frame, saved id
    maps per frame, the JSON's segment ids per frame)."""
    out = str(tmp_path / package)
    saver_cls = ResultSaver if package == "port" else JaxResultSaver
    saver = RecordingSaver(saver_cls(out, None, dataset="demo",
                               object_manager=core.object_manager))
    forwards, encodes = {}, []
    _count_encodes(core, encodes)
    process = {("port", "text"): process_frame_with_text,
               ("jax", "text"): jax_with_text,
               ("port", "auto"): process_frame_automatic,
               ("jax", "auto"): jax_automatic}[package, mode]
    if mode == "text":
        source, ext_cfg = SyntheticTextDetector(), {
            "prompt": "cat.dog", "DINO_THRESHOLD": 0.35,
            "DINO_NMS_THRESHOLD": 0.8}
    else:
        source, ext_cfg = SyntheticGenerator(), {
            "suppress_small_objects": False, "SAM_NUM_POINTS_PER_SIDE": 8,
            "SAM_OVERLAP_THRESHOLD": 0.8}
    ext_cfg.update(temporal_setting=setting, detection_every=3)
    tables = run_processor(
        core, process, flush_buffer if package == "port" else jax_flush,
        source, ext_cfg, frames, saver, forwards, perfect,
        before=lambda ti: encodes.append(0),
        prompts=["cat", "dog"] if mode == "text" else None)
    saver.saver.end()
    from PIL import Image
    names = sorted(os.listdir(os.path.join(out, "Annotations")))
    assert names == [f"{ti:05d}.png" for ti in range(len(frames))]
    ids = [rgb_to_id(np.asarray(Image.open(os.path.join(
        out, "Annotations", n)))) for n in names]
    segs = [sorted(s["id"] for s in a["segments_info"])
            for a in saver.saver.video_json["annotations"]]
    probs = [saver.probs[f"{ti:05d}.jpg"] for ti in range(len(frames))]
    return probs, forwards, encodes, ids, segs, tables


def _compare(ours, ref, strict):
    probs, forwards, encodes, ids, segs, tables = ours
    r_probs, r_forwards, r_encodes, r_ids, r_segs, r_tables = ref
    assert tables == r_tables
    assert segs == r_segs
    assert encodes == r_encodes
    assert sorted(forwards) == sorted(r_forwards)
    worst = 1.0
    for ti, (p, r, m, rm) in enumerate(zip(probs, r_probs, ids, r_ids)):
        assert p.shape == r.shape and m.shape == rm.shape == (H, W)
        top2 = np.sort(r, axis=0)[-2:]
        # two channels each within ATOL of deva_tpu's swap their order
        # only where deva_tpu's are within 2 ATOL of each other
        tie = (top2[1] - top2[0]) <= 2 * ATOL
        allowed = tie.copy()
        if ti in r_forwards and not strict:
            flips = paint_flips(forwards[ti], r_forwards[ti])
            if flips is not None:
                allowed |= flips
        if ti in r_forwards and r_forwards[ti] is not None and not strict:
            beyond = (np.abs(p - r) > ATOL).any(0)
            assert not (beyond & ~allowed).any(), f"frame {ti}"
        else:
            np.testing.assert_allclose(p, r, rtol=0, atol=ATOL,
                                       err_msg=f"frame {ti}")
        differ = m != rm
        assert not (differ & ~allowed).any(), f"frame {ti}"
        worst = min(worst, 1 - differ.mean())
    assert worst >= 0.99, worst
    return worst


def check_processor(tmp_path, models, mode, setting):
    frames = _frames(np.random.default_rng(1), 7)
    ours, ref = cores(models, CFG)
    r = _run(ref, "jax", tmp_path, mode, setting, frames)
    o = _run(ours, "port", tmp_path, mode, setting, frames)
    _compare(o, r, strict=False)
    assert ours.object_manager.num_obj >= 1


def check_processor_perfect_forward(tmp_path, models, mode):
    """Both cores merge each detection against a perfect forward
    prediction: match_and_merge then depends on no device output, every
    detection matches its object (no near-copy objects to tie), and no
    pixel may differ but where two channels of deva_tpu's tie within
    2 x 3e-3."""
    frames = _frames(np.random.default_rng(2), 7)
    ours, ref = cores(models, CFG)
    r = _run(ref, "jax", tmp_path, mode, "online", frames, perfect=True)
    o = _run(ours, "port", tmp_path, mode, "online", frames, perfect=True)
    assert ours.object_manager.num_obj == 2
    _compare(o, r, strict=True)


@pytest.mark.parametrize("setting", ["semionline", "online"])
def test_text_processor_matches_deva_tpu(tmp_path, models, setting):
    check_processor(tmp_path, models, "text", setting)


def test_text_processor_strict_perfect_forward(tmp_path, models):
    check_processor_perfect_forward(tmp_path, models, "text")
