"""The automatic demos with MobileSAM as the mask source and a second
detection frame: demo/demo_automatic_torch.py (--device cpu) and deva_tpu's
demo/demo_automatic.py, both mains in process on example/vipseg (4 frames
at 1280x720, --size 120), tests/test_torch_demo_sam.py's flags and weights
(one seeded port MobileSAM saved as a .pt, the same propagation .npz, a 4x4
grid, the IoU filter off) but a detection every 2 frames, online: frames 0
and 2 are detection frames (frame 2's forward estimate claims the whole
frame, so SAM is not prompted there), frames 1 and 3 are propagated.

With random weights most objects' probabilities are nearly flat, so the
saved id maps are not held to the 99% of tests/test_torch_demo_sam.py:
frame 3 agrees on about 96% of its pixels. Instead every difference is
traced to a near-tie, stage by stage, with the budgets of
tests/test_torch_mobile_sam.py and tests/test_torch_ext_processors.py:
- SAM: the logits at the frame's size (every _masks_to_original call)
  within LOGIT_TOL of deva_tpu's; the hard masks (> 0) equal but where
  deva_tpu's logit lies within LOGIT_TOL of 0;
- the detections (auto_segment's id masks at 120x213): equal segments; a
  pixel may differ only where the resize to 120x213 reads a pixel whose
  hard mask differed;
- the saved outputs at 120x213, per frame: propagated frames within ATOL
  everywhere; detection frames beyond ATOL only where the detections differ
  or the forward predictions have another argmax (detection_clips.
  paint_flips); the argmax of a pixel may differ only there or where
  deva_tpu's top two channels lie within 2 x ATOL;
- the saved id maps at 1280x720 (under a one-to-one id matching): a pixel
  may differ only where deva_tpu's probabilities, resized as its saver
  resizes them, have their top two within 2 x ATOL, or next to a pixel of
  120x213 allowed above.
"""
import sys

import numpy as np
import pytest
import torch

from deva_tpu.data.transforms import resize_prob_to
from deva_tpu.ext import automatic_processor as jax_ap
from deva_tpu.ext import detectors as jax_det
from deva_tpu.ext.jax_sam import JaxMobileSAM
from deva_tpu.inference import result_saver as jax_rs
from deva_tpu.inference.core import InferenceCore as JaxCore

from deva_tpu_torch import detection_clips as dc
from deva_tpu_torch.ext import automatic_processor as ap
from deva_tpu_torch.ext.mobile_sam import MobileSAM
from deva_tpu_torch.inference import result_saver as rs
from deva_tpu_torch.inference.core import InferenceCore

from test_torch_demo_drivers import (CLIP, FRAMES, _module,  # noqa: F401
                                     _read, weights)
from test_torch_detection_driver import _matching

torch.set_num_threads(2)

ATOL = 3e-3      # tests/test_torch_ext_processors.py's
LOGIT_TOL = 1e-2  # tests/test_torch_mobile_sam.py's


def _patch(owner, name, make, undo):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    undo.append(lambda: setattr(owner, name, real))


def _spies(key, rec, undo):
    """Record, for one package: SAM's logits at the frame's size, the
    detections, the forward prediction of each incorporate_detection and
    each saved frame's output (host arrays)."""
    r = rec[key] = {"logits": [], "dets": [], "forwards": {}, "saved": {}}
    sam_cls, proc, core_cls, saver_mod = {
        "jax": (JaxMobileSAM, jax_ap, JaxCore, jax_rs),
        "port": (MobileSAM, ap, InferenceCore, rs)}[key]

    def logits(real):
        def f(self, *a, **k):
            out = real(self, *a, **k)
            r["logits"].append(dc.host(out).astype(np.float32))
            return out
        return f

    def segment(real):
        def f(*a, **k):
            mask, infos = real(*a, **k)
            r["dets"].append((np.asarray(mask),
                              [(o.id, o.scores) for o in infos]))
            return mask, infos
        return f

    def incorporate(real):
        def f(self, image, mask, segments, **kw):
            ti = self.curr_ti + 1
            out, r["forwards"][ti] = dc.incorporate_seen(
                self, image, mask, segments,
                incorporate=lambda *a, **k: real(self, *a, **k), **kw)
            return out
        return f

    def save(real):
        def f(self, prob, frame_name, **kw):
            r["saved"][frame_name] = dc.host(prob).astype(np.float32)
            return real(self, prob, frame_name, **kw)
        return f

    _patch(sam_cls, "_masks_to_original", logits, undo)
    _patch(proc, "auto_segment", segment, undo)
    _patch(core_cls, "incorporate_detection", incorporate, undo)
    _patch(saver_mod.ResultSaver, "save_mask", save, undo)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):
    tmp = tmp_path_factory.mktemp("every2")
    sam = str(tmp / "mobile_sam.pt")
    torch.save(MobileSAM(device="cpu", seed=5).net.state_dict(), sam)
    common = ["--img_path", CLIP, "--size", "120", "--model", weights,
              "--sam_variant", "mobile", "--MOBILE_SAM_CHECKPOINT_PATH", sam,
              "--SAM_NUM_POINTS_PER_SIDE", "4",
              "--SAM_PRED_IOU_THRESHOLD=-inf", "--temporal_setting",
              "online", "--detection_every", "2"]
    rec, undo = {}, []
    try:
        _spies("jax", rec, undo)
        _spies("port", rec, undo)
        mod, saved = _module("demo_automatic.py"), sys.argv
        sys.argv = ["demo_automatic.py"] + common + [
            "--output", str(tmp / "jax")]
        try:
            mod.main()
        finally:
            sys.argv = saved
        _module("demo_automatic_torch.py").main(
            common + ["--output", str(tmp / "torch"), "--device", "cpu"])
    finally:
        for u in reversed(undo):
            u()
    return tmp, rec


def test_sam_logits_and_detections(runs):
    _, rec = runs
    ref, ours = rec["jax"], rec["port"]
    assert len(ours["logits"]) == len(ref["logits"]) >= 1
    for got, want in zip(ours["logits"], ref["logits"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
        assert not (((got > 0) != (want > 0)) & (np.abs(want) > LOGIT_TOL)
                    ).any()
    assert len(ours["dets"]) == len(ref["dets"]) == 2
    for (mask, infos), (want, want_infos) in zip(ours["dets"], ref["dets"]):
        assert mask.shape == want.shape == (120, 213)
        assert [i for i, _ in infos] == [i for i, _ in want_infos]
        for (_, s), (_, ws) in zip(infos, want_infos):
            np.testing.assert_allclose(s, ws, rtol=0, atol=1e-3)
    assert not ((ours["dets"][0][0] != ref["dets"][0][0])
                & ~_det_allowed(rec)).any()
    assert ref["dets"][1][1] == [], "frame 2 was expected fully claimed"


def _det_allowed(rec):
    """Pixels [120, 213] of the first detection that may differ: where its
    resize reads a pixel of a hard SAM mask that differs (all of SAM's
    masks of the frame; the NMS keeps a subset)."""
    shape = rec["jax"]["dets"][0][0].shape
    differ = np.zeros(rec["jax"]["logits"][0].shape[-2:], bool)
    for got, want in zip(rec["port"]["logits"], rec["jax"]["logits"]):
        differ |= ((got > 0) != (want > 0)).reshape(-1, *differ.shape) \
            .any(0)
    return jax_det._resize_bilinear(differ.astype(np.float32), shape) > 0


def test_saved_outputs_differ_only_at_near_ties(runs):
    tmp, rec = runs
    ref, ours = rec["jax"], rec["port"]
    names = [f + ".jpg" for f in FRAMES]
    assert sorted(ref["saved"]) == sorted(ours["saved"]) == names
    assert sorted(ref["forwards"]) == sorted(ours["forwards"]) == [0, 2]
    det_allowed = {0: _det_allowed(rec),
                   2: ref["dets"][1][0] != ours["dets"][1][0]}
    flips_total = 0
    hi_allowed = []
    for ti, name in enumerate(names):
        r, o = ref["saved"][name], ours["saved"][name]
        assert r.shape == o.shape and r.shape[1:] == (120, 213)
        top2 = np.sort(r, axis=0)[-2:]
        allowed = (top2[1] - top2[0]) <= 2 * ATOL
        if ti in det_allowed:
            painted = det_allowed[ti].copy()
            flips = dc.paint_flips(ref["forwards"][ti], ours["forwards"][ti])
            if flips is not None:
                painted |= flips
            beyond = (np.abs(o - r) > ATOL).any(0)
            assert not (beyond & ~painted).any(), f"frame {ti}"
            allowed |= painted
        else:
            np.testing.assert_allclose(o, r, rtol=0, atol=ATOL,
                                       err_msg=f"frame {ti}")
        flips = r.argmax(0) != o.argmax(0)
        assert not (flips & ~allowed).any(), f"frame {ti}"
        flips_total += int(flips.sum())
        # the same at the saved size: deva_tpu's saver resizes the
        # probabilities (bilinear, a convex combination: ATOL holds) and
        # takes the argmax; a pixel next to one allowed above may differ
        big = resize_prob_to(r, (720, 1280))
        top2 = np.sort(big, axis=0)[-2:]
        near = np.zeros_like(allowed)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                near |= np.roll(np.roll(allowed, dy, 0), dx, 1)
        rows = np.arange(720) * 120 // 720
        cols = np.arange(1280) * 213 // 1280
        hi_allowed.append(((top2[1] - top2[0]) <= 2 * ATOL)
                          | near[rows][:, cols])
    assert flips_total > 0  # the clip does exercise the near-ties
    for ti, ((want, _), (got, _)) in enumerate(zip(_read(tmp / "jax"),
                                                   _read(tmp / "torch"))):
        pairs, share = _matching(want, got)
        ids, inverse = np.unique(want, return_inverse=True)
        mapped = np.array([pairs.get(int(i), -1) for i in ids])[inverse]
        differ = mapped.reshape(want.shape) != got
        assert not (differ & ~hi_allowed[ti]).any(), (ti, share)
