"""The port's Grounding DINO path (ext/detectors.py:HFGroundedSAM.detect)
with the tiny config-built model of tests/test_gdino.py (random init, no
weight downloads), and segment_with_text end to end with the port's
MobileSAM as the mask source, each against deva_tpu's
(tests/test_torch_replay_text.py runs the replayed detections of
example/vipseg through the port's text processor).

- detect: one model, both packages' HFGroundedSAM (their from_pretrained
  loads bypassed, as tests/test_gdino.py does, device "cpu"): equal boxes,
  scores and class ids.
- segment_with_text: the same detect, the port's MobileSAM against
  deva_tpu's JaxMobileSAM on one seeded .pt: equal ObjectInfos, and the id
  masks equal on at least 99.5% of the pixels (the masks differ only where
  a SAM logit lies within tests/test_torch_mobile_sam.py's budget of 0).
"""
import numpy as np
import torch

from deva_tpu.ext import detectors as jax_det
from deva_tpu.ext.jax_sam import JaxMobileSAM

from deva_tpu_torch.ext import detectors as det
from deva_tpu_torch.ext.mobile_sam import MobileSAM

from test_gdino import tiny_gdino  # noqa: F401

torch.set_num_threads(2)


def _detector(package, tiny_gdino):
    """HFGroundedSAM with the from_pretrained loads bypassed (random init);
    only the Grounding DINO half is populated."""
    d = package.HFGroundedSAM.__new__(package.HFGroundedSAM)
    d.torch, d.device = torch, "cpu"
    d.gd_model, d.gd_processor = tiny_gdino
    d.sam_model = d.sam_processor = None
    d.mask_source = None
    return d


def test_gdino_detect_matches(tiny_gdino):
    img = np.random.default_rng(0).integers(0, 255, (60, 80, 3)) \
        .astype(np.uint8)
    got = _detector(det, tiny_gdino).detect(img, ["dog", "cat"], 0.05, 0.05)
    want = _detector(jax_det, tiny_gdino).detect(img, ["dog", "cat"], 0.05,
                                                 0.05)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].ndim == 2 and got[0].shape[1] == 4
    assert ((got[2] == 0) | (got[2] == 1)).all()


def test_gdino_segment_with_text_with_mobile_sam(tiny_gdino, tmp_path):
    """text -> Grounding DINO boxes -> NMS -> MobileSAM masks -> area-sorted
    id mask, the port's stack against deva_tpu's."""
    path = str(tmp_path / "mobile_sam.pt")
    torch.save(MobileSAM(device="cpu", seed=1).net.state_dict(), path)
    ours = _detector(det, tiny_gdino)
    ours.mask_source = MobileSAM.from_checkpoint(path, device="cpu")
    ref = _detector(jax_det, tiny_gdino)
    ref.mask_source = JaxMobileSAM.from_torch_checkpoint(path)
    img = np.random.default_rng(1).integers(0, 255, (64, 96, 3)) \
        .astype(np.uint8)
    cfg = {"DINO_THRESHOLD": 0.05, "DINO_NMS_THRESHOLD": 0.8}
    mask, infos = det.segment_with_text(cfg, ours, img, ["dog", "cat"], -1)
    want, want_infos = jax_det.segment_with_text(cfg, ref, img,
                                                 ["dog", "cat"], -1)
    assert mask.shape == want.shape == (64, 96)
    assert [(o.id, o.category_ids, o.scores) for o in infos] == \
        [(o.id, o.category_ids, o.scores) for o in want_infos]
    assert infos, "no box passed the threshold"
    assert (mask == want).mean() >= 0.995
