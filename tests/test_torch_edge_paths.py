"""deva_tpu_torch against deva_tpu on the three edge paths of
tests/test_edge_paths.py that cannot run without the reference checkout:
soft-mask seeded propagation (the referring and saliency pattern: a soft
mask, image_ti_override and delete_buffer=False), incremental detection
fusion with a purge, and the max_num_objects denial. Each uses that file's
configuration (mem_every 2, top_k 8 > the 24 tokens of a 64x96 frame,
long-term off) and frames, with one seeded model in both packages and equal
seeded id generators.

Budgets (test_edge_paths.py's): per frame, pixels where any channel differs
by more than 3e-3 on at most 0.2% of the frame (0.4% with detections); the
object tables (counts, poke counts) equal.
"""
import numpy as np
import pytest
import torch

from deva_tpu.inference.object_info import ObjectInfo as JaxObjectInfo

from deva_tpu_torch.inference.object_info import ObjectInfo

from torch_detection_common import cores, host, models, softmax  # noqa: F401

torch.set_num_threads(2)

H, W = 64, 96


def _cfg(**over):
    """test_edge_paths.py:_cfg_pair's InferenceConfig."""
    cfg = dict(mem_every=2, top_k=8, enable_long_term=False,
               max_mid_term_frames=4, min_mid_term_frames=2,
               num_prototypes=16, max_long_term_elements=96,
               max_missed_detection_count=1, max_num_objects=-1)
    cfg.update(over)
    return cfg


def _frames(rng, t):
    base = rng.standard_normal((H // 8, W // 8, 3)).astype(np.float32)
    return [np.kron(base + 0.1 * rng.standard_normal((H // 8, W // 8, 3)),
                    np.ones((8, 8, 1))).astype(np.float32)
            for _ in range(t)]


def _close(r, o, ti, budget=0.002):
    r, o = host(r), host(o)
    assert r.shape == o.shape, (ti, r.shape, o.shape)
    bad = (np.abs(o - r) > 3e-3).any(axis=0)
    assert bad.mean() <= budget, f"frame {ti}: {bad.mean():.2%}"


def test_soft_mask_seeded_propagation(models):
    """step(mask, hard_mask=False) with image_ti_override + delete_buffer
    False: both packages take the composed path and keep every frame's
    features in the store."""
    ours, ref = cores(models, _cfg())
    frames = _frames(np.random.default_rng(31), 5)
    soft = np.zeros((2, H, W), np.float32)
    soft[0, 8:28, 10:40] = 0.9
    soft[1, 36:60, 50:90] = 0.8
    for ti, img in enumerate(frames):
        args = dict(image_ti_override=10 + ti, delete_buffer=False)
        if ti == 0:
            rp = ref.step(img, soft, hard_mask=False, **args)
            op = ours.step(img, soft, hard_mask=False, **args)
        else:
            rp, op = ref.step(img, **args), ours.step(img, **args)
        assert op.shape == (3, H, W)
        _close(rp, op, ti)
    assert len(ours.image_feature_store) == len(ref.image_feature_store) \
        == 5


def test_incremental_detection_and_purge(models):
    """incorporate_detection(incremental=True): visible objects keep living
    even when unsupported; invisible ones get poked and purged."""
    ours, ref = cores(models, _cfg(max_missed_detection_count=0))
    frames = _frames(np.random.default_rng(32), 6)
    det0 = np.zeros((H, W), np.int64)
    det0[8:28, 10:40] = 1
    det0[36:60, 50:90] = 2
    det_later = np.zeros((H, W), np.int64)
    det_later[10:30, 12:42] = 3  # only overlaps object 1's region
    for ti, img in enumerate(frames):
        if ti % 3 == 0:
            det = det0 if ti == 0 else det_later
            ids = [int(i) for i in np.unique(det) if i != 0]
            out = []
            for core, info in ((ref, JaxObjectInfo), (ours, ObjectInfo)):
                segments = [info(id=i) for i in ids]
                for s in segments:
                    s.isthing = True
                out.append(softmax(core.incorporate_detection(
                    img, det, segments, incremental=True)))
            _close(*out, ti, budget=0.004)
        else:
            _close(ref.step(img), ours.step(img), ti, budget=0.004)
    assert ref.object_manager.num_obj == ours.object_manager.num_obj
    pokes = [sorted(o.poke_count for o in core.object_manager.obj_to_tmp_id)
             for core in (ref, ours)]
    assert pokes[0] == pokes[1]


def test_max_num_objects_denial(models):
    """Global object cap: new detections are discarded, with a warning,
    when the total would exceed max_num_objects
    (reference:segment_merging.py:115-121)."""
    ours, ref = cores(models, _cfg(max_num_objects=2,
                                   max_missed_detection_count=99))
    frames = _frames(np.random.default_rng(33), 3)
    det0 = np.zeros((H, W), np.int64)
    det0[8:28, 10:40] = 1
    det0[36:60, 50:90] = 2
    det1 = np.zeros((H, W), np.int64)
    det1[2:18, 60:88] = 7  # a third object: must be denied
    for ti, (det, ids) in enumerate([(det0, [1, 2]), (det1, [7])]):
        out = []
        for core, info in ((ref, JaxObjectInfo), (ours, ObjectInfo)):
            if ti == 1:
                with pytest.warns(UserWarning):
                    out.append(core.incorporate_detection(
                        frames[ti], det, [info(id=i) for i in ids]))
            else:
                out.append(core.incorporate_detection(
                    frames[ti], det, [info(id=i) for i in ids]))
        _close(softmax(out[0]), softmax(out[1]), ti, budget=0.004)
    assert ref.object_manager.num_obj == ours.object_manager.num_obj == 2
