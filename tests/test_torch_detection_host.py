"""The host modules that deva_tpu_torch copies for detection fusion, against
deva_tpu's originals on the same seeded inputs (CPU only, no model):
match_and_merge, the consensus integer program, the JSON -> ObjectInfo
conversion, the panoptic id codecs, the RLE codec, the detection reader,
ResultSaver's files, limit_max_id, and the VIPSeg stuff merge, STQ and
VPQ. Every comparison is exact: equal arrays, equal files, equal numbers.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from deva_tpu.data.detection_video_reader import \
    DetectionVideoReader as JaxDetectionVideoReader
from deva_tpu.inference import segment_merging as jax_sm
from deva_tpu.inference.ilp import solve_consensus_ilp as jax_ilp
from deva_tpu.inference.object_info import ObjectInfo as JaxObjectInfo
from deva_tpu.inference.object_manager import ObjectManager as JaxObjectManager
from deva_tpu.inference.object_utils import \
    convert_json_dict_to_objects_info as jax_convert
from deva_tpu.inference.postprocess_unsup_davis17 import \
    limit_max_id as jax_limit_max_id
from deva_tpu.inference.result_saver import ResultSaver as JaxResultSaver
from deva_tpu.metrics import eval_stq_vipseg as jax_stq
from deva_tpu.metrics import eval_vpq_vipseg as jax_vpq
from deva_tpu.metrics import stuff_merging as jax_merge
from deva_tpu.utils import pano_utils as jax_pano
from deva_tpu.utils import rle as jax_rle

from deva_tpu_torch.data.detection_video_reader import DetectionVideoReader
from deva_tpu_torch.inference import segment_merging
from deva_tpu_torch.inference.ilp import solve_consensus_ilp
from deva_tpu_torch.inference.object_info import ObjectInfo
from deva_tpu_torch.inference.object_manager import ObjectManager
from deva_tpu_torch.inference.object_utils import \
    convert_json_dict_to_objects_info
from deva_tpu_torch.inference.postprocess_unsup_davis17 import limit_max_id
from deva_tpu_torch.inference.result_saver import ResultSaver
from deva_tpu_torch.metrics import eval_stq_vipseg, eval_vpq_vipseg
from deva_tpu_torch.metrics import stuff_merging
from deva_tpu_torch.ops.aggregate import argmax_ids
from deva_tpu_torch.utils import pano_utils, rle
from deva_tpu_torch.utils.vipseg_categories import VIPSEG_CATEGORIES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIPSEG = os.path.join(ROOT, "example", "vipseg")
ISTHING = (None, False, True)


def _table(om):
    return [(o.id, t, o.poke_count, o.isthing, o.category_ids, o.scores)
            for o, t in om.obj_to_tmp_id.items()]


def _blocky(rng, values, shape=(32, 48), cell=4):
    grid = rng.choice(values, (shape[0] // cell, shape[1] // cell))
    return np.kron(grid, np.ones((cell, cell), np.int64))


@pytest.mark.parametrize("incremental", [False, True])
@pytest.mark.parametrize("max_num_objects", [-1, 9])
def test_match_and_merge_parity(incremental, max_num_objects):
    """Six rounds per trial on one pair of object managers with equal
    seeded id generators: blocky tmp-id forward masks, detections that
    keep most of their cells (so IoU > 0.5 matches happen) with ids from a
    small range (so collisions redraw), every isthing group, pokes that
    accumulate, and the purge after each round. With max_num_objects 9
    some rounds deny their new objects."""
    rng = np.random.default_rng(11 + incremental + 2 * max_num_objects)
    for trial in range(4):
        managers = (ObjectManager(np.random.default_rng(trial)),
                    JaxObjectManager(np.random.default_rng(trial)))
        for _ in range(6):
            n_tmp = managers[0].num_obj
            grid = _blocky(rng, np.arange(8))
            our = np.where(grid <= n_tmp, grid, 0)
            noisy = np.where(rng.uniform(size=grid.shape) < 0.2,
                             _blocky(rng, np.arange(8)), grid)
            ids = rng.choice(np.arange(1, 16), 8, replace=False)
            new = np.where(noisy > 0, ids[noisy], 0)
            present = [int(i) for i in np.unique(new) if i]
            cats = {i: int(rng.integers(0, 124)) for i in present}
            things = {i: ISTHING[rng.integers(0, 3)] for i in present}
            merged = []
            for om, cls, mod in ((managers[0], ObjectInfo, segment_merging),
                                 (managers[1], JaxObjectInfo, jax_sm)):
                segs = [cls(i, category_id=cats[i], isthing=things[i])
                        for i in present]
                merged.append(mod.match_and_merge(
                    our, new, om, segs, max_num_objects=max_num_objects,
                    incremental_mode=incremental))
                om.purge_inactive_objects(2)
            np.testing.assert_array_equal(merged[0], merged[1])
            assert merged[0].dtype == np.float32
            assert _table(managers[0]) == _table(managers[1])


def _objective(iou, sel):
    x = np.asarray(sel, np.float64)
    return float(2 * (iou @ x).sum() - x.sum())


def test_consensus_ilp_parity(monkeypatch):
    """Seeded random conflict graphs, built as consensus.py builds them (n
    up to 30): the port's selection equals that of deva_tpu's Python
    solver, which it copies; its objective equals that of deva_tpu's
    default solver (native/devac.cpp's mwis_solve where built, which
    breaks weight ties in std::sort's order, so another optimum may come
    out), and brute force over every feasible subset for n <= 12."""
    from deva_tpu.utils import native
    rng = np.random.default_rng(0)
    for trial in range(60):
        n = int(rng.integers(1, 31 if trial % 2 else 13))
        iou = np.zeros((n, n), np.float32)
        for i in range(n):
            for j in range(i + 1, n):
                if rng.uniform() < 0.3:
                    iou[i, j] = rng.uniform(0.5, 1.0)
        iou = iou + iou.T
        conflict = iou > 0.49
        iou = iou * conflict
        sel = solve_consensus_ilp(iou, conflict)
        assert abs(_objective(iou, sel) -
                   _objective(iou, jax_ilp(iou, conflict))) < 1e-6
        with monkeypatch.context() as m:
            m.setattr(native, "mwis_solve", lambda *a: None)
            assert list(map(bool, sel)) == \
                list(map(bool, jax_ilp(iou, conflict)))
        chosen = [i for i, s in enumerate(sel) if s]
        assert not any(conflict[i, j] for i in chosen for j in chosen)
        if n <= 12:
            best = max(_objective(iou, [(m >> i) & 1 for i in range(n)])
                       for m in range(2 ** n)
                       if not any(conflict[i, j] and (m >> i) & (m >> j) & 1
                                  for i in range(n) for j in range(n)))
            assert abs(_objective(iou, sel) - best) < 1e-6, (trial, n)


def test_convert_json_dict_to_objects_info_parity():
    segments = [{"id": 3, "category_id": 2, "score": 0.5},
                {"id": 9, "category_id": 0, "score": "0.25"},
                {"id": 300, "category_id": 123}]
    mask = np.array([[0, 3, 3], [9, 0, 4]])
    for dataset in ("vipseg", "burst", "demo", None):
        for args in ((None, segments), (mask, None)):
            if dataset == "vipseg" and args[1] is None:
                continue
            ours = convert_json_dict_to_objects_info(*args, dataset=dataset)
            ref = jax_convert(*args, dataset=dataset)
            assert [(o.id, o.category_ids, o.isthing, o.scores)
                    for o in ours] == [(o.id, o.category_ids, o.isthing,
                                        o.scores) for o in ref]


def test_pano_utils_parity():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256 ** 3, (17, 23))
    rgb = pano_utils.id_to_rgb(ids)
    np.testing.assert_array_equal(rgb, jax_pano.id_to_rgb(ids))
    np.testing.assert_array_equal(pano_utils.rgb_to_id(rgb), ids)
    ours = pano_utils.ID2RGBConverter(np.random.default_rng(4))
    ref = jax_pano.ID2RGBConverter(np.random.default_rng(4))
    for obj in [5, 7, 5, 300, 7, 11]:
        a, b = ours.convert(obj), ref.convert(obj)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    ours = pano_utils.IDPostprocessor(np.random.default_rng(6))
    ref = jax_pano.IDPostprocessor(np.random.default_rng(6))
    for obj, cat, thing in [(5, 1, True), (5, 2, True), (9, 3, False),
                            (10, 3, False), (5, 1, True), (9, 4, False)]:
        assert ours.convert(obj, cat, thing) == ref.convert(obj, cat, thing)


def test_rle_round_trip_and_parity():
    """The port's Python codec: round trip and area, and the same strings
    as deva_tpu's encoder (its native codec where built)."""
    rng = np.random.default_rng(3)
    masks = [(rng.uniform(size=s) > 0.6).astype(np.uint8)
             for s in [(1, 1), (7, 5), (64, 48), (120, 213)]]
    masks += [np.zeros((5, 4), np.uint8), np.ones((5, 4), np.uint8)]
    for m in masks:
        enc = rle.encode(m)
        assert enc == jax_rle.encode(m)
        np.testing.assert_array_equal(rle.decode(enc), m)
        np.testing.assert_array_equal(jax_rle.decode(enc), m)
        assert rle.area(enc) == int(m.sum())


def test_detection_video_reader_parity():
    vid = "12_1mWNahzcsAc"
    args = (vid, os.path.join(VIPSEG, "images", vid),
            os.path.join(VIPSEG, "source", vid))
    ours = DetectionVideoReader(*args, size=120)
    ref = JaxDetectionVideoReader(*args, size=120)
    assert len(ours) == len(ref) == 4
    assert ours.get_palette() == ref.get_palette()
    for i in range(len(ours)):
        o, r = ours[i], ref[i]
        np.testing.assert_array_equal(o["rgb"], r["rgb"])
        np.testing.assert_array_equal(o["mask"], r["mask"])
        assert o["info"] == r["info"]


def test_argmax_ids_matches_numpy():
    """deva_tpu's device_argmax_ids rule: uint8 ids for at most 256
    channels, int32 beyond, the first maximum on ties (as np.argmax)."""
    rng = np.random.default_rng(0)
    prob = rng.uniform(0, 1, (5, 33, 47)).astype(np.float32)
    prob[1, :4, :4] = prob[0, :4, :4]
    prob[3, 5:9, :] = prob[2, 5:9, :] = 2.0
    ids = argmax_ids(torch.from_numpy(prob))
    assert ids.dtype == np.uint8
    np.testing.assert_array_equal(ids, np.argmax(prob, axis=0))
    many = np.zeros((300, 4, 4), np.float32)
    many[257, 1, 1] = 1.0
    ids = argmax_ids(torch.from_numpy(many))
    assert ids.dtype == np.int32 and ids[1, 1] == 257
    np.testing.assert_array_equal(ids, np.argmax(many, axis=0))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("dataset", ["vipseg", "burst", "unsup_davis17"])
def test_result_saver_files_parity(tmp_path, dataset):
    """The same probabilities and object table through both savers: the
    port's argmax on a tensor, deva_tpu's on numpy; the PNG files and the
    video JSON equal byte for byte. vipseg and burst write long ids (RGB
    PNGs, and RLE for burst), unsup_davis17 palette PNGs of tmp-id masks
    mapped to object ids."""
    video = "seqset/seq0" if dataset == "burst" else "seq0"
    palette = bytes(range(256)) * 3
    jsons = []
    for name, om, cls, saver_cls, as_input in (
            ("port", ObjectManager(), ObjectInfo, ResultSaver,
             torch.from_numpy),
            ("jax", JaxObjectManager(), JaxObjectInfo, JaxResultSaver,
             np.asarray)):
        om.use_long_id = dataset != "unsup_davis17"
        base = 300 if om.use_long_id else 1
        om.add_new_objects([cls(base + 7 * i, category_id=i + 1, score=0.5)
                            for i in range(4)])
        saver = saver_cls(str(tmp_path / name), video, dataset=dataset,
                          object_manager=om, palette=palette)
        frame_rng = np.random.default_rng(5)
        for t in range(3):
            prob = frame_rng.uniform(0, 1, (5, 24, 40)).astype(np.float32)
            prob[:, :, :8] = prob[:1, :, :8]  # ties: background wins
            saver.save_mask(as_input(prob), f"{t:05d}.png")
        saver.end()
        if dataset != "unsup_davis17":
            jsons.append(json.dumps(saver.video_json, sort_keys=True))
    ours, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert ours.keys() == ref.keys() and len(ours) == 3
    assert ours == ref
    if jsons:
        assert jsons[0] == jsons[1]


def test_limit_max_id_parity(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(7)
    src = tmp_path / "src" / "vid"
    os.makedirs(src)
    for t in range(3):
        ids = _blocky(rng, np.array([0, 300, 301, 302, 70000, 80000]),
                      (24, 40))
        Image.fromarray(pano_utils.id_to_rgb(ids)).save(src / f"{t:05d}.png")
    limit_max_id(str(tmp_path / "src"), str(tmp_path / "port"),
                 max_num_objects=3)
    jax_limit_max_id(str(tmp_path / "src"), str(tmp_path / "jax"),
                     max_num_objects=3)
    ours, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(ours) == 3 and ours == ref


def _vipseg_tree(root, rng):
    """A seeded VIPSeg-style tree of two 4-frame videos at 24x32: ground
    truth RGB panoptic PNGs and panoptic_gt json, and a prediction
    (pan_pred PNGs, pred.json) with moved segments, a thing whose category
    flips, two stuff segments of one category and a false positive."""
    from PIL import Image
    cats = [c for c in VIPSEG_CATEGORIES]
    thing = [c["id"] for c in cats if c["isthing"]]
    stuff = [c["id"] for c in cats if not c["isthing"]]
    gt = {"categories": cats, "videos": [], "annotations": []}
    pred = {"annotations": []}
    for v in range(2):
        vid = f"vid{v}"
        os.makedirs(root / "gt" / vid)
        os.makedirs(root / "pred" / "pan_pred" / vid)
        gt["videos"].append({"video_id": vid, "images": []})
        g_anns, p_anns = [], []
        t_cat, s_cat = int(rng.choice(thing)), int(rng.choice(stuff))
        for t in range(4):
            name = f"{t:05d}"
            g = np.zeros((24, 32), np.int64)
            g[:8] = 1000 + s_cat
            g[10:20, 2 + t:12 + t] = 2000 + t_cat
            g[12:22, 20:30] = 3000 + thing[0]
            p = np.zeros_like(g)
            p[:7] = 500
            p[7:9] = 501  # the same stuff category, another id
            p[10:19, 3 + t:12 + t] = 600
            p[12:22, 19:29] = 700
            p[0:3, 28:32] = 800 if t % 2 else 0
            for arr, path in ((g, root / "gt" / vid / f"{name}.png"),
                              (p, root / "pred" / "pan_pred" / vid /
                               f"{name}.png")):
                Image.fromarray(pano_utils.id_to_rgb(arr)).save(path)
            gt["videos"][-1]["images"].append({"file_name": f"{name}.png"})
            g_anns.append({"file_name": f"{name}.png", "segments_info": [
                {"id": int(i), "category_id": int(i) % 1000, "iscrowd": 0,
                 "area": int((g == i).sum())} for i in np.unique(g) if i]})
            p_anns.append({"file_name": f"{name}.jpg", "segments_info": [
                {"id": 500, "category_id": s_cat},
                {"id": 501, "category_id": s_cat},
                {"id": 600, "category_id": t_cat if t < 2 else thing[1]},
                {"id": 700, "category_id": thing[0]}]
                + ([{"id": 800, "category_id": thing[2]}] if t % 2 else [])})
        gt["annotations"].append({"video_id": vid, "annotations": g_anns})
        pred["annotations"].append({"video_id": vid, "annotations": p_anns})
    with open(root / "gt.json", "w") as f:
        json.dump(gt, f)
    with open(root / "pred" / "pred.json", "w") as f:
        json.dump(pred, f)


def test_vipseg_metrics_parity(tmp_path, monkeypatch):
    """merge_stuff, then STQ and VPQ (every window), through both packages
    on copies of one seeded tree: equal merged files and equal numbers.
    The stuff merge's id post-processors get equal seeded generators (a
    thing whose category changes draws a new id)."""
    for mod, pano in ((stuff_merging, pano_utils), (jax_merge, jax_pano)):
        monkeypatch.setattr(mod, "IDPostprocessor", lambda p=pano:
                            p.IDPostprocessor(np.random.default_rng(0)))
    _vipseg_tree(tmp_path, np.random.default_rng(8))
    shutil.copytree(tmp_path / "pred", tmp_path / "jax")
    shutil.copytree(tmp_path / "pred", tmp_path / "port")
    stuff_merging.merge_stuff(str(tmp_path / "port"), str(tmp_path / "port"),
                              num_processes=1)
    jax_merge.merge_stuff(str(tmp_path / "jax"), str(tmp_path / "jax"),
                          num_processes=1)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    gt = (str(tmp_path / "gt"), str(tmp_path / "gt.json"))
    ours = eval_stq_vipseg.eval_stq(str(tmp_path / "port"), *gt)
    ref = jax_stq.eval_stq(str(tmp_path / "jax"), *gt)
    assert 0 < ours["STQ"] < 1
    for key in ("STQ", "AQ", "IoU", "STQ_per_seq", "AQ_per_seq",
                "ID_per_seq"):
        np.testing.assert_array_equal(ours[key], ref[key])
    ours = eval_vpq_vipseg.eval_vpq(str(tmp_path / "port"), *gt,
                                    num_processes=1)
    ref = jax_vpq.eval_vpq(str(tmp_path / "jax"), *gt, num_processes=1)
    assert ours == ref and 0 < ours[0][0] < 100
