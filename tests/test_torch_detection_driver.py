"""deva_tpu_torch's detection driver against deva_tpu's, end to end on
example/vipseg (4 frames at 1280x720 with PNG+JSON detections), in both
temporal settings.

Both drivers load the same .npz weights (a seeded port model exported
through deva_tpu's converter, tests/test_torch_driver.py:_weights), run
at --size 120, and write pan_pred PNGs and pred.json, stuff-merged. Object
ids are drawn per process, so the two outputs are compared after a
one-to-one matching of their segment ids (the assignment that maximises
the pixels they share). Budget, per frame: at least 99% of the pixels
agree under the matching, and the segments match one to one with equal
category_id and isthing and areas within 1%. (The two differ by f32
summation order; with random weights the objects' probabilities are
nearly flat, and a near-tie pixel may flip.)
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from deva_tpu_torch.utils.pano_utils import rgb_to_id

from test_torch_driver import _weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(ROOT, "example", "vipseg")
VIDEO = "12_1mWNahzcsAc"
FRAMES = ["00001255", "00001258", "00001261", "00001264"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return _weights(tmp_path_factory.mktemp("weights"))


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "evaluation", script), *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    return proc


def _read(out_dir):
    from PIL import Image
    with open(os.path.join(out_dir, "pred.json")) as f:
        video, = json.load(f)["annotations"]
    assert video["video_id"] == VIDEO
    frames = []
    for ann, name in zip(video["annotations"], FRAMES):
        assert ann["file_name"] == name + ".jpg"
        ids = rgb_to_id(np.asarray(Image.open(os.path.join(
            out_dir, "pan_pred", VIDEO, name + ".png"))))
        segs = {s["id"]: (s["category_id"], s["isthing"])
                for s in ann["segments_info"]}
        frames.append((ids, segs))
    assert len(frames) == len(FRAMES)
    return frames


def _matching(a, b):
    """The one-to-one id matching of two id maps that maximises the pixels
    they share -> ({id in a: id in b}, share of the pixels it covers)."""
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    shared = np.zeros((len(ua), len(ub)), np.int64)
    np.add.at(shared, (ia.ravel(), ib.ravel()), 1)
    rows, cols = linear_sum_assignment(-shared)
    pairs = {int(ua[r]): int(ub[c]) for r, c in zip(rows, cols)}
    return pairs, shared[rows, cols].sum() / a.size


@pytest.mark.parametrize("setting", ["online", "semionline"])
def test_eval_with_detections_torch_matches_jax(tmp_path, weights, setting):
    common = ["--dataset", "vipseg", "--img_path",
              os.path.join(CLIP, "images"), "--mask_path",
              os.path.join(CLIP, "source"), "--size", "120", "--model",
              weights, "--no_metrics", "--temporal_setting", setting]
    ref = _run("eval_with_detections.py", *common, "--output",
               str(tmp_path / "jax"))
    assert ref.returncode == 0, ref.stdout + ref.stderr
    ours = _run("eval_with_detections_torch.py", *common, "--output",
                str(tmp_path / "torch"), "--device", "cpu")
    assert ours.returncode == 0, ours.stdout + ours.stderr
    assert "Total processed frames: 4" in ours.stdout

    for (ids_j, segs_j), (ids_t, segs_t) in zip(_read(tmp_path / "jax"),
                                                _read(tmp_path / "torch")):
        assert ids_t.shape == ids_j.shape == (720, 1280)
        pairs, agree = _matching(ids_j, ids_t)
        assert agree >= 0.99, f"pixel agreement {agree}"
        assert len(segs_t) == len(segs_j) > 0
        for sid, meta in segs_j.items():
            tid = pairs[sid]
            assert segs_t[tid] == meta, (sid, tid, meta, segs_t[tid])
            area_j, area_t = (ids_j == sid).sum(), (ids_t == tid).sum()
            assert abs(area_t - area_j) <= 0.01 * area_j, (sid, area_j,
                                                           area_t)


def test_eval_with_detections_torch_refuses_missing_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = _run("eval_with_detections_torch.py", "--mask_path",
                os.path.join(CLIP, "source"), "--img_path",
                os.path.join(CLIP, "images"), "--model", "", "--output",
                str(tmp_path))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
