"""evaluation/eval_with_detections_batched_torch.py (the port's batched
detection driver) end to end on the CPU, semi-online: against the port's
sequential driver (eval_with_detections_torch.py), with long-term memory off
and on, and against deva_tpu's batched driver (eval_with_detections_
batched.py) at its production default (long-term on), on
tests/test_batched_detection_driver.py's data (the example/vipseg clip
duplicated as two videos, --dataset demo, --size 120).

All drivers load the same .npz weights (tests/test_torch_driver.py:
_weights) and run at once, each in its own process. Long ids are drawn per
process, so outputs are compared per video up to an id bijection
(tests/test_batched_detection_driver.py:_relabel_equal's matching), with
its budget: at most 2% of a frame's pixels differ. (The online setting:
test_torch_batched_detection_driver_online.py.)
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from test_batched_detection_driver import _rgb_to_id
from test_torch_driver import _weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "example", "vipseg")
VIDEOS = ("vidA", "vidB")


def two_videos(root):
    """tests/test_batched_detection_driver.py:two_videos."""
    for vid in VIDEOS:
        shutil.copytree(os.path.join(SRC, "images", "12_1mWNahzcsAc"),
                        root / "images" / vid)
        shutil.copytree(os.path.join(SRC, "source", "12_1mWNahzcsAc"),
                        root / "source" / vid)
    return root


def run_drivers(tmp, runs, extra):
    """Each (name, script, args) of `runs` on the two videos with the
    common flags plus `extra`, all at once; -> {name: output directory}."""
    data = two_videos(tmp / "data")
    common = ["--dataset", "demo", "--img_path", str(data / "images"),
              "--mask_path", str(data / "source"), "--model", _weights(tmp),
              "--size", "120", "--top_k", "8"] + extra
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    out, procs = {}, []
    for name, script, args in runs:
        out[name] = tmp / name
        procs.append((script, subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "evaluation", script),
             *common, *args, "--output", str(out[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)))
    for script, proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stdout + stderr
        if script == "eval_with_detections_batched_torch.py":
            assert "group (120, 213) x2: ['vidA', 'vidB']" in stdout
            assert "Total processed frames: 8" in stdout
    return out


def mismatch(out_a, out_b):
    """{(video, frame): share of the pixels whose id in out_b is not the
    one its id in out_a maps to}, the matching of
    tests/test_batched_detection_driver.py:_relabel_equal (each id of a to
    the id of b it shares most pixels with, fixed at its first frame)."""
    shares = {}
    for vid in VIDEOS:
        dir_a, dir_b = out_a / "Annotations" / vid, out_b / "Annotations" / vid
        frames = sorted(os.listdir(dir_a))
        assert frames == sorted(os.listdir(dir_b))
        fwd = {}
        for f in frames:
            a = _rgb_to_id(np.array(Image.open(dir_a / f)))
            b = _rgb_to_id(np.array(Image.open(dir_b / f)))
            missed = 0
            for ida in np.unique(a):
                sel = a == ida
                vals, counts = np.unique(b[sel], return_counts=True)
                fwd.setdefault(ida, int(vals[counts.argmax()]))
                missed += int(sel.sum() - (b[sel] == fwd[ida]).sum())
            shares[vid, f] = missed / a.size
    return shares


def same_per_video(out_a, out_b, budget=0.02):
    """At most `budget` of every frame's pixels differ (a number, or
    {(video, frame): share})."""
    for key, share in mismatch(out_a, out_b).items():
        limit = budget if np.isscalar(budget) else budget[key]
        assert share <= limit, f"{key}: {share:.2%} pixels differ"


PORT_BATCHED = ("eval_with_detections_batched_torch.py",
                ["--batch", "2", "--device", "cpu"])
PORT_SEQ = ("eval_with_detections_torch.py", ["--device", "cpu"])


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    out = run_drivers(tmp_path_factory.mktemp("semi_lt"), [
        ("deva_tpu", "eval_with_detections_batched.py",
         ["--batch", "2", "--raise_on_error"]),
        ("batched", *PORT_BATCHED), ("sequential", *PORT_SEQ)], [])
    out.update({name + "_nolt": path for name, path in run_drivers(
        tmp_path_factory.mktemp("semi_nolt"), [
            ("batched", *PORT_BATCHED), ("sequential", *PORT_SEQ)],
        ["--disable_long_term"]).items()})
    return out


@pytest.mark.parametrize("lt", [False, True])
def test_batched_driver_matches_sequential(outputs, lt):
    """tests/test_batched_detection_driver.py::test_batched_driver_matches_
    sequential on the port (long-term off and on: the stacking of the
    selection and usage rings runs in the driver)."""
    tag = "" if lt else "_nolt"
    same_per_video(outputs["sequential" + tag], outputs["batched" + tag])


def test_batched_driver_matches_deva_tpu(outputs):
    """The port's batched semi-online driver against deva_tpu's, long-term
    memory on."""
    same_per_video(outputs["deva_tpu"], outputs["batched"])


def test_batched_detection_driver_refuses_missing_cuda(tmp_path):
    """--device defaults to cuda, and the driver exits with an error where
    CUDA is absent (it never carries on on the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = subprocess.run(
        [sys.executable, os.path.join(
            ROOT, "evaluation", "eval_with_detections_batched_torch.py"),
         "--dataset", "vipseg", "--img_path",
         os.path.join(SRC, "images"), "--mask_path",
         os.path.join(SRC, "source"), "--model", "", "--output",
         str(tmp_path)], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
