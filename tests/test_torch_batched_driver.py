"""evaluation/eval_vos_batched_torch.py (the port's batched VOS driver) end to
end on the CPU, against deva_tpu's eval_vos_batched.py and against the
port's own single-stream eval_vos_torch.py.

Three synthetic videos of unequal length (tests/test_batched_driver.py's,
at 6, 4 and 6 frames: the shorter one exercises replay and discard past its
end, and the two one-object videos share a group while the two-object one
takes its own bucket), long-term memory on with a tiny configuration so that
consolidation and usage counting run in the driver, weights from one
deva_tpu .npz export of a seeded port model (as tests/test_torch_driver.py
makes it). Budgets: against deva_tpu's batched driver at least 99% of the
labels of every file equal (the two differ by f32 summation order only);
against the port's sequential driver at most 5% of the pixels of a file
differ (tests/test_batched_driver.py's budget: batch-1 and batch-2
convolutions round differently, and the random-init model's outputs are
near-uniform); the same file set from all three.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_driver import _weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
COMMON = ["--dataset", "G", "--size", "-1", "--mem_every", "1", "--top_k",
          "8", "--max_mid_term_frames", "4", "--min_mid_term_frames", "2",
          "--num_prototypes", "8", "--max_long_term_elements", "2000",
          "--topk_method", "exact"]


def _write_video(root, name, t, n_obj, rng):
    """tests/test_batched_driver.py:_write_video."""
    img_dir = os.path.join(root, "JPEGImages", name)
    ann_dir = os.path.join(root, "Annotations", name)
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    base = rng.integers(0, 200, (H // 8, W // 8, 3)).astype(np.float32)
    for ti in range(t):
        img = base + rng.integers(0, 40, (H // 8, W // 8, 3))
        img = np.kron(img, np.ones((8, 8, 1))).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, f"{ti:05d}.png"))
    mask = np.zeros((H, W), np.uint8)
    mask[8:28, 10:40] = 1
    if n_obj > 1:
        mask[36:60, 50:90] = 2
    m = Image.fromarray(mask, mode="P")
    m.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * (256 * 3 - 9))
    m.save(os.path.join(ann_dir, "00000.png"))


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable,
                           os.path.join(ROOT, "evaluation", script), *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _masks(out_dir):
    return {f"{vid}/{f}": np.asarray(Image.open(os.path.join(out_dir, vid,
                                                             f)))
            for vid in sorted(os.listdir(out_dir))
            for f in sorted(os.listdir(os.path.join(out_dir, vid)))}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """The three drivers' output masks on the same data and weights."""
    tmp = tmp_path_factory.mktemp("batched_driver")
    rng = np.random.default_rng(11)
    data = str(tmp / "data")
    _write_video(data, "vid_a", 6, 1, rng)
    _write_video(data, "vid_b", 4, 2, rng)  # shorter: replay and discard
    _write_video(data, "vid_c", 6, 1, rng)  # groups with vid_a
    common = COMMON + ["--generic_path", data, "--model", _weights(tmp)]
    out = {}
    for name, script, extra in (
            ("deva_tpu", "eval_vos_batched.py", ["--batch", "2"]),
            ("batched", "eval_vos_batched_torch.py",
             ["--batch", "2", "--device", "cpu"]),
            ("sequential", "eval_vos_torch.py", ["--device", "cpu"])):
        log = _run(script, *common, *extra, "--output", str(tmp / name))
        out[name] = _masks(str(tmp / name))
        out[name + "_log"] = log
    return out


def test_same_output_files(outputs):
    names = sorted(outputs["batched"])
    assert names == sorted(outputs["deva_tpu"]) == \
        sorted(outputs["sequential"])
    assert len(names) == 6 + 4 + 6
    assert "group (64, 96, 3) x1obj: ['vid_a', 'vid_c']" in \
        outputs["batched_log"]
    assert "Total processed frames: 16" in outputs["batched_log"]
    assert "Aggregate FPS:" in outputs["batched_log"]


def test_batched_driver_matches_deva_tpu_batched_driver(outputs):
    for name, ref in outputs["deva_tpu"].items():
        got = outputs["batched"][name]
        assert got.shape == ref.shape == (H, W)
        agree = (got == ref).mean()
        assert agree >= 0.99, f"{name}: label agreement {agree:.2%}"


def test_batched_driver_matches_sequential_driver(outputs):
    for name, ref in outputs["sequential"].items():
        frac = (outputs["batched"][name] != ref).mean()
        assert frac <= 0.05, f"{name}: {frac:.2%} pixels differ"


def test_batched_driver_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cmd = [sys.executable, os.path.join(ROOT, "evaluation",
                                        "eval_vos_batched_torch.py"),
           "--dataset", "G", "--generic_path",
           os.path.join(ROOT, "example", "vos"), "--model", "",
           "--output", str(tmp_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT,
                          timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
