"""The automatic demos as their users run them, with MobileSAM as the mask
source: demo/demo_automatic_torch.py (--device cpu) and deva_tpu's
demo/demo_automatic.py as subprocesses, side by side, on example/vipseg
(4 frames at 1280x720, --size 120), --sam_variant mobile with
--MOBILE_SAM_CHECKPOINT_PATH set to one seeded port MobileSAM saved as a
.pt in the original layout (the port loads it with
MobileSAM.from_checkpoint, deva_tpu with JaxMobileSAM.from_torch_checkpoint),
the same propagation weights (.npz), a 4x4 point grid, the IoU filter off
(random weights predict meaningless IoUs). Online, with the detection on
frame 0 and frames 1-3 propagated from it.

Budget: tests/test_torch_demo_drivers.py's (at least 99% of each frame's
pixels under a one-to-one id matching, segments matched with equal
category_id). The two SAMs' masks differ only where a logit lies within
f32 rounding of 0 (tests/test_torch_mobile_sam.py). With a second
detection frame (a detection every 2 frames) the last frame agrees on
about 96% of its pixels only: tests/test_torch_demo_sam_every2.py runs
that case in process and traces every differing pixel to a near-tie.
"""
import os
import subprocess
import sys

import torch

from deva_tpu_torch.ext.mobile_sam import MobileSAM

from test_torch_demo_drivers import CLIP, ROOT, _compare  # noqa: F401
from test_torch_demo_drivers import weights  # noqa: F401


def test_demo_automatic_torch_with_mobile_sam_matches(tmp_path, weights):
    sam = str(tmp_path / "mobile_sam.pt")
    torch.save(MobileSAM(device="cpu", seed=5).net.state_dict(), sam)
    common = ["--img_path", CLIP, "--size", "120", "--model", weights,
              "--sam_variant", "mobile", "--MOBILE_SAM_CHECKPOINT_PATH", sam,
              "--SAM_NUM_POINTS_PER_SIDE", "4",
              "--SAM_PRED_IOU_THRESHOLD=-inf", "--temporal_setting",
              "online", "--detection_every", "4"]
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2", HF_HUB_OFFLINE="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "demo", script), *common,
         "--output", str(tmp_path / out), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT)
        for script, out, extra in (
            ("demo_automatic.py", "jax", []),
            ("demo_automatic_torch.py", "torch", ["--device", "cpu"]))]
    for proc in procs:
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out
    assert "Total processed frames: 4" in out
    assert _compare(tmp_path) >= 0.99


def test_demos_refuse_missing_cuda(tmp_path):
    """--device defaults to cuda, and without CUDA both demos stop before
    any work (no fallback to the CPU)."""
    if torch.cuda.is_available():
        import pytest
        pytest.skip("this machine has CUDA")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               HF_HUB_OFFLINE="1")
    for script, extra in (("demo_automatic_torch.py", []),
                          ("demo_with_text_torch.py", ["--prompt", "a"])):
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "demo", script),
             "--img_path", CLIP, "--output", str(tmp_path), *extra],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr, proc.stderr
