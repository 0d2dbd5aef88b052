"""The port's toy-training command lines, scripts/train_toy_torch.py and
scripts/train_fullwidth_proof_torch.py, run as subprocesses on the CPU
(--device cpu) at the smallest sizes: they exit as deva_tpu's
scripts/train_toy.py and scripts/train_fullwidth_proof.py do, and print in
their form (the regular expressions below are those scripts' f-strings).
"""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IOU4 = r"\d\.\d{4}"
IOU3 = r"\d\.\d{3}"
NUM = r"-?\d+\.\d+"

CASES = {
    "toy": (["scripts/train_toy_torch.py", "--steps", "2"], 0, [
        rf"random-init held-out IoU: {IOU4}",
        rf"step 0: total_loss {NUM}",
        rf"step 1: total_loss {NUM}",
        rf"trained held-out IoU after 2 steps: {IOU4}"]),
    "proof_smoke": (["scripts/train_fullwidth_proof_torch.py", "--steps", "1",
                     "--b", "1", "--t", "3", "--hw", "32", "--f32",
                     "--smoke"], 0, [
        r"devices: \[cpu\]  model: full-width float32  batch 1 x 3 frames "
        r"@ 32\^2  remat=False",
        rf"random-init held-out IoU: {IOU3} \(\d+s\)",
        rf"step 0: total_loss {NUM}  \(\+\d+s\)",
        rf"trained 1 steps in \d+s \({NUM} samples/s incl\. compile\)",
        rf"held-out IoU: {IOU3} -> {IOU3}  loss {NUM} -> {NUM}",
        r"SMOKE-OK"]),
    # no --smoke: one step cannot gain 0.2 IoU, so the proof's assertion
    # fails, as deva_tpu's does, and PROOF-OK is not printed
    "proof_bf16_remat": (["scripts/train_fullwidth_proof_torch.py",
                          "--steps", "1", "--b", "1", "--t", "3", "--hw",
                          "32", "--remat"], 1, [
        r"devices: \[cpu\]  model: full-width bfloat16  batch 1 x 3 frames "
        r"@ 32\^2  remat=True",
        rf"random-init held-out IoU: {IOU3} \(\d+s\)",
        rf"step 0: total_loss {NUM}  \(\+\d+s\)",
        rf"trained 1 steps in \d+s \({NUM} samples/s incl\. compile\)",
        rf"held-out IoU: {IOU3} -> {IOU3}  loss {NUM} -> {NUM}"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_script(case):
    argv, rc, lines = CASES[case]
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, *argv, "--device", "cpu"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == rc, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    assert len(out) == len(lines), out
    for line, pattern in zip(out, lines):
        assert re.fullmatch(pattern, line), (line, pattern)
    if rc:
        assert "full-width model failed to learn" in proc.stderr
        assert "PROOF-OK" not in proc.stdout


def test_train_scripts_refuse_cuda_without_a_card():
    """--device defaults to cuda, which fails without CUDA (no fallback)."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for script in ("scripts/train_toy_torch.py",
                   "scripts/train_fullwidth_proof_torch.py"):
        proc = subprocess.run([sys.executable, script, "--steps", "1"],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
