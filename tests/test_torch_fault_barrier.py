"""The port's per-video fault barrier (deva_tpu_torch/inference/eval_args.py)
against deva_tpu's, and in the VOS driver.

The barrier swallows data errors (logged; the run goes on with the next
video) and re-raises programming errors, as deva_tpu's does
(tests/test_edge_paths.py::test_fault_barrier_reraises_programming_errors's
three cases, run against both barriers). The port's deviation: its kernel
errors (ops/cuda_build.KernelError, a RuntimeError and a ValueError) and
CUDA device faults are never swallowed, so a run whose kernels fail cannot
exit 0. A real build failure (no nvcc) and the wrappers' refusals of
operands that the kernels do not take (checked before any CUDA call, so
they run here) raise KernelError; a fault that a synchronize of the device
reveals is raised in place of a data error. In eval_vos_torch.py, a
two-video generic run in which one video's data cannot be used writes the
other video and exits 0, and fails with --raise_on_error.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from deva_tpu.inference.eval_args import \
    video_fault_barrier as jax_barrier

from deva_tpu_torch.inference.eval_args import video_fault_barrier
from deva_tpu_torch.ops import approx_kernels as apx
from deva_tpu_torch.ops import attention_kernels as ak
from deva_tpu_torch.ops import cuda_build
from deva_tpu_torch.ops.cuda_build import KernelError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcome(barrier, error, reraise=False):
    """'swallowed' or 'raised', with the barrier's failed flag."""
    b = barrier("vid", reraise=reraise)
    try:
        with b:
            raise error
    except type(error):
        return "raised", b.failed
    return "swallowed", b.failed


# test_edge_paths.py's three cases, held to deva_tpu's barrier
DEVA_CASES = [(ValueError("bad frame data"), False, "swallowed"),
              (NameError("undefined"), False, "raised"),
              (ValueError("raise_on_error"), True, "raised")]


@pytest.mark.parametrize("error,reraise,expected", DEVA_CASES,
                         ids=["data", "programming", "raise_on_error"])
def test_barrier_matches_deva_tpu(error, reraise, expected):
    ours = _outcome(video_fault_barrier, error, reraise)
    assert ours == _outcome(jax_barrier, error, reraise)
    assert ours == (expected, expected == "swallowed")


@pytest.mark.parametrize("error", [
    KernelError("sim_topk kernel launch failed: CUDA error 700"),
    torch.AcceleratorError("CUDA error: an illegal memory access"),
    RuntimeError("CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling "
                 "`cublasSgemm(handle, opa, opb, m, n, k, ...)`"),
    RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED"),
], ids=["kernel", "accelerator", "cublas", "cudnn"])
def test_barrier_never_swallows_kernel_or_device_errors(error):
    """Where deva_tpu's barrier swallows every RuntimeError, the port's
    re-raises its kernel errors and CUDA faults."""
    assert _outcome(jax_barrier, error) == ("swallowed", True)
    assert _outcome(video_fault_barrier, error) == ("raised", False)


def _refusal(case):
    """Calls a kernel wrapper's CUDA route with CPU operands that it
    refuses before any CUDA call."""
    g = torch.Generator().manual_seed(0)
    qk, mk = torch.randn(6, 64, generator=g), torch.randn(40, 64, generator=g)
    ms, valid = torch.ones(40), torch.ones(40, dtype=torch.bool)
    if case == "top_k":  # eval_vos_torch.py --top_k 100 on the card
        ak._sim_topk_cuda(qk, qk, mk, ms, valid, 100)
    elif case == "key_dim":
        wide = torch.randn(6, ak.CK_MAX + 1, generator=g)
        ak._sim_topk_cuda(wide, wide, torch.randn(40, ak.CK_MAX + 1), ms,
                          valid, 8)
    elif case == "mixed_devices":
        ak.sim_topk(qk, qk, mk.to("meta"), ms, valid, 8)
    else:  # an operand width that is no multiple of 4
        ops = apx.Operands(torch.zeros(6, 6), torch.zeros(40, 6), None,
                           torch.zeros(40), ms, valid)
        apx._segmax_cuda(ops, apx.Geometry.of(40, 512))


@pytest.mark.parametrize("case", ["top_k", "key_dim", "mixed_devices",
                                  "approx_width"])
def test_barrier_reraises_refused_launches(case):
    """A launch that a wrapper refuses raises KernelError (still a
    ValueError, as before) through the barrier, where deva_tpu's barrier
    would swallow a ValueError as a data error."""
    with pytest.raises(KernelError) as info:
        with video_fault_barrier("vid") as barrier:
            _refusal(case)
    assert isinstance(info.value, ValueError)
    assert not barrier.failed


def test_barrier_raises_a_fault_that_synchronize_reveals(monkeypatch):
    """On a CUDA run, a data error is swallowed only after a synchronize of
    the device: a fault that an earlier asynchronous launch left in the
    context is raised in its place."""
    def poisoned():
        raise torch.AcceleratorError("CUDA error: an illegal memory access")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", poisoned)
    with pytest.raises(torch.AcceleratorError, match="illegal memory"):
        with video_fault_barrier("vid"):
            raise ValueError("bad frame data")


def test_barrier_swallows_out_of_memory():
    """Running out of device memory on one (long) video is a data error:
    the next video can run."""
    error = torch.OutOfMemoryError("CUDA out of memory")
    assert _outcome(video_fault_barrier, error) == ("swallowed", True)


def test_missing_nvcc_raises_kernel_error(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(KernelError, match="nvcc not found"):
        with video_fault_barrier("vid"):
            cuda_build.build()


def _generic_dataset(root, broken: str):
    """Two 3-frame 64x96 videos of the generic layout; in video 'bad' the
    first frame's image is truncated ('image') or the mask does not fit
    the frames ('mask')."""
    from PIL import Image
    rng = np.random.default_rng(5)
    for vid in ("bad", "good"):
        img_dir = root / "JPEGImages" / vid
        mask_dir = root / "Annotations" / vid
        os.makedirs(img_dir)
        os.makedirs(mask_dir)
        base = rng.integers(0, 255, (8, 12, 3)).astype(np.uint8)
        for i in range(3):
            img = np.kron(base, np.ones((8, 8, 1))).astype(np.uint8)
            Image.fromarray(img).save(img_dir / f"{i:05d}.jpg")
        shape = (32, 48) if vid == "bad" and broken == "mask" else (64, 96)
        mask = np.zeros(shape, np.uint8)
        mask[4:20, 8:30] = 1
        out = Image.fromarray(mask, mode="P")
        out.putpalette([0, 0, 0, 128, 0, 0] + [0] * 762)
        out.save(mask_dir / "00000.png")
    if broken == "image":
        jpg = root / "JPEGImages" / "bad" / "00000.jpg"
        data = jpg.read_bytes()
        jpg.write_bytes(data[:len(data) // 2])


def _run(root, out, *extra):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "evaluation",
                                      "eval_vos_torch.py"),
         "--dataset", "G", "--generic_path", str(root), "--size", "-1",
         "--model", "", "--top_k", "8", "--output", str(out), "--device",
         "cpu", *extra], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)


@pytest.mark.parametrize("broken", ["image", "mask"])
def test_eval_vos_torch_skips_a_bad_video(tmp_path, broken):
    _generic_dataset(tmp_path, broken)
    with ThreadPoolExecutor(2) as pool:
        runs = pool.map(lambda a: _run(tmp_path, *a),
                        [(tmp_path / "out",),
                         (tmp_path / "out_raise", "--raise_on_error")])
        kept, raised = list(runs)
    assert kept.returncode == 0, kept.stdout + kept.stderr
    assert "Skipping bad and continuing." in kept.stdout
    assert sorted(os.listdir(tmp_path / "out" / "good")) == [
        "00000.png", "00001.png", "00002.png"]
    assert raised.returncode != 0
    assert "Runtime error at bad" in raised.stdout
