"""Per-video fault isolation for the evaluation drivers.

A copy of video_fault_barrier from deva_tpu/inference/eval_args.py:77-112
(host-only code: the port imports nothing of deva_tpu, whose package import
loads jax), with one change for the card: a kernel that failed to build,
load or launch, or whose wrapper refused its operands
(ops/cuda_build.KernelError), and a fault of the CUDA device are re-raised
like programming errors. Swallowing them would turn a run whose kernels
never ran into a run that exits 0; after a device fault no later video can
run either. A device fault is torch.AcceleratorError (an illegal address,
a device-side assert, a failed launch), a RuntimeError that torch raises
with a CUDA, cuBLAS or cuDNN status, or whatever a synchronize of the
device raises before an error is swallowed on a CUDA run (a fault that an
earlier asynchronous launch left behind).

Behavioral anchor: reference:evaluation/eval_vos.py:213-216.
"""
from __future__ import annotations

import traceback

import torch

from deva_tpu_torch.ops.cuda_build import KernelError

# programming errors hit every video identically, as deva_tpu's barrier
# lists them (by exact type)
PROGRAMMING_ERRORS = (NameError, AttributeError, ImportError, SyntaxError,
                      TypeError)

# how torch's RuntimeErrors for a failed CUDA, cuBLAS, cuDNN or cuSOLVER
# call begin (c10's CUDA checks, TORCH_CUDABLAS_CHECK, CUDNN_CHECK); a CUDA
# out-of-memory error does not begin so and stays a per-video error
DEVICE_FAULT_PREFIXES = ("CUDA error", "CUDA driver error", "cuDNN error",
                         "CUBLAS_STATUS", "cusolver error")


def is_device_fault(e: BaseException) -> bool:
    """True for a kernel error of the port or a fault of the CUDA device."""
    if isinstance(e, (KernelError, torch.AcceleratorError)):
        return True
    return isinstance(e, RuntimeError) and \
        str(e).startswith(DEVICE_FAULT_PREFIXES)


class video_fault_barrier:
    """Per-video fault isolation: log the failure and keep the run alive.

    The reference wraps each video in try/except that prints and re-raises
    (reference:evaluation/eval_vos.py:213-216, eval_with_detections.py:316-319
    — with a "comment this out if you want" note on the raise); here one
    poisoned video must not kill a whole benchmark run, so the default is
    log-and-continue; --raise_on_error restores the reference behavior.
    Programming errors, kernel errors and device faults always re-raise.
    """

    def __init__(self, vid_name: str, reraise: bool = False):
        self.vid_name = vid_name
        self.reraise = reraise
        self.failed = False

    def __enter__(self):
        return self

    def __exit__(self, etype, e, tb):
        if e is None or etype in (KeyboardInterrupt, SystemExit):
            return False
        print(f"Runtime error at {self.vid_name}")
        print(e)
        if self.reraise:
            return False
        if etype in PROGRAMMING_ERRORS or is_device_fault(e):
            return False
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # raises if the context is poisoned
        traceback.print_exc()
        self.failed = True
        print(f"Skipping {self.vid_name} and continuing.")
        return True
