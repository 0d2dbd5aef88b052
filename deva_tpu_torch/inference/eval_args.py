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

Object sharding for the drivers (deva_tpu/inference/eval_args.py:160-188):
`--obj_shards N` runs a single-stream driver as N processes under torchrun,
one card each, every process on every video with its share of the objects
(InferenceCore(obj_mesh=...), parallel/object_sharding.py); process 0 alone
writes. `add_obj_shards_arg` adds the flag, `obj_mesh_from_args` checks it
against torchrun's WORLD_SIZE (a mismatch raises SystemExit: the run never
falls back to one process) and joins the group, `apply_obj_sharding` builds
the mesh and broadcasts process 0's weights, and `reject_obj_sharding`
refuses the flag in the batched drivers, whose propagators shard videos.
"""
from __future__ import annotations

import os
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


def add_obj_shards_arg(parser) -> None:
    parser.add_argument(
        "--obj_shards", type=int, default=1,
        help="shard the object axis over N processes (run under torchrun "
        "with --nproc_per_node N; each takes its own card); 1 = unsharded")


def obj_shards(args) -> int:
    return getattr(args, "obj_shards", 1) or 1


def join_obj_group(args, device=None):
    """For --obj_shards N > 1: check that torchrun started N processes
    (WORLD_SIZE; anything else raises SystemExit) and join their group
    (parallel.mesh.init_from_env; each takes the card of its LOCAL_RANK).
    Returns the process's device, or `device` itself without sharding."""
    n = obj_shards(args)
    if n <= 1:
        return device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        raise SystemExit(f"--obj_shards {n} needs {n} processes (run under "
                         f"torchrun --nproc_per_node {n}); WORLD_SIZE is "
                         f"{world}")
    from deva_tpu_torch.parallel.mesh import init_from_env
    device, _, _ = init_from_env(args.device if device is None else device)
    return device


def obj_mesh_from_args(args):
    """-> a 1 x obj_shards ('data', 'model') mesh for object-axis sharding,
    or None for --obj_shards 1. The group must be joined
    (join_obj_group)."""
    n = obj_shards(args)
    if n <= 1:
        return None
    from deva_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(1, n)


def apply_obj_sharding(args, model):
    """-> (obj_mesh or None, model). Builds the object-sharding mesh and
    gives every process process 0's weights (parallel.mesh.replicate), so
    that the processes of a randomly initialised or converted model agree
    bit for bit."""
    mesh = obj_mesh_from_args(args)
    if mesh is not None:
        from deva_tpu_torch.parallel.mesh import replicate
        model = replicate(mesh, model)
    return mesh, model


def is_writer(args) -> bool:
    """Whether this process writes the outputs: process 0 of an
    object-sharded run, the only process otherwise."""
    return obj_shards(args) <= 1 or int(os.environ.get("RANK", "0")) == 0


class NullSaver:
    """A saver for the processes that do not write: every method a no-op,
    no video_json."""
    video_json = None

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def reject_obj_sharding(args, driver: str) -> None:
    """Drivers whose hot path is a batched propagator (video-axis mesh)
    don't take --obj_shards; fail loudly instead of silently ignoring."""
    if obj_shards(args) > 1:
        raise SystemExit(f"{driver} does not support --obj_shards (its "
                         "batched propagator shards the video axis); use "
                         "the sequential driver for object-axis sharding")
