"""Build and load the CUDA kernels of deva_tpu_torch/csrc.

The kernels are compiled at first use with nvcc into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with ctypes. Each source is compiled by its own nvcc process, all started
together, and the objects are then linked into one library. The library goes into deva_tpu_torch/_build/ (git-ignored),
under a name keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each exported function (all return a CUDA error code)
# (the _I after the ring pointers of sim_topk, topk_readout and
# denom_readout is the ring dtype: 0 float32, 1 bfloat16; the _I before Q in
# the four kernels' functions is the number of videos B, 1 for one video)
_SIGNATURES = {
    "deva_sim_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _P, _P, _P, _P],
    "deva_topk_readout": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P],
    "deva_segmax": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "deva_denom_readout": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "deva_sim2_at": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdeva_kernels_{h.hexdigest()[:16]}.so"


def _nvcc_all(cmds) -> str:
    """Run the nvcc commands at once and wait for every one; raise with
    nvcc's output if one failed. Returns their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{err}")
    return "\n".join(out + err for out, err in outs)


def build() -> Path:
    """Compile the kernels if this version of the sources is not built yet:
    one nvcc per source, all started together, then one link. Returns the
    library path. Raises with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        srcs = [src for src in _sources() if src.suffix == ".cu"]
        objs = [str(work / (src.stem + ".o")) for src in srcs]
        log = _nvcc_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                          obj, str(src)] for src, obj in zip(srcs, objs)])
        lib = work / "lib.so"
        log += _nvcc_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                           *objs]])
        (BUILD_DIR / (out.stem + ".log")).write_text(log)
        os.replace(lib, out)  # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
