"""Build and load the CUDA kernels of deva_tpu_torch/csrc.

The kernels are compiled at first use with nvcc into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with ctypes. The library goes into deva_tpu_torch/_build/ (git-ignored),
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
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each exported function (all return a CUDA error code)
_SIGNATURES = {
    "deva_sim_topk_limits": [_P, _P, _P, _P, _P],
    "deva_sim_topk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P],
    "deva_topk_readout": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
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


def build() -> Path:
    """Compile the kernels if this version of the sources is not built yet.
    Returns the library path. Raises with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    (BUILD_DIR / (out.stem + ".log")).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
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
