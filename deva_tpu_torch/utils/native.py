"""ctypes bindings for the port's native host library (csrc/host/devac.cpp):
the COCO RLE codec, the joint histogram and the consensus integer program's
maximum-weight independent set.

Port of deva_tpu/utils/native.py, with the same ctypes signatures. The
library is built at first use with g++ and deva_tpu/utils/native.py's flags
(-O3 -shared -fPIC, not native/build.sh's -march=native) into
deva_tpu_torch/_build/ (git-ignored), under a name keyed by a hash of the
source and the flags: an edited source is rebuilt, an unchanged one reused.
The compile writes into a temporary directory and ends with os.replace, so
processes that build at once (parallel test workers, ranks) each see the
whole library or none. Nothing here runs at import time.

One deliberate difference from deva_tpu: there, a library that cannot be
built makes these functions return None and the callers take their Python
code. Here a missing g++, a failed compile or a failed load raises
ops.cuda_build.KernelError, as a CUDA kernel does, which the drivers'
per-video fault barrier never swallows: a run never quietly loses its
solver. rle_decode still returns None for a malformed string (a decoded
length other than h * w), a rule about the data that utils/rle.py answers
with its Python decoder, as deva_tpu does. Unlike deva_tpu's, the
library checks such a string before it writes (csrc/host/devac.cpp), a
string that is not ASCII is malformed here (deva_tpu raises
UnicodeEncodeError), and joint_hist and mwis_solve check their arguments'
ranges and shapes before the library indexes with them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from deva_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC, KernelError

SOURCE = CSRC / "host" / "devac.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
# deva_tpu's node budget per component before the greedy fallback
MWIS_BUDGET = 200000

_lib: Optional[ctypes.CDLL] = None


def library_path(build_dir: Optional[Path] = None) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libdevac_{h.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile csrc/host/devac.cpp with g++ if this version is not built
    yet (into build_dir, by default deva_tpu_torch/_build/). Returns the
    library path; raises KernelError without g++ or on a failed compile."""
    out = library_path(build_dir)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelError("g++ not found: the native host library "
                          f"({SOURCE}) cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        lib = work / "libdevac.so"
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(lib), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def get_lib() -> ctypes.CDLL:
    """The native library, built on first call."""
    global _lib
    if _lib is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"cannot load the native host library {path}: "
                              f"{e}") from e
        i64, u8p, chp, i64p, dp = (ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_double))
        lib.rle_encode.restype = i64
        lib.rle_encode.argtypes = [u8p, i64, i64, ctypes.c_char_p, i64]
        lib.rle_decode.restype = i64
        lib.rle_decode.argtypes = [chp, i64, i64, i64, u8p]
        lib.joint_hist.restype = None
        lib.joint_hist.argtypes = [i64p, i64p, i64, i64, i64p]
        lib.mwis_solve.restype = None
        lib.mwis_solve.argtypes = [dp, u8p, i64, i64, u8p]
        _lib = lib
    return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def rle_encode(mask: np.ndarray) -> str:
    """Binary mask [h, w] -> COCO compressed RLE string."""
    lib = get_lib()
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    cap = 2 * h * w + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.rle_encode(_u8p(mask), h, w, buf, cap)
    if n < 0:
        raise KernelError(f"rle_encode: {cap} bytes too few for a {h}x{w} "
                          "mask")
    return buf.raw[:n].decode("ascii")


def rle_decode(counts: str, h: int, w: int) -> Optional[np.ndarray]:
    """COCO compressed RLE string -> uint8 mask [h, w]; None when the
    string is malformed (its runs do not cover exactly h * w pixels)."""
    lib = get_lib()
    out = np.zeros((h, w), np.uint8)
    try:
        s = counts.encode("ascii")
    except UnicodeEncodeError:
        return None
    total = lib.rle_decode(s, len(s), h, w, _u8p(out))
    if total != h * w:
        return None
    return out


def joint_hist(a: np.ndarray, b: np.ndarray, k: int) -> np.ndarray:
    """Intersection table out[i, j] = |{a==i and b==j}|, with a row for
    each of 0..max(a); ids are non-negative and b's below k (ValueError
    otherwise)."""
    lib = get_lib()
    a = np.ascontiguousarray(a.ravel(), np.int64)
    b = np.ascontiguousarray(b.ravel(), np.int64)
    if a.size != b.size:
        raise ValueError(f"joint_hist: {a.size} ids against {b.size}")
    if a.size and (a.min() < 0 or b.min() < 0 or b.max() >= k):
        raise ValueError(f"joint_hist: ids out of range (a in [{a.min()}, "
                         f"{a.max()}], b in [{b.min()}, {b.max()}], k {k})")
    rows = int(a.max()) + 1 if a.size else 1
    out = np.zeros((rows, k), np.int64)
    lib.joint_hist(_i64p(a), _i64p(b), a.size, k, _i64p(out))
    return out


def mwis_solve(weights: np.ndarray, conflict: np.ndarray,
               budget: int = MWIS_BUDGET) -> np.ndarray:
    """Maximum-weight independent set of the conflict graph ([n, n], no
    self-loops): exact branch-and-bound per connected component, greedy
    where a component exceeds the node budget. -> bool selection [n]."""
    lib = get_lib()
    weights = np.ascontiguousarray(weights, np.float64)
    conflict = np.ascontiguousarray(conflict, np.uint8)
    n = weights.shape[0]
    if weights.shape != (n,) or conflict.shape != (n, n):
        raise ValueError(f"mwis_solve: weights {weights.shape} and conflict "
                         f"{conflict.shape}, not [n] and [n, n]")
    out = np.zeros(n, np.uint8)
    lib.mwis_solve(weights.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   _u8p(conflict), n, budget, _u8p(out))
    return out.astype(bool)
