"""COCO-compatible run-length encoding.

Port of deva_tpu/utils/rle.py. encode and decode answer through the port's
native host library (utils/native.py: rle_encode/rle_decode of
csrc/host/devac.cpp, a copy of native/devac.cpp), as deva_tpu's do wherever
g++ can build its library, with deva_tpu's one data rule: a string whose
runs do not cover h * w pixels (malformed) is decoded by the Python decoder.
The library rejects such a string before it writes; a string that is not
ASCII is malformed too (deva_tpu's native path raises on it).
The numpy codec stays as encode_python and decode_python, the native
codec's twins in the tests; no run's path calls them but for that rule.

Replaces the pycocotools C codec the reference uses for BURST json output
(reference:deva/inference/result_utils.py:182-184); this image has no
pycocotools. Format-compatible with pycocotools' compressed RLE strings:
column-major (Fortran) runs of alternating 0/1 starting with zeros, run
lengths delta-coded against count[i-2] and packed as 6-bit chars (offset 48,
bit 0x20 = continuation), per the COCO API spec.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from deva_tpu_torch.utils import native


def _runs_from_mask(mask: np.ndarray) -> np.ndarray:
    flat = np.asfortranarray(mask.astype(np.uint8)).flatten(order="F")
    if flat.size == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds)
    if flat[0] == 1:  # counts must start with the number of zeros
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def _leb_encode(counts: np.ndarray) -> str:
    out = []
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            digit = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (digit & 0x10)) or
                        (x == -1 and (digit & 0x10)))
            if more:
                digit |= 0x20
            out.append(chr(digit + 48))
    return "".join(out)


def _leb_decode(s: str) -> np.ndarray:
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, dtype=np.int64)


def encode(mask: np.ndarray) -> Dict:
    """binary mask [H, W] -> {'size': [H, W], 'counts': str} (COCO RLE),
    by the native codec."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": native.rle_encode(mask)}


def decode(rle: Dict) -> np.ndarray:
    """{'size': [H, W], 'counts': str|list} -> binary mask [H, W] uint8; a
    string by the native codec unless it is malformed."""
    counts = rle["counts"]
    if isinstance(counts, str):
        out = native.rle_decode(counts, *rle["size"])
        if out is not None:
            return out
    return decode_python(rle)


def encode_python(mask: np.ndarray) -> Dict:
    """encode in numpy (deva_tpu's fallback codec)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": _leb_encode(_runs_from_mask(mask))}


def decode_python(rle: Dict) -> np.ndarray:
    """decode in numpy (deva_tpu's fallback codec)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _leb_decode(counts)
    else:
        counts = np.asarray(counts, dtype=np.int64)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += int(c)
        val ^= 1
    return flat.reshape((h, w), order="F")


def area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _leb_decode(counts)
    return int(np.sum(counts[1::2]))
