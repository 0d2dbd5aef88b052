"""Index-mask palettes.

A copy of deva_tpu/utils/palette.py
(host-only code: the port imports nothing of deva_tpu, whose package
import loads jax).

The DAVIS palette is the standard PASCAL-VOC colormap (generated here
algorithmically rather than stored as a binary blob like
reference:deva/utils/palette.py). Benchmarks that require the exact original
palette get it from the first ground-truth mask at read time
(reference:deva/inference/data/video_reader.py:128-130), which we do too.
"""
from __future__ import annotations

import numpy as np


def voc_colormap(n: int = 256) -> np.ndarray:
    """PASCAL VOC colormap: bit-reversal of the label index. [n, 3] uint8."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def davis_palette() -> bytes:
    """768-byte palette for palette-PNG mask saving (VOC/DAVIS colormap)."""
    return voc_colormap().tobytes()


def youtube_palette() -> bytes:
    """YouTubeVOS-style palette: distinct first colors, VOC tail."""
    cmap = voc_colormap().copy()
    head = np.array([
        [0, 0, 0], [236, 95, 103], [249, 145, 87], [250, 200, 99],
        [153, 199, 148], [98, 179, 178], [102, 153, 204], [197, 148, 197],
        [171, 121, 103],
    ], dtype=np.uint8)
    cmap[:len(head)] = head
    return cmap.tobytes()
