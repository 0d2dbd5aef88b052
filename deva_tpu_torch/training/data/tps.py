"""Thin-plate-spline warping for static-image pseudo-video augmentation.

Behavioral anchor: reference:deva/dataset/tps.py:22-36 (which uses the
`thinplate` package — not available here, so the TPS solve is implemented
directly: radial basis U(r) = r^2 log r^2, affine + kernel weights from the
control-point system, dense grid evaluated with cv2.remap).

A copy of deva_tpu/training/data/tps.py, with cv2 and PIL imported inside
the functions that use them (the card's machine has neither).
"""
from __future__ import annotations

import numpy as np


def _tps_kernel(d2: np.ndarray) -> np.ndarray:
    """U(r) = r^2 log(r^2), with U(0) = 0."""
    return np.where(d2 == 0, 0.0, d2 * np.log(np.maximum(d2, 1e-12)))


def tps_theta_from_points(c_src: np.ndarray, c_dst: np.ndarray) -> np.ndarray:
    """Solve the TPS system mapping c_dst -> c_src displacements.
    c_src/c_dst: [N, 2] in normalized (y, x). Returns theta [(N+3), 2]."""
    n = c_src.shape[0]
    d2 = np.sum((c_dst[:, None] - c_dst[None, :]) ** 2, -1)
    K = _tps_kernel(d2)
    P = np.concatenate([np.ones((n, 1)), c_dst], axis=1)  # [N, 3]
    A = np.zeros((n + 3, n + 3))
    A[:n, :n] = K
    A[:n, n:] = P
    A[n:, :n] = P.T
    b = np.zeros((n + 3, 2))
    b[:n] = c_src - c_dst  # displacement field
    theta = np.linalg.solve(A, b)
    return theta


def tps_grid(theta: np.ndarray, c_dst: np.ndarray, h: int,
             w: int) -> np.ndarray:
    """Evaluate the warp on a dense grid. Returns source coords [H, W, 2]
    (normalized y, x) to sample for each destination pixel."""
    ys = (np.arange(h) + 0.5) / h
    xs = (np.arange(w) + 0.5) / w
    grid = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1)  # [H, W, 2]
    flat = grid.reshape(-1, 2)
    d2 = np.sum((flat[:, None] - c_dst[None, :]) ** 2, -1)
    U = _tps_kernel(d2)  # [HW, N]
    P = np.concatenate([np.ones((flat.shape[0], 1)), flat], 1)  # [HW, 3]
    n = c_dst.shape[0]
    disp = U @ theta[:n] + P @ theta[n:]
    return (flat + disp).reshape(h, w, 2)


def pick_random_points(h: int, w: int, n_samples: int):
    y_idx = np.random.choice(np.arange(h), size=n_samples, replace=False)
    x_idx = np.random.choice(np.arange(w), size=n_samples, replace=False)
    return y_idx / h, x_idx / w


def warp_dual_cv(img: np.ndarray, mask: np.ndarray, c_src: np.ndarray,
                 c_dst: np.ndarray):
    h, w = mask.shape[:2]
    theta = tps_theta_from_points(c_src, c_dst)
    grid = tps_grid(theta, c_dst, h, w)
    mapx = (grid[..., 1] * w - 0.5).astype(np.float32)
    mapy = (grid[..., 0] * h - 0.5).astype(np.float32)
    import cv2
    cv2.setNumThreads(0)
    return (cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR),
            cv2.remap(mask, mapx, mapy, cv2.INTER_NEAREST))


def random_tps_warp(img, mask, scale: float, n_ctrl_pts: int = 12):
    """Random TPS warp of a PIL image/mask pair.
    reference:deva/dataset/tps.py:22-36."""
    from PIL import Image
    img = np.asarray(img)
    mask = np.asarray(mask)
    h, w = mask.shape
    points = pick_random_points(h, w, n_ctrl_pts)
    c_src = np.stack(points, 1)
    c_dst = c_src + np.random.normal(scale=scale, size=c_src.shape)
    warp_im, warp_gt = warp_dual_cv(img, mask, c_src, c_dst)
    return Image.fromarray(warp_im), Image.fromarray(warp_gt)
