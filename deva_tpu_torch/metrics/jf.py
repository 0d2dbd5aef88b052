"""DAVIS-style J&F (region Jaccard + boundary F-measure) evaluator.

A copy of deva_tpu/metrics/jf.py (host-only code: the port imports nothing
of deva_tpu, whose package import loads jax). scipy and PIL are imported
inside the functions that dilate boundaries and decode files.

The reference repo defers J&F to external evaluator repos
(reference:docs/EVALUATION.md:39-44 points at davis2017-evaluation /
vos-benchmark); deva_tpu ships the metric natively so a propagation run can
be scored end-to-end in-repo. Definitions follow the published DAVIS
benchmark protocol (Perazzi et al., CVPR 2016; Pont-Tuset et al.,
arXiv:1704.00675):

- J = per-frame per-object intersection-over-union of the binary masks.
- F = per-frame per-object boundary F-measure: boundary pixels of the
  prediction and ground truth are matched within a tolerance of
  ceil(0.008 * image diagonal) pixels (disk dilation); F is the harmonic
  mean of boundary precision and recall.
- Per-object statistics over the evaluated frames: mean, recall
  (fraction of frames above 0.5), and decay (mean over the first quarter
  of frames minus mean over the last quarter).
- Semi-supervised protocol: the first frame (given annotation) and the
  last frame are excluded from scoring; label 255 in the ground truth is
  void and excluded from both masks.

All heavy per-frame work is vectorized numpy + scipy.ndimage on the host
(this is an offline scoring tool; the device stays on the inference path).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from math import ceil, sqrt
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------- region J

def jaccard(pred: np.ndarray, gt: np.ndarray,
            void: Optional[np.ndarray] = None) -> float:
    """IoU of two binary masks; both-empty scores 1.0 (benchmark convention).

    `void` pixels are excluded from both masks before scoring.
    """
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    if void is not None:
        keep = ~void.astype(bool)
        pred = pred & keep
        gt = gt & keep
    union = np.count_nonzero(pred | gt)
    if union == 0:
        return 1.0
    return np.count_nonzero(pred & gt) / union


# -------------------------------------------------------------- boundary F

def _boundary_map(seg: np.ndarray) -> np.ndarray:
    """Pixels whose value differs from their east/south/southeast neighbour
    (the standard seg2bmap discretization of the region boundary, with the
    image border counted for foreground touching it)."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    # at the image border the out-of-frame neighbour is background, so a
    # foreground pixel on the border is boundary
    b[-1, :] |= seg[-1, :]
    b[:, -1] |= seg[:, -1]
    return b


def _disk(radius: int) -> np.ndarray:
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y) <= radius * radius


def f_boundary(pred: np.ndarray, gt: np.ndarray,
               bound_th: float = 0.008) -> float:
    """Boundary F-measure with a disk matching tolerance of
    ceil(bound_th * image diagonal) pixels."""
    from scipy.ndimage import binary_dilation

    pred = pred.astype(bool)
    gt = gt.astype(bool)
    h, w = gt.shape
    bound_pix = int(ceil(bound_th * sqrt(h * h + w * w)))

    fg_b = _boundary_map(pred)
    gt_b = _boundary_map(gt)
    n_fg = np.count_nonzero(fg_b)
    n_gt = np.count_nonzero(gt_b)
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0

    selem = _disk(bound_pix)
    fg_dil = binary_dilation(fg_b, selem)
    gt_dil = binary_dilation(gt_b, selem)
    precision = np.count_nonzero(fg_b & gt_dil) / n_fg
    recall = np.count_nonzero(gt_b & fg_dil) / n_gt
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


# --------------------------------------------------------------- statistics

def _statistics(per_frame: np.ndarray) -> Tuple[float, float, float]:
    """(mean, recall, decay) over one object's per-frame scores, per the
    benchmark: recall = fraction above 0.5; decay = mean of the first
    quarter minus mean of the last quarter (4 bins)."""
    per_frame = np.asarray(per_frame, np.float64)
    mean = float(per_frame.mean()) if per_frame.size else 0.0
    rec = float((per_frame > 0.5).mean()) if per_frame.size else 0.0
    n = per_frame.size
    if n < 4:
        decay = 0.0
    else:
        ids = np.round(np.linspace(1, n, 5)).astype(int) - 1
        bins = [per_frame[ids[i]:ids[i + 1] + 1] for i in range(4)]
        decay = float(np.nanmean(bins[0]) - np.nanmean(bins[3]))
    return mean, rec, decay


@dataclass
class SequenceResult:
    name: str
    object_ids: List[int] = field(default_factory=list)
    j_per_object: Dict[int, np.ndarray] = field(default_factory=dict)
    f_per_object: Dict[int, np.ndarray] = field(default_factory=dict)

    def summary(self) -> Dict[str, float]:
        j_means = [float(v.mean()) for v in self.j_per_object.values()]
        f_means = [float(v.mean()) for v in self.f_per_object.values()]
        jm = float(np.mean(j_means)) if j_means else 0.0
        fm = float(np.mean(f_means)) if f_means else 0.0
        return {"J_mean": jm, "F_mean": fm, "JF": (jm + fm) / 2}


def evaluate_masks(pred_frames: Sequence[np.ndarray],
                   gt_frames: Sequence[np.ndarray],
                   name: str = "",
                   skip_first_last: bool = True,
                   bound_th: float = 0.008) -> SequenceResult:
    """Score one sequence from in-memory label maps (integer ids; 255 in the
    ground truth is void). Object ids are taken from the ground truth over
    the whole sequence (the semi-supervised protocol: every annotated object
    exists from some frame on; absent-in-frame objects score against empty
    masks)."""
    assert len(pred_frames) == len(gt_frames), \
        (len(pred_frames), len(gt_frames))
    gt_frames = [np.asarray(g) for g in gt_frames]
    pred_frames = [np.asarray(p) for p in pred_frames]
    if skip_first_last and len(gt_frames) > 2:
        gt_frames = gt_frames[1:-1]
        pred_frames = pred_frames[1:-1]

    obj_ids = sorted({int(i) for g in gt_frames for i in np.unique(g)}
                     - {0, 255})
    res = SequenceResult(name=name, object_ids=obj_ids)
    n = len(gt_frames)
    for oid in obj_ids:
        js = np.empty(n)
        fs = np.empty(n)
        for t, (p, g) in enumerate(zip(pred_frames, gt_frames)):
            void = (g == 255)
            pm = (p == oid) & ~void
            gm = (g == oid)
            js[t] = jaccard(pm, gm)
            fs[t] = f_boundary(pm, gm, bound_th=bound_th)
        res.j_per_object[oid] = js
        res.f_per_object[oid] = fs
    return res


# ------------------------------------------------------------- directory IO

def _read_label_png(path: str) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    if img.mode not in ("P", "L"):
        img = img.convert("P")
    return np.asarray(img, dtype=np.uint8)


def evaluate_sequence_dirs(pred_dir: str, gt_dir: str, name: str = "",
                           bound_th: float = 0.008) -> SequenceResult:
    """Score a sequence from two directories of palette PNG label maps
    (prediction frames matched to ground-truth frames by filename)."""
    gt_files = sorted(f for f in os.listdir(gt_dir) if f.endswith(".png"))
    if not gt_files:
        raise FileNotFoundError(f"no ground-truth PNGs in {gt_dir}")
    preds, gts = [], []
    for fname in gt_files:
        ppath = os.path.join(pred_dir, fname)
        gt = _read_label_png(os.path.join(gt_dir, fname))
        if os.path.exists(ppath):
            pred = _read_label_png(ppath)
        else:  # missing prediction scores as empty
            pred = np.zeros_like(gt)
        preds.append(pred)
        gts.append(gt)
    return evaluate_masks(preds, gts, name=name or os.path.basename(gt_dir),
                          bound_th=bound_th)


def aggregate(results: Sequence[SequenceResult]) -> Dict[str, float]:
    """Global table over sequences: per-object mean/recall/decay averaged
    over all (sequence, object) pairs — the davis2017-evaluation convention."""
    j_stats, f_stats = [], []
    for r in results:
        for oid in r.object_ids:
            j_stats.append(_statistics(r.j_per_object[oid]))
            f_stats.append(_statistics(r.f_per_object[oid]))
    if not j_stats:
        return {k: 0.0 for k in ("J&F", "J_mean", "J_recall", "J_decay",
                                 "F_mean", "F_recall", "F_decay")}
    j = np.asarray(j_stats)
    f = np.asarray(f_stats)
    out = {
        "J_mean": float(j[:, 0].mean()),
        "J_recall": float(j[:, 1].mean()),
        "J_decay": float(j[:, 2].mean()),
        "F_mean": float(f[:, 0].mean()),
        "F_recall": float(f[:, 1].mean()),
        "F_decay": float(f[:, 2].mean()),
    }
    out["J&F"] = (out["J_mean"] + out["F_mean"]) / 2
    return out
