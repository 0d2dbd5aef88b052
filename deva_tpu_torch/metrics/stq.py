"""Segmentation and Tracking Quality (STQ), numpy.

A copy of deva_tpu/metrics/stq.py
(host-only code: the port imports nothing of deva_tpu, whose package
import loads jax).

Semantics anchor: the deeplab2 STQ metric as vendored at
reference:deva/vps_metrics/segmentation_and_tracking_quality.py:40-299
("STEP: Segmenting and Tracking Every Pixel", arXiv:2102.11859):
  STQ = sqrt(AQ * IoU)
  AQ: per-gt-tube weighted IoU of overlapping prediction tubes
  IoU: semantic mIoU from a per-sequence confusion matrix
Panoptic labels are (semantic << label_bit_shift) + instance.

This implementation accumulates the same statistics but computes AQ from the
intersection table directly (one pass over intersecting (gt, pred) pairs)
instead of the reference's |gt|x|pred| double loop.
"""
from __future__ import annotations

import collections
from typing import Any, Mapping, Sequence

import numpy as np

_EPS = 1e-15


class STQuality:
    def __init__(self, num_classes: int, things_list: Sequence[int],
                 ignore_label: int, label_bit_shift: int, offset: int):
        self.num_classes = num_classes
        self.things_list = np.asarray(list(things_list), np.int64)
        self.ignore_label = ignore_label
        self.bit_shift = label_bit_shift
        self.bit_mask = (1 << label_bit_shift) - 1
        self.offset = offset
        if offset < (num_classes << label_bit_shift):
            raise ValueError("offset too small for num_classes << bit_shift")

        if ignore_label >= num_classes:
            self.cm_size = num_classes + 1
            self.include = np.arange(num_classes)
        else:
            self.cm_size = num_classes
            self.include = np.array(
                [i for i in range(num_classes) if i != ignore_label])

        self._cm = collections.OrderedDict()
        self._pred_sizes = collections.OrderedDict()
        self._gt_sizes = collections.OrderedDict()
        self._intersections = collections.OrderedDict()
        self._seq_len = collections.OrderedDict()

    def update_state(self, y_true: np.ndarray, y_pred: np.ndarray,
                     sequence_id=0) -> None:
        y_true = y_true.astype(np.int64).ravel()
        y_pred = y_pred.astype(np.int64).ravel()
        sem_t = y_true >> self.bit_shift
        sem_p = y_pred >> self.bit_shift
        if self.ignore_label > self.num_classes:
            sem_t = np.where(sem_t == self.ignore_label, self.num_classes,
                             sem_t)
            sem_p = np.where(sem_p == self.ignore_label, self.num_classes,
                             sem_p)

        if sequence_id not in self._cm:
            self._cm[sequence_id] = np.zeros((self.cm_size, self.cm_size),
                                             np.int64)
            self._pred_sizes[sequence_id] = {}
            self._gt_sizes[sequence_id] = {}
            self._intersections[sequence_id] = {}
            self._seq_len[sequence_id] = 0
        self._seq_len[sequence_id] += 1
        np.add.at(self._cm[sequence_id], (sem_t, sem_p), 1)

        inst_t = y_true & self.bit_mask
        gt_thing = np.isin(sem_t, self.things_list)
        pred_thing = np.isin(sem_p, self.things_list)
        # crowd: things with instance id 0 — excluded from gt, and predictions
        # there are not punished
        is_crowd = gt_thing & (inst_t == 0)
        gt_thing &= ~is_crowd
        pred_thing &= ~is_crowd

        def bump(d, arr):
            ids, cnt = np.unique(arr, return_counts=True)
            for i, c in zip(ids.tolist(), cnt.tolist()):
                d[i] = d.get(i, 0) + c

        bump(self._pred_sizes[sequence_id], y_pred[pred_thing])
        bump(self._gt_sizes[sequence_id], y_true[gt_thing])
        both = gt_thing & pred_thing
        bump(self._intersections[sequence_id],
             y_true[both] * self.offset + y_pred[both])

    def result(self) -> Mapping[str, Any]:
        n_seq = len(self._gt_sizes)
        aq_sums = np.zeros(n_seq)
        n_tubes = np.zeros(n_seq)
        iou_per_seq = np.zeros(n_seq)
        ids = []
        total_cm = np.zeros((self.cm_size, self.cm_size), np.int64)

        for idx, seq in enumerate(self._gt_sizes):
            ids.append(seq)
            gt_sizes = self._gt_sizes[seq]
            pred_sizes = self._pred_sizes[seq]
            n_tubes[idx] = len(gt_sizes)
            per_gt = collections.defaultdict(float)
            for key, tpa in self._intersections[seq].items():
                gt_id, pr_id = key // self.offset, key % self.offset
                union = gt_sizes[gt_id] + pred_sizes[pr_id] - tpa
                per_gt[gt_id] += tpa * (tpa / union)
            aq_sums[idx] = sum(v / gt_sizes[g] for g, v in per_gt.items())

            cm = self._cm[seq].copy()
            keep = np.zeros_like(cm)
            keep[self.include, :] = 1
            cm *= keep
            total_cm += cm
            inter = cm.diagonal()
            union = cm.sum(0) + cm.sum(1) - inter  # inter + fps + fns
            nc = np.count_nonzero(union)
            iou_per_seq[idx] = (inter / np.maximum(union, _EPS)).sum() / nc

        aq_mean = aq_sums.sum() / max(n_tubes.sum(), _EPS)
        aq_per_seq = aq_sums / np.maximum(n_tubes, _EPS)

        inter = total_cm.diagonal()
        union = total_cm.sum(0) + total_cm.sum(1) - inter
        nc = np.count_nonzero(union)
        iou_mean = (inter / np.maximum(union, _EPS)).sum() / nc

        return {
            "STQ": float(np.sqrt(aq_mean * iou_mean)),
            "AQ": float(aq_mean),
            "IoU": float(iou_mean),
            "STQ_per_seq": np.sqrt(aq_per_seq * iou_per_seq),
            "AQ_per_seq": aq_per_seq,
            "IoU_per_seq": iou_per_seq,
            "ID_per_seq": ids,
            "Length_per_seq": list(self._seq_len.values()),
        }

    def reset_states(self) -> None:
        self.__init__(self.num_classes, self.things_list.tolist(),
                      self.ignore_label, self.bit_shift, self.offset)
