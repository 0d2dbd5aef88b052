"""Tensorboard logging and metric accumulation.

A copy of deva_tpu/utils/logger.py (reference:deva/utils/logger.py:25-111
and reference:deva/utils/log_integrator.py:11-80), with tensorboardX
imported only when a run logs (the card's machine has none). One change:
the Integrator keeps its sums as the tensors it is given, on their device,
and reads them once at finalize, so a train step's metrics are not waited
for on every iteration. Under DDP the trainer hands it metrics that are
already the mean over ranks.
"""
from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional

import numpy as np
import torch


class TensorboardLogger:
    def __init__(self, short_id: Optional[str], long_id: Optional[str],
                 log_dir: str = ".runs"):
        self.short_id = short_id
        self.no_log = (long_id is None) or (short_id in (None, "NULL"))
        if self.no_log:
            print("Logging has been disabled.")
            self.writer = None
            return
        from tensorboardX import SummaryWriter
        self.writer = SummaryWriter(os.path.join(log_dir, long_id))
        self._stamp_git()

    def _stamp_git(self) -> None:
        try:
            info = subprocess.check_output(
                ["git", "log", "-1", "--format=%H %ci %s"],
                stderr=subprocess.DEVNULL).decode().strip()
            self.log_string("git", info)
        except (OSError, subprocess.CalledProcessError):
            self.log_string("git", "unknown")

    def log_scalar(self, tag: str, x, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, float(x), step)

    def log_metrics(self, l1_tag: str, l2_tag: str, val, step: int) -> None:
        tag = f"{l1_tag}/{l2_tag}"
        print(f"{self.short_id} - it {step:6d} {tag} {float(val):.6g}")
        self.log_scalar(tag, val, step)

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        if self.writer is not None:
            self.writer.add_image(tag, image, step, dataformats="HWC")

    def log_string(self, tag: str, x: str) -> None:
        print(tag, x)
        if self.writer is not None:
            self.writer.add_text(tag, x)


class Integrator:
    """Accumulates per-iteration metric dicts and averages on finalize.
    reference:deva/utils/log_integrator.py:11-80."""

    def __init__(self, logger: Optional[TensorboardLogger]):
        self.values: Dict = {}
        self.counts: Dict[str, int] = {}
        self.hooks = []
        self.logger = logger

    def add_dict(self, tensor_dict: Dict) -> None:
        for k, v in tensor_dict.items():
            self.add_tensor(k, v)

    def add_tensor(self, key: str, tensor) -> None:
        val = tensor.detach() if isinstance(tensor, torch.Tensor) \
            else float(tensor)
        self.values[key] = self.values.get(key, 0.0) + val
        self.counts[key] = self.counts.get(key, 0) + 1

    def add_hook(self, hook) -> None:
        self.hooks.append(hook)

    def finalize(self, prefix: str, it: int) -> None:
        for k in sorted(self.values):
            avg = float(self.values[k]) / self.counts[k]
            if self.logger is not None:
                self.logger.log_metrics(prefix, k, avg, it)
        for hook in self.hooks:
            hook(self, prefix, it)

    def reset_except_hooks(self) -> None:
        self.values = {}
        self.counts = {}
