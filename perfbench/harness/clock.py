"""The measured window and the per-frame latencies."""
from __future__ import annotations

import statistics
import time
from typing import List

import torch


class Stopwatch:
    """Milliseconds from start() to the completion on the device of the
    work enqueued before stop(): CUDA events on a card (the stream is idle
    at start(), so its event marks the call), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, token) -> float:
        if not self.cuda:
            return (time.perf_counter() - token) * 1e3
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        return token.elapsed_time(ev)


class Window:
    """Frames completed in the window and the latency of each."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.frames = 0
        self.latency_ms: List[float] = []
        # for the run's diagnostics on standard error: each call's latency
        # and the host clock at its completion, and the end of each pass
        self.call_ms: List[float] = []
        self.stamps: List[float] = []
        self.pass_ends: List[float] = []
        self.t0 = self.t1 = None

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def expired(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds

    def done(self, n_frames: int, ms: float) -> None:
        """n_frames completed, each `ms` after it was handed to the port."""
        self.frames += n_frames
        self.latency_ms.extend([ms] * n_frames)
        self.call_ms.append(ms)
        self.stamps.append(time.perf_counter())

    def end_pass(self) -> None:
        self.pass_ends.append(time.perf_counter())

    def close(self) -> float:
        self.t1 = time.perf_counter()
        return self.t1 - self.t0

    def diagnostics(self) -> str:
        """Where the window's time went, on the host's clock: the calls'
        summed latency against the window, each pass's seconds, and the
        longest spans between two completions (a stall of the host shows
        there)."""
        ends = [self.t0] + self.pass_ends
        gaps = sorted((b - a for a, b in
                       zip([self.t0] + self.stamps, self.stamps)),
                      reverse=True)
        return (f"calls {len(self.call_ms)}, their latency "
                f"{sum(self.call_ms) / 1e3:.3f} s of {self.t1 - self.t0:.3f};"
                f" passes {[round(b - a, 3) for a, b in zip(ends, ends[1:])]}"
                f" s; longest spans between completions "
                f"{[round(g * 1e3, 1) for g in gaps[:5]]} ms, median "
                f"{statistics.median(gaps) * 1e3:.1f}; longest calls "
                f"{[round(m, 1) for m in sorted(self.call_ms)[-5:]]} ms")
