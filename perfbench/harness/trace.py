"""Spans, counters and the device trace of a `--trace 1` run.

In a traced run the benchmark puts a `torch.profiler.record_function` range
(a span) around each call into a layer of the port: the driver's step, the
four model modes, the attention, each hand-written kernel's launch, the
detection fusion's vote and merge. The port itself is not edited: the
spans wrap its methods on the objects the run holds (or on its classes, in
this process). Each span also sums its host time and calls. Each kernel
launch records its shapes and, on the device and without a host
synchronisation, the counts its roofline needs (valid tokens, distinct
value rows, the threshold's support); that counting runs inside a range
"pb.count" whose device time is left out of the busy time.

After the window, `record()` reduces the profiler's events to a dict that
the per-layer readers (perfbench/metrics/*.py) take:
  window_s, busy_s     the traced window and the union of device activity
  frames               frames completed in the window
  kernel_s[span]       device seconds of the kernels launched inside span
  host_s[span], calls[span]  host seconds and calls of span
  launches[kernel]     one dict of counts per launch
  flops                operations of the convolutions and dense layers
  peak_flops           the compute dtype's dense peak
  device_ops, idle_gaps  the breakdown

A kernel belongs to a span when the host operation that launched it (its
linked correlation in the trace) started inside that span. In an untraced
run none of this is installed.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

COUNT = "pb.count"
MODES = ("encode_image", "transform_key", "encode_mask", "segment")


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.host_s: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.launches: Dict[str, List[dict]] = defaultdict(list)
        self._pending: List[tuple] = []  # (launch dict, key, device tensor)
        self.flops = 0  # operations of the hooked layers' calls
        self.prof = None

    # -- spans ----------------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.host_s[name] += time.perf_counter() - t0
        self.calls[name] += 1

    def wrap(self, owner, attr: str, name: str, on_call=None):
        """Replace owner.attr (a method of an instance or a class, or a
        function of a module) by itself inside span `name`; on_call(args,
        kwargs, result) runs after each call, inside the span."""
        if not self.enabled:
            return
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self.span(name):
                out = fn(*args, **kwargs)
                if on_call is not None:
                    on_call(args, kwargs, out)
            return out

        setattr(owner, attr, wrapped)

    # -- counters ---------------------------------------------------------------

    def count_on_device(self, launch: dict, key: str, fn) -> None:
        """launch[key] = fn() (a device scalar), taken inside "pb.count" and
        read after the window."""
        with torch.profiler.record_function(COUNT):
            self._pending.append((launch, key, fn()))

    def flops_hook(self, module, args, out) -> None:
        x = out if torch.is_tensor(out) else out[0]
        if isinstance(module, torch.nn.Conv2d):
            k = module.weight.shape[1] * module.weight[0, 0].numel()
        else:
            k = module.in_features
        self.flops += 2 * x.numel() * k

    def resolve(self) -> None:
        """Read the device counters (after the window's synchronisation)."""
        for launch, key, value in self._pending:
            launch[key] = int(value.item())
        self._pending.clear()

    # -- the profiler ---------------------------------------------------------

    def start(self) -> None:
        """Forget what warm-up recorded and start the profiler: the
        window begins."""
        self.host_s.clear()
        self.calls.clear()
        self.launches.clear()
        self._pending.clear()
        self.flops = 0
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def record(self, window_s: float, frames: int, peak_flops: float) -> dict:
        self.resolve()
        rec = {"window_s": window_s, "frames": frames,
               "host_s": dict(self.host_s), "calls": dict(self.calls),
               "launches": {k: list(v) for k, v in self.launches.items()},
               "flops": float(self.flops), "peak_flops": peak_flops}
        rec.update(read_events(self.prof.profiler.kineto_results.events()))
        return rec


# ----------------------------------------------------------------------------
# the profiler's events
# ----------------------------------------------------------------------------

def _merge(intervals):
    """Sorted, disjoint unions of [start, end) intervals: (starts, ends)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    arr = np.asarray(out, dtype=np.int64).reshape(-1, 2)
    return arr[:, 0], arr[:, 1]


def _inside(times: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Which of `times` fall in one of the disjoint [start, end] intervals."""
    if len(starts) == 0:
        return np.zeros(len(times), bool)
    i = np.searchsorted(starts, times, side="right") - 1
    ok = i >= 0
    return ok & (times <= ends[np.clip(i, 0, None)])


def _is_device(event) -> bool:
    return str(event.device_type()).endswith("CUDA")


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu") and
                                       name[2:3].isupper())


def read_events(events) -> dict:
    """Busy time, kernel time per span, the top device operations and the
    idle gaps labelled by the span the host was in, from the profiler's
    raw events. A device operation's host time is that of the CUDA runtime
    call that launched it (the same correlation id), else that of the
    operator it is linked to."""
    spans = defaultdict(list)     # name -> [(start, end)] on the host
    op_start = {}                 # operator id -> host start
    runtime_start = {}            # runtime call's correlation id -> start
    dev = []                      # (start, end, name, correlation, linked)
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if _is_device(e):
            if name.startswith("pb."):
                continue  # the span's own projection onto the device
            dev.append((start, end, name, e.correlation_id(),
                        e.linked_correlation_id()))
        elif _is_runtime(name):
            runtime_start[e.correlation_id()] = start
        else:
            op_start[e.correlation_id()] = start
            if name.startswith("pb."):
                spans[name].append((start, end))
    if not dev:
        return {"busy_s": 0.0, "kernel_s": {}, "device_ops": [],
                "idle_gaps": [], "unlinked": 0, "by_runtime": 0,
                "device_events": 0}
    starts = np.asarray([d[0] for d in dev], np.int64)
    ends = np.asarray([d[1] for d in dev], np.int64)
    by_runtime = np.asarray([d[3] in runtime_start for d in dev])
    launched = np.asarray([runtime_start.get(d[3], op_start.get(d[4], -1))
                           for d in dev], np.int64)
    merged = {name: _merge(iv) for name, iv in spans.items()}
    counted = _inside(launched, *merged[COUNT]) if COUNT in merged else \
        np.zeros(len(dev), bool)
    keep = ~counted
    dur = (ends - starts) / 1e9
    kernel_s = {name: float(dur[keep & _inside(launched, *iv)].sum())
                for name, iv in merged.items() if name != COUNT}
    b_starts, b_ends = _merge(zip(starts[keep], ends[keep]))
    busy_s = float((b_ends - b_starts).sum()) / 1e9

    by_name = defaultdict(float)
    for (s, e, name, _, _), k in zip(dev, keep):
        if k:
            by_name[name[:96]] += (e - s) / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps between device activity, labelled by the innermost span
    # the host was in when the gap began (the shortest one holding it)
    gap_s = (b_starts[1:] - b_ends[:-1]) / 1e9
    gap_at = b_ends[:-1]
    label = np.full(len(gap_at), "host", dtype=object)
    width = np.full(len(gap_at), np.iinfo(np.int64).max, np.int64)
    for name, (s, e) in merged.items():
        if name == COUNT or not len(s):
            continue
        i = np.clip(np.searchsorted(s, gap_at, side="right") - 1, 0, None)
        inside = (gap_at >= s[i]) & (gap_at <= e[i])
        narrower = inside & (e[i] - s[i] < width)
        label[narrower] = name
        width[narrower] = (e[i] - s[i])[narrower]
    idle = defaultdict(float)
    for name, s in zip(label, gap_s):
        idle[name] += float(s)
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "kernel_s": kernel_s,
            "device_ops": [[n, float(s)] for n, s in device_ops],
            "idle_gaps": [[n, float(s)] for n, s in idle_gaps],
            "unlinked": int((launched < 0).sum()),
            "by_runtime": int(by_runtime.sum()), "device_events": len(dev)}
