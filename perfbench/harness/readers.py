"""Arithmetic the per-layer readers (perfbench/metrics/*.py) share. Each
returns None where the record holds nothing to read."""
from __future__ import annotations

from harness import manifest
from harness.trace import MODES


def kernel_ms_per_frame(record: dict, spans) -> object:
    """Device ms of the kernels launched inside any of `spans`, per frame
    completed in the window."""
    found = [record["kernel_s"][s] for s in spans if s in record["kernel_s"]]
    if not found or not record["frames"]:
        return None
    return 1e3 * sum(found) / record["frames"]


def host_ms_per(record: dict, span: str, per: str) -> object:
    """Host ms inside `span`, per frame (per="frame") or per call."""
    if span not in record["host_s"]:
        return None
    n = record["frames"] if per == "frame" else record["calls"][span]
    return 1e3 * record["host_s"][span] / n if n else None


def roofline_pct(record: dict, kernel: str) -> object:
    """The sum over the window's launches of the kernel's bound (the larger
    of its operations over the f32 peak and its bytes over the HBM
    bandwidth) over the kernel's device time, in percent."""
    launches = record["launches"].get(kernel)
    t = record["kernel_s"].get("pb.kernel." + kernel)
    if not launches or not t:
        return None
    peaks = manifest.peaks()
    cost = manifest.roofline(kernel).cost
    bound = sum(max(f / peaks["float32"], b / peaks["hbm_bytes_per_s"])
                for f, b in map(cost, launches))
    return 100.0 * bound / t


def step_flops(record: dict) -> float:
    """The window's operations: every convolution and dense layer of the
    model (counted from shapes) and every attention kernel launch."""
    total = record["flops"]
    for kernel, launches in record["launches"].items():
        cost = manifest.roofline(kernel).cost
        total += sum(cost(l)[0] for l in launches)
    return total


MODE_SPANS = tuple("pb.mode." + m for m in MODES)
