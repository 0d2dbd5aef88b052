"""One run of one cell: set-up, the measured window, the check, the result.

    run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed from the process's start, `setup_s`): the inputs and weights
drawn from the seed on the card, the port's model, the kernels (built into
deva_tpu_torch/_build/ by the first run in a checkout, loaded after), and a
warm-up of every shape the cell uses. The window then drives the port for
`--seconds`. After it closes the peak memory is read, the program's state
freed, and the reference run over a sample of the window's outputs
(reference/). With `--trace 1` the port's calls carry spans and the window
runs under the profiler; that run reports the per-layer metrics, the
untraced one the end-to-end metrics.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

from harness import manifest
from harness.guard import forbidden_modules

def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env() -> None:
    """Every cache a run may write, inside the checkout at a fixed path."""
    cache = os.path.join(manifest.ROOT, "_bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"  # transformers, if loaded, loads no JAX


def p95(values):
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def per_layer(cell, record) -> dict:
    out = {}
    for m in cell.per_layer:
        value = manifest.metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        driver_cls=None) -> dict:
    """The run's result line (a dict). The cell's driver is the class
    `Driver` of the module harness/<traffic's "driver">.py; driver_cls
    replaces it (the tests plant faults through it)."""
    import importlib

    import torch

    from harness.clock import Window
    from harness.trace import Tracer

    cuda = device.type == "cuda"
    if driver_cls is None:
        driver_cls = importlib.import_module(
            "harness." + cell.traffic["driver"]).Driver
    tracer = Tracer(trace)
    t_made = time.perf_counter()
    drv = driver_cls(cell, seed, device, tracer)
    if cuda:
        torch.cuda.synchronize()
        # the program's peak: from its model on, the benchmark's own input
        # and weight drawing left out
        torch.cuda.reset_peak_memory_stats(device)
    t_warm = time.perf_counter()
    drv.warm_up()
    if cuda:
        torch.cuda.synchronize()
    window = Window(seconds)
    setup_s = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s: start-up and imports "
          f"{t_made - t0:.3f}, inputs, weights and model "
          f"{t_warm - t_made:.3f}, warm-up {t0 + setup_s - t_warm:.3f}",
          file=sys.stderr)
    # the set-up's objects out of the collector's way, so that a collection
    # in the window scans only what the window makes
    gc.collect()
    gc.freeze()
    tracer.start()
    window.start()
    drv.measure(window)
    if cuda:
        torch.cuda.synchronize()
    window_s = window.close()
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    lat = window.latency_ms
    print(f"frames {window.frames} in {window_s:.3f} s; frame latency "
          f"median {statistics.median(lat):.3f} ms, p95 {p95(lat):.3f} ms "
          f"over {len(lat)} frames", file=sys.stderr)
    print(window.diagnostics(), file=sys.stderr)
    result = {"correct": False, "attempted": window.frames, "failed": 0}
    if trace:
        peak_flops = manifest.peaks()[cell.config["model"]["dtype"]]
        record = tracer.record(window_s, window.frames, peak_flops)
        print(f"card: {power_limit()}; trace: {record['device_events']} "
              f"device operations, {record['by_runtime']} placed by their "
              f"runtime call, {record['unlinked']} without a host link; "
              f"kernel s by span {record['kernel_s']}", file=sys.stderr)
        result["metrics"] = per_layer(cell, record)
    else:
        record = None
        e2e = {"frames_per_s": window.frames / window_s,
               "frame_ms_p95": p95(lat), "peak_mem_gib": peak / 2 ** 30,
               "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if record is not None:
        result["device"]["busy_s"] = record["busy_s"]
        result["device"]["window_s"] = record["window_s"]
        result["breakdown"] = {"device_ops": record["device_ops"],
                               "idle_gaps": record["idle_gaps"]}

    drv.free()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drv.check()
    print(f"check numbers: {numbers}", file=sys.stderr)
    limits = cell.config["limits"]
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in limits.items()}
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks  # last: the numbers compared, with limits
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return result


def main(argv, t0: float) -> int:
    args = parse(argv)
    cache_env()
    cell = manifest.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one host thread for PyTorch's CPU operators: a pool of spinning
    # workers beside the thread that launches the card's work makes a
    # host-bound cell's runs spread
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0
