"""The readings that set a cell's correctness limits (not part of a run).

    python3 perfbench/readings.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,...]

For each seed, in one process: the cell's inputs and weights, the window's
first group through the timed path (the same calls, its outputs kept as a
run keeps them), then the compared number of the program and, for the
control seeds, of the control (the reference one precision step below the
configuration's, put in the program's place; reference/vos_check.py). One
JSON line per seed; `--series` also writes each frame's gaps. The limits in
the configurations' files lie between the program's largest and the
control's smallest reading (PERF.md).
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import manifest  # noqa: E402
from harness.cli import cache_env  # noqa: E402


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--series", default="",
                   help="a file for each frame's gaps (mean, median, max)")
    args = p.parse_args(argv)
    cache_env()
    import torch

    from harness.trace import Tracer
    from harness.batched_vos import BatchedVOS, run_group
    from reference import vos_check

    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)  # as run.py
    device = torch.device("cuda", 0)
    cell = manifest.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        drv = BatchedVOS(cell, seed, device, Tracer(False))
        run_group(drv.propagator, drv.net, drv.infer_cfg, drv.block,
                  drv.first, drv.inputs, drv.tracer, None, drv.keep)
        drv.free()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kept = drv.keep.outputs()
        lanes = sorted(kept)
        norm = cell.config["check"]["normaliser"]
        candidates = {"program": kept}
        for v in [norm] + (["control"] if seed in controls else []):
            candidates[v] = vos_check.outputs(
                cell.config, drv.first, lanes, drv.inputs, drv.weights,
                device, v)
        series = vos_check.gaps(cell.config, drv.first, candidates,
                                drv.inputs, drv.weights, device)
        line = {"workload": cell.name, "seed": seed, "lanes": lanes,
                "seconds": time.perf_counter() - t0}
        for k in ("program", "control"):
            if k in series:
                line[k] = {**vos_check.compared(series[k], series[norm]),
                           **vos_check.summary(series[k])}
        print(json.dumps(line), flush=True)
        if args.series:
            with open(args.series, "a") as f:
                f.write(json.dumps({"seed": seed, **series}) + "\n")
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
