"""Benchmark of deva_tpu_torch on one NVIDIA GPU: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cells, configurations and metrics are in
BENCHMARK.json; perfbench/README.md says how a run goes and how to add a
cell. The last line of standard output is the run's result (one JSON
object); the numbers compared for `correct` end standard error.
"""
import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# the harness's packages, then the checkout's root, which holds the program
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
