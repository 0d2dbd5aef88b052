"""Shared set-up of the benchmark's tests: the harness's packages and the
checkout's root on sys.path, a card fixture, and a cell cut to a size a CPU
test can hold."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    """The CUDA device, with TF32 off; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def tiny_cell(name: str, lengths=(4, 6, 8, 10), objects: int = 2,
              **traffic):
    """The cell `name` of BENCHMARK.json at 64x112, its mix cut to one group
    of short videos of `objects` objects each."""
    from harness import manifest
    cell = manifest.load_cell(name)
    cell.traffic.update(dict(
        height=64, width=112, warmup_length=5,
        videos=[[f"v{i}", n, objects] for i, n in enumerate(lengths)]),
        **traffic)
    return cell
