"""Nothing of the benchmark loads JAX or the JAX package, and it reads no
file of the JAX package's benchmark."""
import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT
from harness.guard import FORBIDDEN, forbidden_modules


def test_forbidden_names_compare_top_level_names_whole():
    assert forbidden_modules(["jax.numpy", "os", "flax.linen"]) == \
        ["flax", "jax"]
    assert forbidden_modules(["deva_tpu.ops", "deva_tpu_torch.ops"]) == \
        ["deva_tpu"]
    assert forbidden_modules(["jaxlib.xla_client"]) == ["jaxlib"]
    assert forbidden_modules(["deva_tpu_torch", "jaxtyping", "flaxen"]) == []


def _sources():
    for base, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = forbidden_modules(names)
            assert not bad, f"{path} imports {bad}"


def test_no_source_names_the_jax_benchmark_files():
    for path in _sources():
        if os.path.basename(path) == "test_perfbench_guard.py":
            continue
        text = open(path).read()
        for name in ("bench.py", "BENCH_r0", "BASELINE.json",
                     "MULTICHIP_r0"):
            assert name not in text, f"{path} names {name}"


def test_a_run_loads_no_forbidden_module():
    """A CPU run of a cell cut small, in a process of its own: the modules
    loaded once it is done hold none of the forbidden names."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import time, torch\n"
        "torch.set_num_threads(2)\n"
        "from conftest import tiny_cell\n"
        "from harness import cli\n"
        "from harness.guard import forbidden_modules\n"
        "res = cli.run(tiny_cell('vos-f32-b4', lengths=[3, 4, 4, 5]),"
        " 5, 0.1, False, torch.device('cpu'), time.perf_counter())\n"
        "assert res['correct'], res\n"
        "print('FOUND', forbidden_modules())\n"
        % (os.path.join(BENCH, "tests"), BENCH))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
    assert FORBIDDEN == {"jax", "jaxlib", "flax", "deva_tpu"}
