"""deva_tpu_torch/metrics/jf.py against deva_tpu/metrics/jf.py on
tests/test_jf.py's cases, and evaluation/eval_jf_torch.py against
evaluation/eval_jf.py. The port's scorer is a copy (numpy, scipy, PIL), so
every number must be equal, not merely close; the CSV files equal byte for
byte."""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import deva_tpu.metrics.jf as jax_jf

import deva_tpu_torch.metrics.jf as jf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _squares():
    a = np.zeros((10, 10), bool)
    b = np.zeros((10, 10), bool)
    a[2:6, 2:6] = True
    b[4:8, 2:6] = True
    return a, b


def _jaccard(m):
    a, b = _squares()
    void = np.zeros((10, 10), bool)
    void[0:3] = True
    return [m.jaccard(a, a), m.jaccard(a, ~a), m.jaccard(a, b),
            m.jaccard(a, b, void=void), m.jaccard(b & False, b & False)]


def _boundary_map(m):
    seg = np.zeros((8, 8), bool)
    seg[2:6, 2:6] = True
    return m._boundary_map(seg)


def _f_boundary(m):
    a = np.zeros((64, 64), bool)
    a[10:30, 10:30] = True
    empty = np.zeros_like(a)
    return [m.f_boundary(a, a), m.f_boundary(a, np.roll(a, 1, axis=0)),
            m.f_boundary(a, np.roll(a, 5, axis=0)), m.f_boundary(a, empty),
            m.f_boundary(empty, empty)]


def _f_boundary_random(m):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(4):
        pred = np.kron(rng.standard_normal((6, 6)), np.ones((8, 8))) > 0.2
        gt = np.kron(rng.standard_normal((6, 6)), np.ones((8, 8))) > 0.2
        out.append(m.f_boundary(pred, gt))
    return out


def _statistics(m):
    return [m._statistics(np.array([1.0, 1.0, 0.0, 0.0])),
            m._statistics(np.array([0.7, 0.7])),
            m._statistics(np.linspace(0, 1, 11))]


def _evaluate_masks(m):
    rng = np.random.default_rng(1)
    gt = np.zeros((40, 40), np.uint8)
    gt[5:15, 5:15] = 1
    gt[20:30, 20:30] = 2
    frames = [np.roll(gt, t, axis=1) for t in range(6)]
    pred = [np.where(rng.random(gt.shape) < 0.05, 0, f) for f in frames]
    res = m.evaluate_masks(pred, frames, name="toy")
    return (res.object_ids, res.j_per_object, res.f_per_object,
            res.summary())


def _aggregate(m):
    r = m.SequenceResult(name="s", object_ids=[1, 2])
    r.j_per_object[1] = np.array([1.0, 0.0, 1.0, 0.0])
    r.f_per_object[1] = np.array([1.0, 1.0, 1.0, 1.0])
    r.j_per_object[2] = np.array([0.3, 0.6, 0.9])
    r.f_per_object[2] = np.array([0.2, 0.4, 0.5])
    return m.aggregate([r])


def _palette_png(path, arr):
    from PIL import Image
    img = Image.fromarray(arr.astype(np.uint8), mode="P")
    img.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * 759)
    img.save(path)


def _sequence_dirs(root, noisy=False):
    """tests/test_jf.py:_make_seq_dirs: two sequences of 4 frames, one
    frame shifted when noisy."""
    for seq in ("alpha", "beta"):
        os.makedirs(root / "gt" / seq)
        os.makedirs(root / "pred" / seq)
        for t in range(4):
            gt = np.zeros((24, 32), np.uint8)
            gt[4 + t:12 + t, 6:16] = 1
            if seq == "beta":
                gt[14:20, 20:30] = 2
            _palette_png(root / "gt" / seq / f"{t:05d}.png", gt)
            pred = np.roll(gt, 2, axis=1) if noisy and t == 1 else gt
            _palette_png(root / "pred" / seq / f"{t:05d}.png", pred)
    return str(root / "pred"), str(root / "gt")


def _sequence_dirs_case(noisy):
    def case(m, tmp_path):
        pred, gt = _sequence_dirs(tmp_path / m.__name__.split(".")[0],
                                  noisy)
        res = [m.evaluate_sequence_dirs(os.path.join(pred, s),
                                        os.path.join(gt, s), name=s)
               for s in ("alpha", "beta")]
        return ([(r.object_ids, r.j_per_object, r.f_per_object)
                 for r in res], m.aggregate(res))
    return case


CASES = {
    "jaccard": lambda m, _: _jaccard(m),
    "boundary_map": lambda m, _: _boundary_map(m),
    "f_boundary": lambda m, _: _f_boundary(m),
    "f_boundary_random": lambda m, _: _f_boundary_random(m),
    "statistics": lambda m, _: _statistics(m),
    "evaluate_masks": lambda m, _: _evaluate_masks(m),
    "aggregate": lambda m, _: _aggregate(m),
    "sequence_dirs": _sequence_dirs_case(False),
    "sequence_dirs_noisy": _sequence_dirs_case(True),
}


def _equal(a, b, where="") -> None:
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jf_matches_deva_tpu(case, tmp_path):
    ref = CASES[case](jax_jf, tmp_path)
    _equal(ref, CASES[case](jf, tmp_path))


def test_eval_jf_torch_matches_eval_jf(tmp_path):
    roots = {}
    for name in ("jax", "torch"):
        os.makedirs(tmp_path / name)
        roots[name] = _sequence_dirs(tmp_path / name, noisy=True)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")

    def score(name, script):
        pred, gt = roots[name]
        return subprocess.run(
            [sys.executable, os.path.join(ROOT, "evaluation", script),
             "--results_path", pred, "--gt_path", gt], capture_output=True,
            text=True, env=env, timeout=300)

    with ThreadPoolExecutor(2) as pool:
        runs = list(pool.map(score, ("jax", "torch"),
                             ("eval_jf.py", "eval_jf_torch.py")))
    for run in runs:
        assert run.returncode == 0, run.stderr
    assert runs[0].stdout == runs[1].stdout and "J&F=" in runs[1].stdout
    for csv in ("global_results.csv", "per_sequence_results.csv"):
        with open(os.path.join(roots["jax"][0], csv)) as a, \
                open(os.path.join(roots["torch"][0], csv)) as b:
            assert a.read() == b.read(), csv
