"""Mid-stream mask insertion under the port's batched VOS driver
(evaluation/eval_vos_batched_torch.py:run_group_midstream, through
deva_tpu_torch/inference/batched_detection.py), end to end on the CPU:
tests/test_batched_midstream.py's three videos and configuration, long-term
memory on, so masked writes, a new bucket mid-group, lockstep consolidation
and multi-frame blocks all run.

Held against deva_tpu's batched driver (eval_vos_batched.py, its own
run_group_midstream) and against the port's sequential driver
(eval_vos_torch.py), on the same weights (one deva_tpu .npz export of a
seeded port model, tests/test_torch_driver.py:_weights). Budgets, per
file: against deva_tpu at least 99% of the labels equal (the two differ by
f32 summation order), against the sequential driver at most 5% of the
pixels differ (tests/test_batched_midstream.py's budget: the random-init
outputs are near-uniform and the batched body sums in another order).
"""
import os

import numpy as np
import pytest

from test_batched_midstream import _mask, _write_video
from test_torch_batched_driver import _masks, _run
from test_torch_driver import _weights

COMMON = ["--dataset", "G", "--size", "-1", "--mem_every", "2", "--top_k",
          "8", "--max_mid_term_frames", "4", "--min_mid_term_frames", "2",
          "--num_prototypes", "8", "--topk_method", "exact",
          "--use_all_masks"]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """tests/test_batched_midstream.py's data through the three drivers."""
    tmp = tmp_path_factory.mktemp("midstream")
    rng = np.random.default_rng(17)
    data = str(tmp / "data")
    obj1 = (1, slice(8, 28), slice(10, 40))
    obj2 = (2, slice(36, 60), slice(50, 90))
    obj3 = (3, slice(2, 18), slice(60, 88))
    # vid_a: object 2 introduced at frame 3; vid_b: first mask at frame 2,
    # a third object at 5, shorter; vid_c: first-frame only (the
    # first-frame group path, which the routing must not change)
    _write_video(data, "vid_a", 10, rng, {0: _mask(obj1), 3: _mask(obj2)})
    _write_video(data, "vid_b", 9, rng, {2: _mask(obj2), 5: _mask(obj3)})
    _write_video(data, "vid_c", 10, rng, {0: _mask(obj1, obj2)})
    common = COMMON + ["--generic_path", data, "--model", _weights(tmp)]
    out = {}
    for name, script, extra in (
            ("deva_tpu", "eval_vos_batched.py", ["--batch", "2"]),
            ("batched", "eval_vos_batched_torch.py",
             ["--batch", "2", "--device", "cpu"]),
            ("sequential", "eval_vos_torch.py", ["--device", "cpu"])):
        out[name + "_log"] = _run(script, *common, *extra, "--output",
                                  str(tmp / name))
        out[name] = _masks(str(tmp / name))
    return out


def test_midstream_driver_equals_sequential(outputs):
    """tests/test_batched_midstream.py's case on the port: the batched
    driver's files are the sequential driver's, within 5% of the pixels,
    and vid_b's frames before its first mask are emitted by neither."""
    assert "mid-stream group (64, 96, 3): ['vid_a', 'vid_b']" in \
        outputs["batched_log"]
    seq, bat = outputs["sequential"], outputs["batched"]
    assert sorted(seq) == sorted(bat), "output file sets differ"
    assert "vid_b/00000.png" not in seq
    assert len(seq) == 10 + 7 + 10
    for name in sorted(seq):
        a, b = seq[name], bat[name]
        assert a.shape == b.shape
        frac = (a != b).mean()
        assert frac <= 0.05, f"{name}: {frac:.2%} pixels differ"


def test_midstream_driver_matches_deva_tpu(outputs):
    """The port's run_group_midstream against deva_tpu's: the same files,
    at least 99% of the labels of each equal."""
    ref, got = outputs["deva_tpu"], outputs["batched"]
    assert sorted(ref) == sorted(got)
    for name in sorted(ref):
        agree = (got[name] == ref[name]).mean()
        assert agree >= 0.99, f"{name}: label agreement {agree:.2%}"
    assert os.path.basename(sorted(ref)[0]).endswith(".png")
