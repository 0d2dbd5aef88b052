"""eval_vos_torch.py against eval_vos.py with test-time flips (alone, and
with score dumps under the approx method by chunks of 2), on example/vos at
--size 120 (the frames resized, the outputs resized back to 854x480), both
drivers on the same .npz weights (--save_scores alone:
tests/test_torch_vos_scores.py).

Budgets: each palette PNG at least 99% equal to deva_tpu's (the two differ
by f32 summation order; near-tie pixels may flip); score maps within 1/255
on at least 99% of their values; backward.npy equal.
"""
import os

import numpy as np
import pytest

from torch_vos_common import (CLIP, compare_pngs, compare_scores, run_both,
                              weights)


@pytest.mark.parametrize("flags", [
    ["--flip"],
    ["--flip", "--save_scores", "--topk_method", "approx", "--chunk", "2"],
], ids=["flip", "flip_scores_approx_chunk2"])
def test_eval_vos_torch_flip(tmp_path, flags):
    common = ["--dataset", "G", "--generic_path", CLIP, "--size", "120",
              "--model", weights(tmp_path), *flags]
    _, out = run_both("evaluation/eval_vos.py", "evaluation/eval_vos_torch.py",
                      common, tmp_path / "jax", tmp_path / "torch")
    assert "Total processed frames: 4" in out
    scores = "--save_scores" in flags
    masks = "Annotations" if scores else ""
    assert compare_pngs(tmp_path / "jax" / masks,
                        tmp_path / "torch" / masks) == 4
    if scores:
        # the score maps of the 4 frames and the backward map
        assert compare_scores(tmp_path / "jax" / "Scores",
                              tmp_path / "torch" / "Scores") == 4
        maps = np.load(tmp_path / "torch" / "Scores" / "bmx-trees" /
                       "00003.npy")
        assert maps.shape == (3, 480, 854)
    else:
        assert not os.path.exists(tmp_path / "torch" / "Scores")
