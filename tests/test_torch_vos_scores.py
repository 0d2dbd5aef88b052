"""eval_vos_torch.py --save_scores against eval_vos.py --save_scores, and
scripts/merge_multi_scale_torch.py against scripts/merge_multi_scale.py,
on example/vos with the same .npz weights.

Budgets: palette PNGs at least 99% equal to deva_tpu's, score maps within
1/255 on at least 99% of their values (the uint8 cast truncates), and
backward.npy equal. The two merge scripts read the same score dumps (the
port's, at --size 120 and 96), so their PNGs and zip members are equal.
"""
import os
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from torch_vos_common import (CLIP, compare_pngs, compare_scores, read_png,
                              run, run_both, tree, weights)


def test_eval_vos_torch_save_scores(tmp_path):
    common = ["--dataset", "G", "--generic_path", CLIP, "--size", "120",
              "--model", weights(tmp_path), "--save_scores"]
    _, out = run_both("evaluation/eval_vos.py", "evaluation/eval_vos_torch.py",
                      common, tmp_path / "jax", tmp_path / "torch")
    assert "Total processed frames: 4" in out
    assert compare_pngs(tmp_path / "jax" / "Annotations",
                        tmp_path / "torch" / "Annotations") == 4
    assert compare_scores(tmp_path / "jax" / "Scores",
                          tmp_path / "torch" / "Scores") == 4
    # --save_scores writes no zip (a merge makes it)
    assert not any(n.endswith(".zip") for n in os.listdir(tmp_path))


def test_merge_multi_scale_torch_matches(tmp_path):
    w = weights(tmp_path)
    scales = [tmp_path / f"s{size}" for size in (120, 96)]
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda a: run(
            "evaluation/eval_vos_torch.py", "--dataset", "G",
            "--generic_path", CLIP, "--size", a[0], "--model", w,
            "--save_scores", "--output", str(a[1]), "--device", "cpu"),
            [("120", scales[0]), ("96", scales[1])]))
        list(pool.map(lambda a: run(
            a[0], "--dataset", "D", "--num_proc", "1", "--output",
            str(a[1]), "--list", *map(str, scales)),
            [("scripts/merge_multi_scale.py", tmp_path / "merged_jax"),
             ("scripts/merge_multi_scale_torch.py",
              tmp_path / "merged_torch")]))
    names = tree(tmp_path / "merged_jax")
    assert names == tree(tmp_path / "merged_torch") == [
        f"bmx-trees/{i:05d}.png" for i in range(4)]
    for n in names:
        a = read_png(tmp_path / "merged_jax" / n)
        b = read_png(tmp_path / "merged_torch" / n)
        assert a.shape == (480, 854) and np.array_equal(a, b), n
    zips = [zipfile.ZipFile(tmp_path / f"merged_{p}.zip").namelist()
            for p in ("jax", "torch")]
    assert sorted(zips[0]) == sorted(zips[1])
