"""The port's copies of the training datasets against deva_tpu's, item for
item, on temporary trees of the kind tests/test_training_data.py builds:
with the same seeds of numpy's and the stdlib's global generators (which
the augmentation draws from), every array of every item must be equal, and
the info the same. The static dataset takes its thin-plate-spline warp on
a third of its frames; the test counts that some of its items did."""
import os
import random

import numpy as np
import pytest
from PIL import Image

from deva_tpu.training.data import StaticTransformDataset as JaxStatic
from deva_tpu.training.data import VOSDataset as JaxVOS
from deva_tpu.training.data.tps import random_tps_warp as jax_tps

from deva_tpu_torch.training.data import StaticTransformDataset, VOSDataset
from deva_tpu_torch.training.data.tps import random_tps_warp


def _video_tree(root, n_videos=2, n_frames=6, size=64):
    rng = np.random.default_rng(0)
    for v in range(n_videos):
        os.makedirs(root / "JPEGImages" / f"vid{v}")
        os.makedirs(root / "Annotations" / f"vid{v}")
        for f in range(n_frames):
            img = rng.integers(0, 255, (size, size + 16, 3), np.uint8)
            Image.fromarray(img).save(
                root / "JPEGImages" / f"vid{v}" / f"{f:05d}.jpg")
            gt = np.zeros((size, size + 16), np.uint8)
            gt[10:30, 10 + f:30 + f] = 1
            gt[40:60, 40:60] = 2
            gt[5:15, 50:70] = 3 + v
            Image.fromarray(gt, mode="P").save(
                root / "Annotations" / f"vid{v}" / f"{f:05d}.png")
    return str(root / "JPEGImages"), str(root / "Annotations")


def _static_tree(root):
    rng = np.random.default_rng(1)
    os.makedirs(root)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (80, 100, 3), np.uint8)).save(
            root / f"{i}.jpg")
        gt = np.zeros((80, 100), np.uint8)
        gt[20:60, 30:70] = 255
        Image.fromarray(gt).save(root / f"{i}.png")
    return str(root)


def _seed(s):
    np.random.seed(s)
    random.seed(s)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "info":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("max_num_obj", [2, 3])
def test_vos_dataset_items_equal(tmp_path, max_num_obj):
    im_root, gt_root = _video_tree(tmp_path)
    kw = dict(size=48, num_frames=3, max_num_obj=max_num_obj)
    ref = JaxVOS(im_root, gt_root, 3, **kw)
    ours = VOSDataset(im_root, gt_root, 3, **kw)
    assert len(ours) == len(ref) == 2
    for i, idx in enumerate((0, 1, 0, 1)):
        _seed(10 + i)
        a = ref[idx]
        _seed(10 + i)
        _same(ours[idx], a)


def test_static_dataset_items_equal(tmp_path, monkeypatch):
    from deva_tpu_torch.training.data import static_dataset
    warps = []

    def counted(*args, **kwargs):
        warps.append(1)
        return random_tps_warp(*args, **kwargs)

    monkeypatch.setattr(static_dataset, "random_tps_warp", counted)
    root = _static_tree(tmp_path / "static")
    kw = dict(size=48, num_frames=3, max_num_obj=2)
    ref = JaxStatic([(root, 1, 2)], **kw)
    ours = StaticTransformDataset([(root, 1, 2)], **kw)
    assert len(ours) == len(ref) == 6
    for i in range(4):
        _seed(20 + i)
        a = ref[i]
        _seed(20 + i)
        _same(ours[i], a)
    assert warps


def test_tps_warp_equal():
    yy, xx = np.mgrid[0:64, 0:80]
    img = Image.fromarray(np.stack([yy * 3, xx * 2, yy + xx],
                                   -1).astype(np.uint8))
    mask = Image.fromarray(((yy > 20) & (xx > 30)).astype(np.uint8) * 255)
    np.random.seed(3)
    ref = jax_tps(img, mask, scale=0.02)
    np.random.seed(3)
    ours = random_tps_warp(img, mask, scale=0.02)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
