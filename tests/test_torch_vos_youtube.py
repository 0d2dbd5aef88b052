"""eval_vos_torch.py --dataset Y18 against eval_vos.py on a synthetic
YouTube-VOS layout (torch_vos_common.youtube_layout), and the port's RLE
mask source of VideoReader against deva_tpu's.

Budget: each PNG at least 99% equal to deva_tpu's; the same files and zip
members.
"""
import os

import numpy as np
import pytest

from deva_tpu.data.video_reader import VideoReader as JaxVideoReader

from deva_tpu_torch.data.video_reader import VideoReader
from deva_tpu_torch.utils import rle

from torch_vos_common import check_youtube_outputs, youtube_outputs


def test_eval_vos_torch_youtube_layout(tmp_path):
    out = youtube_outputs(tmp_path, "eval_vos")
    # a: frames 0-7; b: frames 2-7
    assert "Total processed frames: 14" in out
    check_youtube_outputs(tmp_path)


@pytest.mark.parametrize("size", [-1, 48])
def test_rle_source_matches_deva_tpu(tmp_path, size):
    """VideoReader(segmentation_from_dict=...): frames named by the dict,
    each item's soft mask decoded from its RLE, array for array as
    deva_tpu's reader gives them."""
    from PIL import Image
    rng = np.random.default_rng(9)
    img_dir = tmp_path / "JPEGImages" / "v"
    os.makedirs(img_dir)
    seg = {}
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (64, 96, 3)).astype(np.uint8)
                        ).save(img_dir / f"{i:05d}.jpg")
        if i == 3:
            continue  # a frame without an entry is not read
        m = np.zeros((64, 96), bool)
        m[5 + 3 * i:30 + 3 * i, 10:50 + 5 * i] = True
        seg[f"{i:05d}"] = {"obj": {"segmentation": rle.encode(m)}}
    kw = dict(size=size, segmentation_from_dict=seg, object_name="obj",
              use_all_masks=True)
    ours = VideoReader("v", str(img_dir), None, **kw)
    ref = JaxVideoReader("v", str(img_dir), None, **kw)
    assert ours.frames == ref.frames == ["00000.jpg", "00001.jpg",
                                         "00002.jpg", "00004.jpg"]
    assert ours.mask_frame_indices() == ref.mask_frame_indices()
    for i in range(len(ref)):
        a, b = ref[i], ours[i]
        assert sorted(a) == sorted(b) == ["info", "mask", "rgb",
                                          "valid_labels"]
        assert a["info"] == b["info"]
        for key in ("rgb", "mask", "valid_labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        assert b["mask"].shape[0] == 1 and b["mask"].max() == 1.0
