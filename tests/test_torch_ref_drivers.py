"""The port's referring and saliency drivers against deva_tpu's, on
tests/test_ref_drivers_smoke.py's synthetic soft-mask datasets (64x96, 6
frames, one object), with the same .npz weights and flags
(--num_voting_frames 3 --top_k 8 --size -1): eval_ref_davis_torch.py,
eval_ref_youtubevos_torch.py and eval_saliency_torch.py.

Each run votes a keyframe by consensus and propagates backward and forward
from its soft mask through the composed path, the consensus core's image
feature store shared by both passes. Budget: key.txt equal (the sampled
frames and the keyframe), the same files, each PNG at least 99% equal
(near-tie pixels may flip: the two packages sum f32 in other orders).
"""
import json
import os
import zipfile

import numpy as np

from torch_vos_common import compare_pngs, run_both, tree, weights

FLAGS = ["--num_voting_frames", "3", "--top_k", "8", "--size", "-1"]


def _clip(root, seed, boxes, vid="vid0", obj=None, scores=None):
    """Frames under root/JPEGImages/<vid>, soft masks (0/255) under
    root/masks/<vid>[/<obj>], box i on frame i, and scores.csv."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    h, w = 64, 96
    img_dir = root / "JPEGImages" / vid
    mask_dir = root / "masks" / vid
    if obj is not None:
        mask_dir = mask_dir / obj
    os.makedirs(img_dir)
    os.makedirs(mask_dir)
    base = rng.integers(0, 255, (h // 8, w // 8, 3)).astype(np.uint8)
    for i, (r0, r1, c0, c1) in enumerate(boxes):
        img = np.kron(base, np.ones((8, 8, 1))).astype(np.uint8)
        Image.fromarray(img).save(img_dir / f"{i:05d}.jpg")
        prob = np.zeros((h, w), np.uint8)
        prob[r0:r1, c0:c1] = 255
        Image.fromarray(prob).save(mask_dir / f"{i:05d}.png")
    if scores is not None:
        with open(root / "masks" / vid / "scores.csv", "w") as f:
            f.write("\n".join(f"{i:05d}.png,{obj or 1},{s:.2f}"
                              for i, s in enumerate(scores)))


def _keys(out_jax, out_torch, rel):
    keys = [open(os.path.join(o, rel)).read() for o in (out_jax, out_torch)]
    assert keys[0] == keys[1], keys
    return keys[1]


def test_eval_ref_davis_torch_matches(tmp_path):
    _clip(tmp_path, 7, [(10 + i, 40 + i, 20, 60) for i in range(6)],
          obj="1", scores=[0.5 + 0.05 * i for i in range(6)])
    common = ["--img_path", str(tmp_path / "JPEGImages"), "--mask_path",
              str(tmp_path / "masks"), "--model", weights(tmp_path), *FLAGS]
    run_both("evaluation/eval_ref_davis.py",
             "evaluation/eval_ref_davis_torch.py", common,
             tmp_path / "jax", tmp_path / "torch")
    assert _keys(tmp_path / "jax", tmp_path / "torch", "vid0/key.txt") == \
        "options: [1, 3, 5]; keyframe: 5"
    assert compare_pngs(tmp_path / "jax", tmp_path / "torch") == 6
    assert tree(tmp_path / "jax") == tree(tmp_path / "torch")


def test_eval_saliency_torch_matches(tmp_path):
    _clip(tmp_path, 9, [(8 + 2 * i, 40 + 2 * i, 24, 64) for i in range(6)])
    common = ["--img_path", str(tmp_path / "JPEGImages"), "--mask_path",
              str(tmp_path / "masks"), "--model", weights(tmp_path), *FLAGS]
    run_both("evaluation/eval_saliency.py",
             "evaluation/eval_saliency_torch.py", common, tmp_path / "jax",
             tmp_path / "torch")
    key = _keys(tmp_path / "jax", tmp_path / "torch", "vid0/key.txt")
    assert key.startswith("options: [1, 3, 5]; keyframe: ")
    assert compare_pngs(tmp_path / "jax", tmp_path / "torch") == 6
    assert tree(tmp_path / "jax") == tree(tmp_path / "torch")


def test_eval_ref_youtubevos_torch_matches(tmp_path):
    vid = "0062f687f1"  # in the official val subset
    _clip(tmp_path, 11, [(10 + i, 44 + i, 16, 56) for i in range(6)],
          vid=vid, obj="obj1", scores=[0.4 + 0.05 * i for i in range(6)])
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({"videos": {vid: {"frames": [f"{i:05d}"
                                               for i in range(6)]}}}, f)
    common = ["--img_path", str(tmp_path / "JPEGImages"), "--mask_path",
              str(tmp_path / "masks"), "--json_path",
              str(tmp_path / "meta.json"), "--model", weights(tmp_path),
              *FLAGS]
    run_both("evaluation/eval_ref_youtubevos.py",
             "evaluation/eval_ref_youtubevos_torch.py", common,
             tmp_path / "jax", tmp_path / "torch")
    _keys(tmp_path / "jax", tmp_path / "torch",
          f"Annotations/{vid}/obj1/key.txt")
    assert compare_pngs(tmp_path / "jax" / "Annotations",
                        tmp_path / "torch" / "Annotations") == 6
    assert tree(tmp_path / "jax" / "Annotations") == \
        tree(tmp_path / "torch" / "Annotations")
    zips = [zipfile.ZipFile(tmp_path / p / f"{p}.zip").namelist()
            for p in ("jax", "torch")]
    assert sorted(zips[0]) == sorted(zips[1])
