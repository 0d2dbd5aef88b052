"""--obj_shards on the port's drivers: evaluation/eval_vos_torch.py and
demo/demo_automatic_torch.py under 2 gloo ranks (started as torchrun
would) write what the unsharded driver writes, process 0 alone writes, a
WORLD_SIZE that differs from --obj_shards raises SystemExit, and the two
batched drivers refuse the flag.

Tolerance: the VOS masks may differ on at most 0.1% of the pixels (the
sharded softmax sums in another order; random weights give near-ties);
the demo's pred.json must be equal and its id PNGs equal on 99.9% of the
pixels.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_parallel_common as C

TINY_FLAGS = ["--device", "cpu", "--pix_feat_dim", "64", "--key_dim", "16",
              "--value_dim", "32", "--size", "120"]
VOS = ["evaluation/eval_vos_torch.py", "--dataset", "G", "--generic_path",
       "./example/vos", *TINY_FLAGS]


def _pngs(root):
    from PIL import Image
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    np.asarray(Image.open(os.path.join(d, f)))
    return out


def _same_pngs(a, b, share=0.999):
    pa, pb = _pngs(a), _pngs(b)
    assert pa and sorted(pa) == sorted(pb)
    for k in pa:
        assert (pa[k] == pb[k]).mean() >= share, k


def _run(argv):
    return subprocess.run([sys.executable, *argv], cwd=C.ROOT,
                          capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=C.ROOT,
                                   HF_HUB_OFFLINE="1"), timeout=300)


def _load(script):
    spec = importlib.util.spec_from_file_location(
        os.path.basename(script)[:-3], os.path.join(C.ROOT, script))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.join(C.ROOT, "evaluation"))
    spec.loader.exec_module(mod)
    return mod


def test_vos_driver_obj_shards(tmp_path):
    outs = C.spawn_script(2, [*VOS, "--output", tmp_path / "sharded",
                              "--obj_shards", "2"])
    for rc, out in outs:
        assert rc == 0, out[-3000:]
    ref = _run([*VOS, "--output", str(tmp_path / "unsharded")])
    assert ref.returncode == 0, ref.stderr[-3000:]
    _same_pngs(tmp_path / "unsharded", tmp_path / "sharded")


def test_demo_automatic_obj_shards(tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    src = os.path.join(C.ROOT, "example/vipseg/images/12_1mWNahzcsAc")
    for f in sorted(os.listdir(src))[:2]:
        os.symlink(os.path.join(src, f), frames / f)
    demo = ["demo/demo_automatic_torch.py", "--img_path", str(frames),
            "--sam_variant", "mobile", "--SAM_NUM_POINTS_PER_SIDE", "4",
            *TINY_FLAGS]
    outs = C.spawn_script(2, [*demo, "--output", tmp_path / "sharded",
                              "--obj_shards", "2"])
    for rc, out in outs:
        assert rc == 0, out[-3000:]
    ref = _run([*demo, "--output", str(tmp_path / "unsharded")])
    assert ref.returncode == 0, ref.stderr[-3000:]
    with open(tmp_path / "sharded" / "pred.json") as a, \
            open(tmp_path / "unsharded" / "pred.json") as b:
        assert json.load(a) == json.load(b)
    _same_pngs(tmp_path / "unsharded", tmp_path / "sharded")


def test_only_process_zero_writes(monkeypatch):
    from argparse import Namespace

    from deva_tpu_torch.inference.eval_args import NullSaver, is_writer
    args = Namespace(obj_shards=2)
    monkeypatch.setenv("RANK", "1")
    assert not is_writer(args)
    assert not is_writer(Namespace(obj_shards=4))
    monkeypatch.setenv("RANK", "0")
    assert is_writer(args)
    assert is_writer(Namespace(obj_shards=1))
    saver = NullSaver()
    assert saver.save_mask(None, "f.png", need_resize=False) is None
    assert saver.end() is None and saver.video_json is None


def test_world_size_mismatch_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "1")
    driver = _load("evaluation/eval_vos_torch.py")
    with pytest.raises(SystemExit, match="--obj_shards 2 needs 2"):
        driver.main([*VOS[1:], "--output", str(tmp_path), "--obj_shards",
                     "2"])
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="WORLD_SIZE is 4"):
        driver.main([*VOS[1:], "--output", str(tmp_path), "--obj_shards",
                     "2"])


@pytest.mark.parametrize("script", [
    "evaluation/eval_vos_batched_torch.py",
    "evaluation/eval_with_detections_batched_torch.py"])
def test_batched_drivers_reject(script, tmp_path):
    driver = _load(script)
    argv = ["--output", str(tmp_path), "--device", "cpu", "--obj_shards",
            "2"]
    if "detections" in script:
        argv += ["--mask_path", str(tmp_path)]
    with pytest.raises(SystemExit, match="does not support --obj_shards"):
        driver.main(argv)
