"""deva_tpu_torch's demos (demo/demo_with_text_torch.py,
demo/demo_automatic_torch.py) against deva_tpu's (demo/demo_with_text.py,
demo/demo_automatic.py), end to end on example/vipseg (4 frames at
1280x720, --size 120), on the CPU (--device cpu).

deva_tpu's demos build their detector inside main() (Grounding DINO and
SAM through transformers, from a model id), so both packages' mains run in
process here, each with its module's build_text_detector /
build_auto_generator replaced by its package's ReplayDetector on
tests/fixtures/replay_dets_vipseg.npz (the recorded detections of these
frames: the same detections for both). Both load the same propagation
weights (a seeded port model as a deva_tpu .npz,
tests/test_torch_driver.py:_weights). The automatic demos also count the
image encodes (the feature store's) of each frame's processing.

Object ids are drawn per run, so the two outputs are compared after a
one-to-one matching of their ids (tests/test_torch_detection_driver.py:
_matching). Budget, per frame: at least 99% of the pixels agree under the
matching (the two differ by f32 summation order; with random weights the
objects' probabilities are nearly flat, and a near-tie pixel may flip),
and the frame's segments match one to one with equal category_id.
tests/test_torch_demo_automatic.py runs the automatic demos so, with this
file's helpers; tests/test_torch_demo_sam.py runs them as subprocesses
with the port's and deva_tpu's MobileSAM as the mask source.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from deva_tpu.ext.detectors import ReplayDetector as JaxReplayDetector

from deva_tpu_torch.ext.detectors import ReplayDetector
from deva_tpu_torch.utils.pano_utils import rgb_to_id

from test_torch_detection_driver import _matching
from test_torch_driver import _weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(ROOT, "example", "vipseg", "images", "12_1mWNahzcsAc")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "replay_dets_vipseg.npz")
FRAMES = ["00001255", "00001258", "00001261", "00001264"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return _weights(tmp_path_factory.mktemp("weights"))


def _module(script):
    name = os.path.basename(script)[:-3]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "demo", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _count_encodes(mod, name, encodes):
    """Wrap the demo module's processor: record the feature store's encodes
    of each frame's call."""
    process = getattr(mod, name)

    def counted(deva, source, ext_cfg, frame_path, saver, ti, **kw):
        store = deva.image_feature_store
        if not hasattr(store, "_counted"):
            encode = store._encode

            def encode_counted(image):
                encodes[-1] += 1
                return encode(image)

            store._encode, store._counted = encode_counted, True
        encodes.append(0)
        return process(deva, source, ext_cfg, frame_path, saver, ti, **kw)

    setattr(mod, name, counted)


def _run_jax(script, factory, argv, encodes=None, processor=None):
    mod = _module(script)
    setattr(mod, factory, lambda args: JaxReplayDetector(FIXTURE))
    if encodes is not None:
        _count_encodes(mod, processor, encodes)
    saved = sys.argv
    sys.argv = [script] + argv
    try:
        mod.main()
    finally:
        sys.argv = saved


def _run_port(script, factory, argv, encodes=None, processor=None):
    mod = _module(script)
    setattr(mod, factory, lambda args: ReplayDetector(FIXTURE))
    if encodes is not None:
        _count_encodes(mod, processor, encodes)
    mod.main(argv + ["--device", "cpu"])


def _read(out_dir):
    from PIL import Image
    with open(os.path.join(out_dir, "pred.json")) as f:
        anns = json.load(f)["annotations"]
    assert [a["file_name"] for a in anns] == [f + ".jpg" for f in FRAMES]
    frames = []
    for ann, name in zip(anns, FRAMES):
        ids = rgb_to_id(np.asarray(Image.open(os.path.join(
            out_dir, "Annotations", name + ".png"))))
        segs = {s["id"]: s["category_id"] for s in ann["segments_info"]}
        frames.append((ids, segs))
        assert os.path.exists(os.path.join(out_dir, "Visualizations",
                                           name + ".jpg"))
    return frames


def _compare(tmp_path):
    worst = 1.0
    for (ref, ref_segs), (ours, segs) in zip(_read(tmp_path / "jax"),
                                             _read(tmp_path / "torch")):
        assert ours.shape == ref.shape == (720, 1280)
        pairs, share = _matching(ref, ours)
        assert share >= 0.99, share
        worst = min(worst, share)
        assert len(segs) == len(ref_segs)
        for rid, cat in ref_segs.items():
            assert segs[pairs[rid]] == cat
    return worst


@pytest.mark.parametrize("setting", ["semionline", "online"])
def test_demo_with_text_torch_matches(tmp_path, weights, setting):
    common = ["--img_path", CLIP, "--size", "120", "--model", weights,
              "--prompt", "person.bench.tree", "--temporal_setting",
              setting, "--detection_every", "2"]
    _run_jax("demo_with_text.py", "build_text_detector",
             common + ["--output", str(tmp_path / "jax")])
    _run_port("demo_with_text_torch.py", "build_text_detector",
              common + ["--output", str(tmp_path / "torch")])
    _compare(tmp_path)
    with open(tmp_path / "torch" / "pred.json") as f:
        segments = [a["segments_info"] for a in json.load(f)["annotations"]]
    if setting == "online":  # the replayed segments become objects
        assert min(len(s) for s in segments) >= 4
