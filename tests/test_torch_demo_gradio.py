"""deva_tpu_torch's video demo (demo/demo_gradio_torch.py) against deva_tpu's
(demo/demo_gradio.py), on the CPU with cv2 (neither demo needs gradio
outside --serve).

Both command lines run in process on a seeded 8-frame 64x96 mp4v clip
(--size 64, so the frames are processed at their own size), semi-online
and online, with the same seeded propagation weights (a seeded port model
as a deva_tpu .npz, tests/test_torch_driver.py:_weights) and
tests/test_ext_processors.py's box-mask text detector in place of each
module's build_text_detector, and each core's object ids drawn from an
equal seeded generator (the blend colours an object by its id). The
frames handed to cv2.VideoWriter are recorded (mp4v is lossy, so the
decoded videos are not compared pixel by pixel): the same count and size,
and at least 99% of each frame's pixels equal (f32 summation order; with
random weights the objects' probabilities are nearly flat, so a near-tie
pixel may flip), as tests/test_torch_demo_drivers.py's budget.

run_auto runs with a seeded MobileSAM (--sam_variant mobile, no
checkpoint). --serve builds both apps under a fake gradio module that
records the components and stubs launch: the two tabs' inputs (sliders,
ranges, defaults, labels) equal deva_tpu's, apart from the SAM variant
dropdown's names.
"""
import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

from deva_tpu_torch.detection_clips import identity_alignment  # noqa: E402

from test_ext_processors import SyntheticTextDetector, _frames  # noqa: E402
from test_torch_driver import _weights  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, T = 64, 96, 8


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return _weights(tmp_path_factory.mktemp("weights"))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    video = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    for frame in _frames(np.random.default_rng(8), T):
        video.write(frame[:, :, ::-1].copy())
    video.release()
    return out


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "demo", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # the port's demo defines a dataclass
    spec.loader.exec_module(mod)
    return mod


def _seeded(mod, cores):
    """The module's InferenceCore, each instance's object ids drawn from
    np.random.default_rng(5), its semi-online vote aligning by identity
    (random weights align noise, and the vote would select nothing:
    detection_clips.identity_alignment); the cores are kept in `cores`."""
    cls = mod.InferenceCore

    def make(*args, **kwargs):
        core = cls(*args, **kwargs)
        core.object_manager._rng = np.random.default_rng(5)
        identity_alignment(core)
        cores.append(core)
        return core
    mod.InferenceCore = make


class _Recorder:
    """cv2.VideoWriter that keeps a copy of every frame it is handed."""

    def __init__(self, frames):
        self.frames = frames

    def __call__(self, *args, **kwargs):
        video = _Recorder.real(*args, **kwargs)
        frames = self.frames

        class Writer:
            def write(self, frame):
                frames.append(np.array(frame))
                video.write(np.ascontiguousarray(frame))

            def isOpened(self):
                return video.isOpened()

            def release(self):
                video.release()
        return Writer()


_Recorder.real = cv2.VideoWriter


def _decoded(video):
    cap = cv2.VideoCapture(video)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def _run(package, argv, monkeypatch, tmp_path):
    """One demo's command line on argv; -> (frames handed to the writer,
    the output video, the cores)."""
    frames, cores = [], []
    monkeypatch.setattr(cv2, "VideoWriter", _Recorder(frames))
    out = str(tmp_path / package)
    if package == "jax":
        mod = _module("demo_gradio")
        mod.build_text_detector = lambda args: SyntheticTextDetector()
        _seeded(mod, cores)
        monkeypatch.setattr(sys, "argv", ["demo_gradio.py", *argv,
                                          "--output", out])
        mod.main()
    else:
        mod = _module("demo_gradio_torch")
        mod.build_text_detector = lambda args: SyntheticTextDetector()
        _seeded(mod, cores)
        mod.main([*argv, "--output", out, "--device", "cpu"])
    monkeypatch.undo()
    return frames, os.path.join(out, "tracked.mp4"), cores


@pytest.mark.parametrize("setting", ["semionline", "online"])
def test_track_video_matches(tmp_path, monkeypatch, weights, clip, setting):
    argv = ["--video", clip, "--model", weights, "--size", "64",
            "--prompt", "cat.dog", "--temporal_setting", setting,
            "--detection_every", "3", "--num_voting_frames", "2",
            "--top_k", "8", "--mem_every", "2"]
    ref, ref_video, _ = _run("jax", argv, monkeypatch, tmp_path)
    ours, video, cores = _run("torch", argv, monkeypatch, tmp_path)
    assert len(ours) == len(ref) == T
    worst = 1.0
    for a, b in zip(ref, ours):
        assert a.shape == b.shape == (H, W, 3) and b.dtype == np.uint8
        worst = min(worst, float((a == b).all(-1).mean()))
    assert worst >= 0.99, worst
    dec_ref, dec = _decoded(ref_video), _decoded(video)
    assert len(dec) == len(dec_ref) == T
    assert all(f.shape == (H, W, 3) for f in dec + dec_ref)
    (core,) = cores
    assert core.object_manager.num_obj >= 1


def test_run_auto_mobile_sam(tmp_path, monkeypatch, weights, clip):
    """The automatic tab's callback, with the port's seeded random MobileSAM
    (mobile, a 4x4 grid, the IoU filter off): one blended BGR frame of the
    clip's size per frame to the writer and in the video, objects admitted,
    and the image encodes of the SAM variant run."""
    mod = _module("demo_gradio_torch")
    mod.build_text_detector = lambda args: None
    cores, frames = [], []
    _seeded(mod, cores)
    demo = mod.make_demo(mod.make_parser().parse_args(
        ["--model", weights, "--device", "cpu", "--top_k", "8",
         "--mem_every", "2"]))
    monkeypatch.setattr(cv2, "VideoWriter", _Recorder(frames))
    from deva_tpu_torch.ext.mobile_sam import MobileSAM
    embeds = []
    real_embed = MobileSAM._embed

    def embed(self, image):
        embeds.append(image.shape)
        return real_embed(self, image)

    monkeypatch.setattr(MobileSAM, "_embed", embed)
    video = mod.run_auto(demo, clip, float("-inf"), 4, 64, 3, 5, "online",
                         "mobile", False, -1)
    assert video.endswith("tracked.mp4")
    assert len(frames) == T and all(
        f.shape == (H, W, 3) and f.dtype == np.uint8 for f in frames)
    assert len(_decoded(video)) == T
    (core,) = cores
    assert core.object_manager.num_obj >= 1
    assert embeds and all(s == (H, W, 3) for s in embeds)
    with pytest.raises(ValueError):
        mod.auto_setup(demo, 0.88, 4, 64, 3, 5, "online", "jax-mobile",
                       False)


def _fake_gradio(log):
    """A gradio stand-in: each component call is logged as (kind, args,
    kwargs); Blocks and Tab are context managers; launch is logged."""
    gr = types.ModuleType("gradio")

    def component(kind):
        def make(*args, **kwargs):
            log.append((kind, args, kwargs))
            return (kind, args, tuple(sorted(kwargs.items())))
        return make

    for kind in ("Slider", "Dropdown", "Video", "Text", "Number",
                 "Checkbox"):
        setattr(gr, kind, component(kind))

    class Context:
        def __init__(self, *args, **kwargs):
            log.append((type(self).__name__, args, kwargs))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def launch(self, *args, **kwargs):
            log.append(("launch", args, kwargs))

    gr.Blocks = type("Blocks", (Context,), {})
    gr.Tab = type("Tab", (Context,), {})
    gr.Progress = lambda *a, **k: "progress"

    def interface(fn, inputs, outputs, title):
        log.append(("Interface", (), dict(
            inputs=inputs, outputs=outputs, title=title,
            params=list(fn.__code__.co_varnames[:fn.__code__.co_argcount]))))
    gr.Interface = interface
    return gr


def test_serve_layout_matches(tmp_path, monkeypatch, weights):
    layouts = {}
    for package, name in (("jax", "demo_gradio"),
                          ("torch", "demo_gradio_torch")):
        log = layouts[package] = []
        monkeypatch.setitem(sys.modules, "gradio", _fake_gradio(log))
        mod = _module(name)
        mod.build_text_detector = lambda args: SyntheticTextDetector()
        argv = ["--serve", "--model", weights]
        if package == "jax":
            monkeypatch.setattr(sys, "argv", [name + ".py", *argv])
            mod.main()
        else:
            mod.main(argv + ["--device", "cpu"])
    ref, ours = layouts["jax"], layouts["torch"]
    assert [e[0] for e in ours] == [e[0] for e in ref]
    assert ours[-1][0] == "launch"
    interfaces = [(r, o) for r, o in zip(ref, ours) if r[0] == "Interface"]
    assert len(interfaces) == 2
    sam = 0
    for r, o in interfaces:
        assert o[2]["params"] == r[2]["params"]
        assert o[2]["outputs"] == r[2]["outputs"]
        assert o[2]["title"] == r[2]["title"]
        assert len(o[2]["inputs"]) == len(r[2]["inputs"])
        for a, b in zip(r[2]["inputs"], o[2]["inputs"]):
            if a[0] == "Dropdown" and "jax-mobile" in dict(a[2])["choices"]:
                sam += 1
                assert dict(b[2])["choices"] == ["mobile", "sam_hq_light",
                                                 "hf-sam"]
                assert dict(b[2])["value"] == "mobile"
                continue
            assert a == b
    assert sam == 1
    for r, o in zip(ref, ours):  # the tabs' labels
        if r[0] == "Tab":
            assert r == o
