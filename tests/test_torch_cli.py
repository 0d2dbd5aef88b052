"""chip_smoke.py phase 13 (the command lines) on the CPU.

Phase 13 runs the port's evaluation drivers and demos from argv on the
repo's clips, card against a CPU twin of the same command, and compares
their output trees. Here:
- its comparison helpers on synthetic output trees: each must refuse a
  missing file, labels past the budget, score maps past 1/255, a differing
  label away from a near-tie, a pred.json whose segments differ, a video
  far from the other, a non-zero exit code and a "Skipping" line (the fault
  barrier exits 0 after a skipped video), the last through a real driver;
- a rehearsal of 13a's and 13c's commands at --size 120 with the card side
  replaced by --device cpu (no kernel launches are counted on the CPU);
- the text demo's drive() with the ReplayDetector on example/vipseg, as
  phase 13e runs it, against deva_tpu's demo main on the same fixture and
  weights (tests/test_torch_demo_drivers.py's budget);
- demo_gradio_torch.track_video refusing an input cv2 cannot open and an
  mp4v writer cv2 cannot open (before, both ended the command with exit
  code 0 and no tracked.mp4).
"""
import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
from test_torch_demo_drivers import _compare, _run_jax
from test_torch_driver import _weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png(path, labels):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = Image.fromarray(labels.astype(np.uint8), mode="P")
    img.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * 759)
    img.save(path)


def _tree(root):
    """A --save_scores VOS output of one video: Annotations/ PNGs (two
    objects), Scores/ maps whose argmax they are, backward.npy, and a
    demo-style pred.json."""
    rng = np.random.default_rng(0)
    anns = []
    for t in range(3):
        scores = rng.integers(0, 80, (3, 32, 48)).astype(np.uint8)
        scores[1, 4:20, 4:20] = 200
        scores[2, 10:30, 24:44] = 220
        labels = scores.argmax(0)
        _png(os.path.join(root, "Annotations", "v", f"{t:05d}.png"), labels)
        os.makedirs(os.path.join(root, "Scores", "v"), exist_ok=True)
        np.save(os.path.join(root, "Scores", "v", f"{t:05d}.npy"), scores)
        anns.append({"file_name": f"{t:05d}.jpg", "segments_info": [
            {"id": int(i), "category_id": 5, "area": int((labels == i).sum())}
            for i in (1, 2)]})
    np.save(os.path.join(root, "Scores", "v", "backward.npy"), {7: 1, 9: 2},
            allow_pickle=True)
    with open(os.path.join(root, "pred.json"), "w") as f:
        json.dump({"annotations": anns}, f)


def _check(ref, got):
    """Phase 13's checks of a --save_scores run and its pred.json."""
    names = cs.same_tree(ref, got, "t")
    labels = cs.compare_labels(ref, got, names, "t", matched=True,
                               near_tie=cs.score_near_tie(ref, "t"))
    cs.compare_scores(ref, got, names, "t")
    cs.compare_pred_json(
        ref, got, lambda _, fn: os.path.join("Annotations", "v",
                                             fn[:-4] + ".png"), labels, "t")
    return labels


def _edit_png(root, t, fn):
    p = os.path.join(root, "Annotations", "v", f"{t:05d}.png")
    labels = np.asarray(Image.open(p)).copy()
    fn(labels)
    _png(p, labels)


def _break(got, how):
    if how == "missing file":
        os.remove(os.path.join(got, "Annotations", "v", "00001.png"))
    elif how == "labels past the budget":  # 2% of the pixels, at a tie
        p = os.path.join(got, "Scores", "v", "00001.npy")
        s = np.load(p)
        s[:, :, :2] = s[0, :, :2]  # scores tie on those pixels
        np.save(p, s)
        _edit_png(got, 1, lambda lab: lab.__setitem__(
            (slice(0, 32), slice(0, 1)), 2))
    elif how == "a label away from a near-tie":
        _edit_png(got, 2, lambda lab: lab.__setitem__((5, 5), 0))
    elif how == "score maps past 1/255":
        p = os.path.join(got, "Scores", "v", "00000.npy")
        s = np.load(p)
        s[0, 0, 0] += 2
        np.save(p, s)
    elif how == "backward map":
        np.save(os.path.join(got, "Scores", "v", "backward.npy"),
                {7: 2, 9: 1}, allow_pickle=True)
    elif how == "segment category":
        p = os.path.join(got, "pred.json")
        with open(p) as f:
            pred = json.load(f)
        pred["annotations"][0]["segments_info"][0]["category_id"] = 6
        with open(p, "w") as f:
            json.dump(pred, f)
    elif how == "segment area":
        p = os.path.join(got, "pred.json")
        with open(p) as f:
            pred = json.load(f)
        pred["annotations"][0]["segments_info"][1]["area"] += 5
        with open(p, "w") as f:
            json.dump(pred, f)


def test_cli_checks_accept_a_near_tie(tmp_path):
    """Equal trees pass; so does a tree whose ids are drawn anew (the
    matching maps them back) with one label moved where the scores tie."""
    _tree(tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "got")
    labels = _check(str(tmp_path / "ref"), str(tmp_path / "got"))
    assert labels["worst"] == 1.0 and labels["frames"] == 3
    # a pixel at a tie of the ref's scores flips
    p = tmp_path / "ref" / "Scores" / "v" / "00000.npy"
    s = np.load(p)
    s[:, 0, 0] = 50
    np.save(p, s)
    was = np.asarray(Image.open(tmp_path / "ref" / "Annotations" / "v" /
                                "00000.png"))[0, 0]
    _edit_png(str(tmp_path / "got"), 0,
              lambda lab: lab.__setitem__((0, 0), (was + 1) % 3))
    shutil.copy(p, tmp_path / "got" / "Scores" / "v" / "00000.npy")
    labels = _check(str(tmp_path / "ref"), str(tmp_path / "got"))
    assert labels["differ"]["Annotations/v/00000.png"] == 1


@pytest.mark.parametrize("how", [
    "missing file", "labels past the budget", "a label away from a near-tie",
    "score maps past 1/255", "backward map", "segment category",
    "segment area"])
def test_cli_checks_refuse(tmp_path, how):
    _tree(tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "got")
    _break(str(tmp_path / "got"), how)
    with pytest.raises(AssertionError):
        _check(str(tmp_path / "ref"), str(tmp_path / "got"))


@pytest.mark.parametrize("rc, text", [
    (1, "Traceback ...\nValueError: boom\n"),
    (0, "v0 (4 frames)\nRuntime error at v0\nboom\n"
        "Skipping v0 and continuing.\nFPS: 3.0\n")])
def test_cli_check_refuses_a_failed_run(rc, text):
    with pytest.raises(AssertionError):
        cs.check_cli("cmd", rc, text)
    cs.check_cli("cmd", 0, "v0 (4 frames)\nFPS: 3.0\n")
    assert cs.cli_number(text, "FPS") == (3.0 if rc == 0 else None)


def test_cli_refuses_a_skipped_video(tmp_path):
    """A driver whose video fails on its data (a frame that is not an
    image) logs it, prints "Skipping" and exits 0 without
    --raise_on_error: cli() refuses the run all the same."""
    data = tmp_path / "vos"
    shutil.copytree(os.path.join(ROOT, "example", "vos"), data)
    (data / "JPEGImages" / "bmx-trees" / "00002.jpg").write_bytes(b"no")
    with pytest.raises(AssertionError, match="skipped video"):
        cs.cli("evaluation/eval_vos_torch.py",
               ["--dataset", "G", "--generic_path", str(data), "--output",
                str(tmp_path / "out"), "--device", "cpu", "--size", "64"],
               threads=1)


def test_cli_compare_videos(tmp_path):
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 255, (48, 64, 3), np.uint8) for _ in range(3)]
    paths = []
    for name, fs in (("a", frames), ("b", frames),
                     ("c", [255 - f for f in frames]), ("d", frames[:2])):
        p = str(tmp_path / f"{name}.mp4")
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 6, (64, 48))
        for f in fs:
            w.write(f)
        w.release()
        paths.append(p)
    assert cs.compare_videos(paths[0], paths[1], "same") == float("inf")
    for other in paths[2:]:
        with pytest.raises(AssertionError):
            cs.compare_videos(paths[0], other, "different")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return _weights(tmp_path_factory.mktemp("weights"))


@pytest.fixture(scope="module")
def jax_demo(tmp_path_factory, weights):
    """deva_tpu's demo_with_text.py main with its package's ReplayDetector
    at --size 120, on a thread: the rehearsal below runs its commands in
    subprocesses, so this file's first test starts it and the last waits
    for it. -> (the directory whose "jax" holds its output, the future)."""
    from concurrent.futures import ThreadPoolExecutor
    root = tmp_path_factory.mktemp("demo")
    with ThreadPoolExecutor(1) as pool:
        yield root, pool.submit(
            _run_jax, "demo_with_text.py", "build_text_detector",
            ["--img_path", os.path.join(cs.VIPSEG, "images", cs.VIPSEG_CLIP),
             "--size", "120", "--model", weights, "--prompt",
             cs.REPLAY_PROMPT, "--output", str(root / "jax")])


def test_cli_rehearsal_13a_13c(capsys, jax_demo):
    """Phase 13a's and 13c's commands at --size 120, the card side on the
    CPU too: every command exits 0, writes its files and meets phase 13's
    budgets against its twin (the merge, the J&F scorer and the zip
    included)."""
    cs.phase13(None, torch.device("cpu"), card="cpu", parts="ac",
               size_args=["--size", "120"])
    out = capsys.readouterr().out
    for label in ("13a eval_vos_torch.py G exact", "--flip --save_scores",
                  "Y19", "13c eval_with_detections_torch.py semi-online",
                  "13c eval_with_detections_torch.py online",
                  "eval_with_detections_batched_torch.py --batch 2"):
        assert label in out, out
    assert "eval_jf_torch.py, the card's PNGs against the CPU's" in out
    assert "phase 13 took" in out


def test_text_demo_drive_matches_deva_tpu(jax_demo, weights):
    """Phase 13e's text demo (demo_with_text_torch.drive with the
    ReplayDetector) against deva_tpu's demo_with_text.py main on the same
    recorded detections and weights, at --size 120: PNGs at least 99%
    equal under the one-to-one id matching, segments one to one with equal
    categories."""
    root, jax = jax_demo
    res = cs.text_demo_run("cpu", weights, str(root / "torch"),
                           ["--size", "120"])
    assert res["fps"] and res["wall_s"] > 0
    jax.result()
    assert _compare(root) >= 0.99


def _mp4(path):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 6,
                        (64, 48))
    for k in range(2):
        w.write(np.full((48, 64, 3), 40 * k, np.uint8))
    w.release()


@pytest.mark.parametrize("fault", ["unreadable input", "mp4v unavailable"])
def test_track_video_refuses_silent_failures(tmp_path, monkeypatch, fault):
    """track_video raises where cv2 cannot open the input (the command
    exited 0 with no output before) or cannot open the mp4v writer (cv2
    drops every frame silently)."""
    gd = cs.demo_driver("demo_gradio_torch")
    video = tmp_path / "in.mp4"
    if fault == "unreadable input":
        video.write_bytes(b"not a video")
        with pytest.raises(FileNotFoundError):
            gd.track_video(None, None, None, None, str(video),
                           str(tmp_path / "out"))
        return
    _mp4(video)
    bad = cv2.VideoWriter_fourcc(*"XXXX")
    monkeypatch.setattr(cv2, "VideoWriter_fourcc", lambda *a: bad)

    def frames_to_writer(demo, cfg, ext_cfg, source, frames, n, writer,
                         process_fn=None, tick=None):
        for frame in frames:
            writer.write(frame[:, :, ::-1])

    monkeypatch.setattr(gd, "track_frames", frames_to_writer)
    with pytest.raises(RuntimeError, match="mp4v"):
        gd.track_video(None, None, None, None, str(video),
                       str(tmp_path / "out"))
