"""The port's stage driver (deva_tpu_torch/training/train.py) on the CPU,
as tests/test_train_driver.py drives deva_tpu's: stage 0 on a synthetic
static tree for 3 iterations with weights exports, a checkpoint and a
training grid logged, then a resume from that checkpoint to 4; and
--stages 03, whose stage-0 weights hand off in memory to a stage-3
trainer stepping on the VOS mixture. The
command line keeps deva_tpu's flags and defaults but for its multi-host
ones, and adds --device; cuda without CUDA raises, in the driver and in
toy.train_toy."""
import glob
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from deva_tpu.training.configuration import Configuration as JaxConfiguration

from deva_tpu_torch.training import toy
from deva_tpu_torch.training.configuration import Configuration
from deva_tpu_torch.training.train import main
from deva_tpu_torch.utils.load_subset import load_sub_davis, load_sub_yv

torch.set_num_threads(2)

TINY = ["--pix_feat_dim", "64", "--key_dim", "16", "--value_dim", "32",
        "--crop_size", "64", "--num_workers", "0", "--device", "cpu"]
DROPPED = {"multihost", "coordinator_address", "num_processes",
           "process_id", "n_devices"}


@pytest.fixture()
def static_root(tmp_path):
    root = tmp_path / "static"
    rng = np.random.default_rng(0)
    os.makedirs(root / "fss" / "classA")
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (72, 96, 3), np.uint8)).save(
            root / "fss" / "classA" / f"{i}.jpg")
        gt = np.zeros((72, 96), np.uint8)
        gt[20:50, 30:70] = 255
        Image.fromarray(gt).save(root / "fss" / "classA" / f"{i}.png")
    for sub in ("DUTS-TR", "DUTS-TE", "ecssd", "BIG_small", "HRSOD_small"):
        os.makedirs(root / sub)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (64, 80, 3), np.uint8)
                            ).save(root / sub / f"{i}.jpg")
            gt = np.zeros((64, 80), np.uint8)
            gt[10:40, 20:60] = 255
            Image.fromarray(gt).save(root / sub / f"{i}.png")
    return str(root)


def _mini_video(root, vid, seed, n_frames=5, hw=(64, 80)):
    rng = np.random.default_rng(seed)
    for kind in ("JPEGImages", "Annotations"):
        os.makedirs(os.path.join(root, kind, vid), exist_ok=True)
    for i in range(n_frames):
        Image.fromarray(rng.integers(0, 255, (*hw, 3), np.uint8)).save(
            os.path.join(root, "JPEGImages", vid, f"{i:05d}.jpg"))
        gt = np.zeros(hw, np.uint8)
        gt[10:40, 20:50] = 1
        gt[45:60, 55:75] = 2
        Image.fromarray(gt, mode="P").save(
            os.path.join(root, "Annotations", vid, f"{i:05d}.png"))


def test_stage0_save_and_resume(static_root, tmp_path, monkeypatch, capsys):
    from deva_tpu_torch.utils import image_saver
    grids = []
    real_pool = image_saver.pool_pairs

    def pool(batch, outputs, **kwargs):
        grids.append(real_pool(batch, outputs, **kwargs))
        return grids[-1]

    monkeypatch.setattr(image_saver, "pool_pairs", pool)
    monkeypatch.chdir(tmp_path)
    stage0 = ["--stages", "0", "--static_root", static_root,
              "--s0_batch_size", "4", "--s0_num_frames", "3",
              "--s0_num_ref_frames", "1"] + TINY
    main(stage0 + ["--exp_id", "smoke", "--s0_iterations", "3",
                   "--log_text_interval", "1", "--log_image_interval", "2",
                   "--save_network_interval", "2",
                   "--save_checkpoint_interval", "2"])
    out = capsys.readouterr().out
    assert "train/total_loss" in out and "train/grad_norm" in out
    # one training grid (eval_outputs, pool_pairs) at iteration 2: 4 rows
    # of 384 pixels, 3 frames of (image | gt | prediction)
    assert [g.shape for g in grids] == [(4 * 3 * 384, 3 * 384, 3)]
    assert glob.glob(str(tmp_path / ".runs" / "*" / "events.out.*"))
    nets = glob.glob(str(tmp_path / "saves" / "*" / "*_0K.pth"))
    assert len(nets) == 1
    sd = torch.load(nets[0], weights_only=True)
    assert "mask_decoder.sensory_linear_pred.projection.weight" in sd
    ckpts = glob.glob(str(tmp_path / "saves" / "*" / "*_checkpoint_2.pth"))
    assert len(ckpts) == 1
    state = torch.load(ckpts[0], weights_only=True)
    assert state["it"] == 2 and {"network", "optimizer", "scheduler"} <= \
        state.keys()

    final = main(stage0 + ["--exp_id", "NULL", "--s0_iterations", "4",
                           "--load_checkpoint", ckpts[0]])
    out = capsys.readouterr().out
    assert "optimizer states, and step loaded" in out
    assert final.keys() == sd.keys()
    assert all(torch.isfinite(v.float()).all() for v in final.values())


def test_stage_handoff(static_root, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    yv_root, davis_root, ovis_root = (tmp_path / n for n in
                                      ("yv", "davis", "ovis"))
    davis_vid = sorted(load_sub_davis())[0]
    _mini_video(str(yv_root / "train"), sorted(load_sub_yv())[0], 2)
    base = davis_root / "2017" / "trainval"
    _mini_video(str(base), davis_vid, 3)
    for kind in ("JPEGImages", "Annotations"):
        os.makedirs(base / kind / "480p")
        shutil.move(str(base / kind / davis_vid),
                    str(base / kind / "480p" / davis_vid))
    _mini_video(str(ovis_root), "vid0", 4)

    main(["--stages", "03", "--static_root", static_root,
          "--yv_root", str(yv_root), "--davis_root", str(davis_root),
          "--ovis_root", str(ovis_root), "--exp_id", "handoff",
          "--s0_batch_size", "4", "--s0_iterations", "2",
          "--s0_num_frames", "3", "--s0_num_ref_frames", "1",
          "--s3_batch_size", "4", "--s3_iterations", "3",
          "--s3_num_frames", "3", "--s3_num_ref_frames", "1",
          "--log_text_interval", "1", "--log_image_interval", "100",
          "--save_network_interval", "2",
          "--save_checkpoint_interval", "100"] + TINY)
    out = capsys.readouterr().out
    assert "Loading weights from the previous stage" in out
    assert "Renewed loaders with max_skip=5" in out
    assert "it      3 train/total_loss" in out
    assert glob.glob(str(tmp_path / "saves" / "*handoff-s0" / "*_0K.pth"))


def test_configuration_matches_deva_tpu():
    ours, ref = Configuration(), JaxConfiguration()
    ours.parse([])
    ref.parse([])
    expected = {k: v for k, v in ref.args.items() if k not in DROPPED}
    expected["device"] = "cuda"
    assert ours.args == expected
    for stage in "03":
        assert ours.get_stage_parameters(stage) == \
            ref.get_stage_parameters(stage)


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        main(["--stages", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        toy.train_toy(steps=1)
