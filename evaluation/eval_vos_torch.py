"""Semi-supervised VOS evaluation with deva_tpu_torch (PyTorch + CUDA).

The port's counterpart of evaluation/eval_vos.py, for the generic (G),
DAVIS (D16/D17) and YouTube-VOS (Y18/Y19) layouts: the same flags, the same
output layout (palette PNGs; under Annotations/ for YouTube-VOS or with
--save_scores; the YouTube-VOS zip, and the DAVIS test-dev zip, unless
--save_scores), the same FPS report. Steps are timed with CUDA events on a
CUDA device.

Usage (the example clip, on the card):
  python evaluation/eval_vos_torch.py --dataset G \
      --generic_path ./example/vos --output ./out_torch

--model takes an upstream DEVA .pth state dict or a deva_tpu .npz export;
given neither, the weights are a seeded random init. --device defaults to
cuda and fails when CUDA is absent; pass --device cpu explicitly to run the
plain PyTorch path on the CPU. --chunk N steps maskless stretches N frames
per InferenceCore.step_chunk call; --topk_method approx takes the
threshold-approx attention (`--chunk 5 --topk_method approx` is deva_tpu's
serving configuration). --amp runs the model in bf16 and stores the memory
rings in bf16 (deva_tpu's serving dtypes); --ring_dtype sets the rings'
dtype on its own (float32 or bfloat16; by default bfloat16 with --amp,
else float32), by deva_tpu's rule (deva_tpu/inference/eval_args.py:141-142).
TF32 stays off on the card, so the f32 layers run in true f32 in every
configuration. --use_pallas_attention is accepted for parity with
eval_vos.py and changes nothing: the port has one attention route per
method (deva_tpu_torch/config.py).

--flip propagates the mirrored video and mirrors the probabilities back
after the resize; --save_scores also writes each saved frame's
probabilities as uint8 (Scores/<video>/<frame>.npy, prob * 255 truncated)
and the last frame's {object id: channel} map (backward.npy), the input of
scripts/merge_multi_scale_torch.py. Each video runs inside a fault barrier
(deva_tpu_torch/inference/eval_args.py): a video that fails on its data is
logged and skipped, unless --raise_on_error; kernel and device errors
always end the run.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import time
from argparse import ArgumentParser
from os import path

import numpy as np
import torch

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))

from deva_tpu_torch.config import InferenceConfig, ModelConfig
from deva_tpu_torch.data.transforms import resize_prob_to
from deva_tpu_torch.data.vos_test_datasets import (DAVISTestDataset,
                                                   GeneralVOSTestDataset,
                                                   YouTubeVOSTestDataset)
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.inference.eval_args import video_fault_barrier
from deva_tpu_torch.models.convert import variables_to_state_dict
from deva_tpu_torch.models.network import DEVANetwork, init_weights


def make_parser() -> ArgumentParser:
    """The flags of both VOS drivers (evaluation/eval_vos_batched_torch.py
    adds --batch; get_args adds this driver's --save_scores and --flip)."""
    parser = ArgumentParser()
    parser.add_argument("--d16_path", default="../DAVIS/2016")
    parser.add_argument("--d17_path", default="../DAVIS/2017")
    parser.add_argument("--y18_path", default="../YouTube2018")
    parser.add_argument("--y19_path", default="../YouTube")
    parser.add_argument("--generic_path", default="./example/vos")
    parser.add_argument("--dataset", help="D16/D17/Y18/Y19/G", default="D17")
    parser.add_argument("--split", help="val/test", default="val")
    parser.add_argument("--use_all_masks", action="store_true")
    parser.add_argument("--chunk", type=int, default=1,
                        help="process maskless stretches in blocks of up to "
                        "N frames via InferenceCore.step_chunk; 1 = "
                        "per-frame stepping")
    add_common_args(parser)
    return parser


def add_common_args(parser: ArgumentParser) -> None:
    """The flags every port driver takes (deva_tpu's add_common_eval_args,
    deva_tpu/inference/eval_args.py, without its object sharding and
    profiler): weights, output, device and dtypes, model dims, memory and
    attention, and the per-video fault barrier."""
    parser.add_argument("--model", default="./saves/DEVA-propagation.pth")
    parser.add_argument("--output", default=None)
    parser.add_argument("--save_all", action="store_true",
                        help="Save all frames")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without CUDA) or cpu")
    parser.add_argument("--amp", action="store_true",
                        help="bfloat16 compute and, unless --ring_dtype "
                        "says otherwise, bfloat16 memory rings")
    parser.add_argument("--ring_dtype", default=None,
                        help="memory ring dtype (float32/bfloat16; default "
                        "bfloat16 with --amp, else float32)")
    # model dims
    parser.add_argument("--key_dim", type=int, default=64)
    parser.add_argument("--value_dim", type=int, default=512)
    parser.add_argument("--pix_feat_dim", type=int, default=512)
    # long-term memory
    parser.add_argument("--disable_long_term", action="store_true")
    parser.add_argument("--max_mid_term_frames", type=int, default=10,
                        help="T_max in XMem, decrease to save memory")
    parser.add_argument("--min_mid_term_frames", type=int, default=5,
                        help="T_min in XMem, decrease to save memory")
    parser.add_argument("--max_long_term_elements", type=int, default=10000,
                        help="LT_max in XMem")
    parser.add_argument("--num_prototypes", type=int, default=128,
                        help="P in XMem")
    parser.add_argument("--top_k", type=int, default=30)
    parser.add_argument("--mem_every", type=int, default=5,
                        help="r in XMem; increase to improve speed")
    parser.add_argument("--size", type=int, default=480,
                        help="Resize shorter side to this; -1 keeps original")
    parser.add_argument("--topk_method", default="auto",
                        choices=["auto", "exact", "approx"],
                        help="top-k selection: exact (reference parity) or "
                        "approx (threshold support that contains the exact "
                        "top-k); auto = exact")
    parser.add_argument("--use_pallas_attention", action="store_true",
                        help="accepted for eval_vos.py parity; the port's "
                        "attention route is set by --topk_method alone")
    parser.add_argument("--raise_on_error", action="store_true",
                        help="re-raise per-video errors instead of logging "
                        "and continuing with the next video (kernel and "
                        "device errors always re-raise)")


def get_args(argv=None):
    """This driver's flags: make_parser's, plus the test-time options that
    the batched driver does not take, as in deva_tpu."""
    parser = make_parser()
    parser.add_argument("--save_scores", action="store_true")
    parser.add_argument("--flip", action="store_true")
    return parser.parse_args(argv)


def setup_device(args) -> torch.device:
    """--device as a torch.device; refuses cuda without CUDA, and turns TF32
    off on the card (parity with deva_tpu's f32 needs true f32 convs and
    matmuls)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available "
                         "(pass --device cpu to run on the CPU)")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def base_config(args) -> InferenceConfig:
    """The InferenceConfig of the flags (long-term usage counting is set
    per video by count_usage)."""
    return InferenceConfig(
        mem_every=args.mem_every, top_k=args.top_k,
        enable_long_term=not args.disable_long_term,
        max_mid_term_frames=args.max_mid_term_frames,
        min_mid_term_frames=args.min_mid_term_frames,
        num_prototypes=args.num_prototypes,
        max_long_term_elements=args.max_long_term_elements, size=args.size,
        topk_method=args.topk_method,
        use_pallas_attention=args.use_pallas_attention,
        ring_dtype=args.ring_dtype or ("bfloat16" if args.amp else "auto"))


def count_usage(cfg: InferenceConfig, vid_length: int) -> bool:
    """Count long-term usage only when the video can fill long-term
    memory (upstream DEVA's long-video policy)."""
    return cfg.enable_long_term and (
        vid_length / (cfg.max_mid_term_frames - cfg.min_mid_term_frames) *
        cfg.num_prototypes) >= cfg.max_long_term_elements


def load_model(args, device: torch.device) -> DEVANetwork:
    """Weights from an upstream .pth or a deva_tpu .npz; else random init."""
    mc = ModelConfig(pix_feat_dim=args.pix_feat_dim, key_dim=args.key_dim,
                     value_dim=args.value_dim,
                     dtype="bfloat16" if args.amp else "auto")
    model = DEVANetwork(mc)
    if args.model and path.exists(args.model):
        if args.model.endswith(".npz"):
            with np.load(args.model) as npz:
                sd = variables_to_state_dict(dict(npz))
        else:
            sd = torch.load(args.model, map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
    else:
        print(f"No model loaded ({args.model!r} not found); "
              "using random init.")
        init_weights(model, seed=42)
    return model.to(device).eval()


def make_dataset(args):
    if args.dataset.startswith("Y"):
        yv_path = args.y18_path if args.dataset == "Y18" else args.y19_path
        split = "valid" if args.split == "val" else args.split
        return YouTubeVOSTestDataset(yv_path, split=split, size=args.size)
    if args.dataset == "G":
        return GeneralVOSTestDataset(args.generic_path, size=args.size,
                                     use_all_masks=args.use_all_masks)
    if args.dataset == "D16":
        return DAVISTestDataset(
            args.d16_path, imset="../../2017/trainval/ImageSets/2016/val.txt",
            size=args.size)
    if args.dataset == "D17":
        if args.split == "val":
            return DAVISTestDataset(path.join(args.d17_path, "trainval"),
                                    imset="2017/val.txt", size=args.size)
        return DAVISTestDataset(path.join(args.d17_path, "test-dev"),
                                imset="2017/test-dev.txt", size=args.size)
    raise NotImplementedError(args.dataset)


def save_mask(out_mask: np.ndarray, palette, out_dir: str, frame: str):
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    img = Image.fromarray(out_mask.astype(np.uint8))
    if palette is not None:
        img.putpalette(palette)
    img.save(path.join(out_dir, frame[:-4] + ".png"))


class VideoSaver:
    """One video's files, in eval_vos.py's layout: palette PNGs under
    out_path/<video>/, and (--save_scores) uint8 score maps and the
    backward map under scores_path/<video>/."""

    def __init__(self, out_path: str, scores_path: str, vid_name: str,
                 palette):
        self.mask_dir = path.join(out_path, vid_name)
        self.scores_dir = path.join(scores_path, vid_name)
        self.palette = palette

    def save_mask(self, out_mask: np.ndarray, frame: str) -> None:
        save_mask(out_mask, self.palette, self.mask_dir, frame)

    def save_scores(self, scores: np.ndarray, frame: str) -> None:
        os.makedirs(self.scores_dir, exist_ok=True)
        np.save(path.join(self.scores_dir, frame[:-4] + ".npy"), scores)

    def save_backward(self, mapping: dict) -> None:
        os.makedirs(self.scores_dir, exist_ok=True)
        np.save(path.join(self.scores_dir, "backward.npy"), mapping,
                allow_pickle=True)


class StepTimer:
    """Device time of the timed steps: CUDA events on a CUDA device (summed
    after one synchronize per step), the host clock on the CPU. A step
    counts one frame, or n after frames_of(n). steps_ms keeps each step's
    milliseconds in order."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.total_s = 0.0
        self.frames = 0
        self.steps_ms = []
        self._count = 1

    def frames_of(self, n: int) -> "StepTimer":
        self._count = n
        return self

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._end.record()
            self._end.synchronize()
            ms = self._start.elapsed_time(self._end)
        else:
            ms = (time.perf_counter() - self._t0) * 1000.0
        self.steps_ms.append(ms)
        self.total_s += ms / 1000.0
        self.frames += self._count
        self._count = 1
        return False


def run_video(processor: InferenceCore, reader, args, saver,
              timer: "StepTimer") -> None:
    """One video through the processor, as eval_vos.py's loop and _emit
    (:42-80) run it. reader: len() and reader[i] -> {"rgb": [H, W, 3] f32,
    "mask" and "valid_labels" where a mask is given, "info": {"frame",
    "shape", "need_resize", "save"}} (as VideoReader); saver: save_mask,
    save_scores, save_backward (as VideoSaver); timer: a StepTimer, entered
    around each step. Frames before the first mask are skipped. --flip
    steps the mirrored frame and mask (copies: torch takes no negative
    strides) and mirrors the probabilities back after the resize."""
    vid_length = len(reader)

    def emit(ti, data, prob):
        info = data["info"]
        prob = prob.cpu().numpy()
        if info["need_resize"]:
            prob = resize_prob_to(prob, tuple(info["shape"]))
        if args.flip:
            prob = prob[..., ::-1]
        out_mask = processor.object_manager.tmp_cls_to_obj_cls(
            np.argmax(prob, axis=0))
        saved = args.save_all or info["save"]
        if saved:
            saver.save_mask(out_mask, info["frame"])
        if args.save_scores:
            if ti == vid_length - 1:
                saver.save_backward(
                    {o.id: t for t, o in
                     processor.object_manager.tmp_id_to_obj.items()})
            if saved:
                saver.save_scores((prob * 255).astype(np.uint8),
                                  info["frame"])

    pending = []  # buffered (ti, data) of maskless frames for step_chunk

    def flush(end: bool):
        if not pending:
            return
        with timer.frames_of(len(pending)):
            probs = processor.step_chunk([d["rgb"] for _, d in pending],
                                         end=end)
        for (ti, data), prob in zip(pending, probs):
            emit(ti, data, prob)
        pending.clear()

    first_mask_loaded = False
    for ti in range(vid_length):
        data = reader[ti]
        mask = data.get("mask")
        if not first_mask_loaded:
            if mask is None:
                continue
            first_mask_loaded = True
        if args.flip:
            data["rgb"] = np.asarray(data["rgb"])[:, ::-1].copy()
            if mask is not None:
                mask = np.asarray(mask)[..., ::-1].copy()
        if args.chunk > 1 and mask is None:
            pending.append((ti, data))
            if len(pending) >= args.chunk or ti == vid_length - 1:
                flush(end=ti == vid_length - 1)
            continue
        flush(end=False)
        labels = data.get("valid_labels")
        labels = None if labels is None else [int(v) for v in labels]

        with timer:
            prob = processor.step(data["rgb"], mask, labels,
                                  end=(ti == vid_length - 1))
        emit(ti, data, prob)
    flush(end=True)  # the video is over: any straggler ends it


def main(argv=None):
    args = get_args(argv)
    args.dataset = args.dataset.upper()
    device = setup_device(args)
    model = load_model(args, device)
    if args.output is None:
        args.output = f"../output/{args.dataset}_{args.split}"
        print(f"Output path not provided. Defaulting to {args.output}")
    is_youtube = args.dataset.startswith("Y")
    is_davis = args.dataset.startswith("D")
    out_path = path.join(args.output, "Annotations") if \
        (is_youtube or args.save_scores) else args.output
    meta_dataset = make_dataset(args)
    if args.dataset == "G" and not args.save_all:
        args.save_all = True
        print("save_all is forced to be true in generic mode.")

    base_cfg = base_config(args)
    timer = StepTimer(device)

    for vid_reader in meta_dataset.get_datasets():
        vid_name = vid_reader.vid_name
        vid_length = len(vid_reader)
        cfg = dataclasses.replace(
            base_cfg,
            enable_long_term_count_usage=count_usage(base_cfg, vid_length))
        processor = InferenceCore(model, cfg, device=device)
        saver = VideoSaver(out_path, path.join(args.output, "Scores"),
                           vid_name, vid_reader.get_palette())
        print(f"{vid_name} ({vid_length} frames)")
        with video_fault_barrier(vid_name, args.raise_on_error):
            run_video(processor, vid_reader, args, saver, timer)

    print(f"Total processing time: {timer.total_s}")
    print(f"Total processed frames: {timer.frames}")
    if timer.total_s > 0:
        print(f"FPS: {timer.frames / timer.total_s}")
    if device.type == "cuda":
        print("Max allocated memory (MB): "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 20:.1f}")

    if not args.save_scores:
        if is_youtube:
            print("Making zip for YouTubeVOS...")
            shutil.make_archive(path.join(args.output,
                                          path.basename(args.output)),
                                "zip", args.output, "Annotations")
        elif is_davis and args.split == "test":
            print("Making zip for DAVIS test-dev...")
            shutil.make_archive(args.output, "zip", args.output)


if __name__ == "__main__":
    main()
