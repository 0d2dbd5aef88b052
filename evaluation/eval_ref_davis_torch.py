"""Referring-DAVIS evaluation with deva_tpu_torch (PyTorch + CUDA):
score-weighted consensus over sampled frames picks a keyframe, then
bidirectional propagation (backward from the keyframe to frame 0, then
forward from the keyframe to the end) from its soft mask.

The port's counterpart of evaluation/eval_ref_davis.py: the same flags, the
same output (ref_davis palette PNGs of the tmp ids through ResultSaver, and
a key.txt per video). The consensus core's image feature store is shared by
both propagation passes, which step with hard_mask=False,
image_ti_override and delete_buffer=False (the composed path; the store
keeps every frame's features for the video, as deva_tpu and upstream DEVA
do). Its machinery (consensus, run_bidirectional, binary_mask, write_key)
also drives evaluation/eval_ref_youtubevos_torch.py and
eval_saliency_torch.py.

Usage (on the card; --device cpu for the CPU):
  python evaluation/eval_ref_davis_torch.py \\
      --img_path ../DAVIS/2017/trainval/JPEGImages/480p \\
      --mask_path MASKS --output ./out_ref

The model, memory, attention and dtype flags are eval_vos_torch.py's. Each
video runs inside the per-video fault barrier
(deva_tpu_torch/inference/eval_args.py): a video that fails on its data is
logged and skipped, unless --raise_on_error; kernel and device errors
always end the run. FPS counts the propagated frames over the device time
of the consensus votes and the steps (CUDA events on the card).
"""
from __future__ import annotations

import dataclasses
import os
import sys
from argparse import ArgumentParser
from os import path

import numpy as np
import torch

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))
sys.path.insert(0, path.dirname(path.abspath(__file__)))

from deva_tpu_torch.data.referring_test_datasets import \
    ReferringDAVISTestDataset  # noqa: E402
from deva_tpu_torch.data.transforms import resize_prob_to  # noqa: E402
from deva_tpu_torch.inference.consensus import \
    find_consensus_with_established_association  # noqa: E402
from deva_tpu_torch.inference.core import InferenceCore  # noqa: E402
from deva_tpu_torch.inference.eval_args import (  # noqa: E402
    NullSaver, apply_obj_sharding, is_writer, video_fault_barrier)
from deva_tpu_torch.inference.result_saver import ResultSaver  # noqa: E402
from deva_tpu_torch.utils.palette import davis_palette  # noqa: E402
from deva_tpu_torch.utils.prefetch import Prefetcher  # noqa: E402
from eval_vos_torch import (StepTimer, add_common_args,  # noqa: E402
                            base_config, count_usage, load_model,
                            setup_device)


def consensus(store_core: InferenceCore, meta_dataset, vid_name: str,
              num_voting_frames: int, scores, timer: StepTimer,
              reader_args=()):
    """The keyframe and its mask: num_voting_frames frames sampled over the
    video, projected onto one another by store_core's spatial alignment
    (inference/consensus.py, through store_core's feature store), weighted
    by softmax(2 * score) when scores ({frame: score}) are given, else
    (None) the frame with the most confident foreground. timer times the
    vote as a step of no frames. -> (the sampled time indices, the
    keyframe's time index, its soft mask [objects, H, W])."""
    reader = meta_dataset.get_offline_sampled_frames(
        vid_name, *reader_args, num_voting_frames)
    time_indices, images, masks, frame_scores = [], [], [], []
    for ti in range(len(reader)):
        data = reader[ti]
        time_indices.append(data["info"]["time_index"])
        images.append(data["rgb"])
        masks.append(data["mask"])
        if scores is not None:
            frame_scores.append(scores[data["info"]["frame"][:-4]])
    with timer.frames_of(0):
        keyframe_ti, projected_mask = \
            find_consensus_with_established_association(
                time_indices, images, masks, store_core,
                scores=frame_scores if scores is not None else None)
    return time_indices, keyframe_ti, projected_mask


def run_bidirectional(store_core: InferenceCore, meta_dataset, vid_name: str,
                      keyframe_ti: int, projected_mask, save_fn,
                      timer: StepTimer, *, reader_args=(),
                      delete_buffer: bool = False) -> None:
    """Backward (keyframe -> 0, reversed) then forward (keyframe -> end)
    propagation, each pass a fresh InferenceCore on store_core's model,
    config (long-term usage counted by the pass's length) and image feature
    store, seeded by the soft projected_mask at the keyframe
    (eval_ref_davis.py:36-73). Each frame steps with hard_mask=False and
    image_ti_override (its time index), through the composed path; the
    passes shard their objects as store_core does.
    meta_dataset: get_partial_video_loader(vid_name, *reader_args, start=,
    end=, reverse=) -> a reader as VideoReader (items with "rgb" and an
    "info" with "time_index"); save_fn(processor, prob, info) gets each
    frame's probabilities [1 + objects, H, W] on the core's device."""
    for reader in (
            meta_dataset.get_partial_video_loader(
                vid_name, *reader_args, start=-1, end=keyframe_ti + 1,
                reverse=True),
            meta_dataset.get_partial_video_loader(
                vid_name, *reader_args, start=keyframe_ti, end=-1,
                reverse=False)):
        vid_length = len(reader)
        cfg = dataclasses.replace(
            store_core.cfg,
            enable_long_term_count_usage=count_usage(store_core.cfg,
                                                     vid_length))
        processor = InferenceCore(
            store_core.model, cfg, device=store_core.device,
            image_feature_store=store_core.image_feature_store,
            obj_mesh=store_core.obj_mesh, obj_axis=store_core.obj_axis)
        with Prefetcher(reader) as prefetch:
            for ti, data in enumerate(prefetch):
                info = data["info"]
                image_ti = info["time_index"]
                mask = projected_mask if image_ti == keyframe_ti else None
                with timer:
                    prob = processor.step(data["rgb"], mask,
                                          end=(ti == vid_length - 1),
                                          hard_mask=False,
                                          image_ti_override=image_ti,
                                          delete_buffer=delete_buffer)
                save_fn(processor, prob, info)


def binary_mask(prob, info) -> np.ndarray:
    """The foreground of one object's probabilities [2, H, W], resized to
    the frame's shape when it was resized: (prob[1] > prob[0]) as 0/255
    uint8."""
    prob = prob.float().cpu().numpy() if torch.is_tensor(prob) else prob
    if info["need_resize"]:
        prob = resize_prob_to(prob, tuple(info["shape"]))
    return (prob[1] > prob[0]).astype(np.uint8) * 255


def save_png(image: np.ndarray, out_dir: str, frame: str) -> None:
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    Image.fromarray(image).save(path.join(out_dir, frame[:-4] + ".png"))


def write_key(out_dir: str, time_indices, keyframe_ti: int) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(path.join(out_dir, "key.txt"), "w") as f:
        f.write(f"options: {time_indices}; keyframe: {keyframe_ti}")


def report(timer: StepTimer, device: torch.device) -> None:
    print(f"Total processing time: {timer.total_s}")
    print(f"Total processed frames: {timer.frames}")
    if timer.total_s > 0:
        print(f"FPS: {timer.frames / timer.total_s}")
    if device.type == "cuda":
        print("Max allocated memory (MB): "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 20:.1f}")


def make_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--img_path",
                        default="../DAVIS/2017/trainval/JPEGImages/480p")
    parser.add_argument("--mask_path")
    parser.add_argument("--num_voting_frames", type=int, default=5)
    add_common_args(parser)
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    device = setup_device(args)
    model = load_model(args, device)
    obj_mesh, model = apply_obj_sharding(args, model)
    writer = is_writer(args)
    base_cfg = base_config(args)
    out_path = args.output
    meta_dataset = ReferringDAVISTestDataset(args.img_path, args.mask_path,
                                             size=args.size)
    timer = StepTimer(device)

    for vid_name in meta_dataset.get_videos():
        with video_fault_barrier(vid_name, args.raise_on_error):
            store_core = InferenceCore(model, base_cfg, device=device,
                                       obj_mesh=obj_mesh)
            time_indices, keyframe_ti, projected_mask = consensus(
                store_core, meta_dataset, vid_name, args.num_voting_frames,
                meta_dataset.get_scores(vid_name), timer)
            result_savers = []

            def save_fn(processor, prob, info):
                # one saver per pass: the object managers differ
                if not result_savers or result_savers[-1][0] is not \
                        processor:
                    result_savers.append((processor, ResultSaver(
                        out_path, vid_name, dataset="ref_davis",
                        palette=davis_palette(),
                        object_manager=processor.object_manager)
                        if writer else NullSaver()))
                result_savers[-1][1].save_mask(
                    prob, info["frame"], need_resize=info["need_resize"],
                    shape=info["shape"])

            run_bidirectional(store_core, meta_dataset, vid_name,
                              keyframe_ti, projected_mask, save_fn, timer)
            for _, rs in result_savers:
                rs.end()
            if writer:
                write_key(path.join(out_path, vid_name), time_indices,
                          keyframe_ti)
            print(f"{vid_name}: keyframe {keyframe_ti}")

    report(timer, device)


if __name__ == "__main__":
    main()
