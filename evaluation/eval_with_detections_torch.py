"""Detection-driven evaluation with deva_tpu_torch (PyTorch + CUDA):
VIPSeg, BURST, unsupervised DAVIS-17 and demo layouts, in the online and
semi-online temporal settings.

The port's counterpart of evaluation/eval_with_detections.py: the same
detection flags, the same per-frame state machine (semi-online: buffer
frames until the voting frame, run the in-clip consensus vote with the
first buffered frame as keyframe, incorporate the consensus into it and
propagate the rest of the buffer; online: incorporate the frame's own
detections every --detection_every frames and propagate the others), the
same outputs (pan_pred PNGs and pred.json for vipseg, then the stuff merge
and VPQ/STQ; a pred.json per video for burst; JSONFiles for demo;
limit_max_id for unsup_davis17). np.random.seed(42) is kept, so PNG
colours follow the object ids as in deva_tpu's driver.

Usage (the example clip, on the card; --device cpu for the CPU):
  python evaluation/eval_with_detections_torch.py --dataset vipseg \\
      --img_path ./example/vipseg/images --mask_path ./example/vipseg/source \\
      --output ./out_det --no_metrics [--temporal_setting online]

The model, memory, attention and dtype flags are eval_vos_torch.py's
(--model takes an upstream .pth or a deva_tpu .npz; without one the weights
are a seeded random init). --device defaults to cuda and fails when CUDA is
absent; TF32 stays off on the card. --obj_shards N shards each video's
objects over N processes under torchrun (process 0 writes; see
eval_vos_torch.py). Not carried over from deva_tpu's driver: --profile (the
JAX profiler).
Each video runs inside the per-video fault barrier
(deva_tpu_torch/inference/eval_args.py): a video that fails on its data is
logged, left out of pred.json and skipped, unless --raise_on_error; kernel
and device errors always end the run. FPS counts the processed frames over
the device time of their steps, from CUDA events on the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from argparse import ArgumentParser
from multiprocessing import get_context
from os import path

import numpy as np
import torch

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))
sys.path.insert(0, path.dirname(path.abspath(__file__)))

from deva_tpu_torch.config import InferenceConfig  # noqa: E402
from deva_tpu_torch.data.vps_test_datasets import (  # noqa: E402
    BURSTDetectionTestDataset, VIPSegDetectionTestDataset)
from deva_tpu_torch.inference.core import InferenceCore  # noqa: E402
from deva_tpu_torch.inference.eval_args import (  # noqa: E402
    NullSaver, apply_obj_sharding, is_writer, video_fault_barrier)
from deva_tpu_torch.inference.frame_utils import FrameInfo  # noqa: E402
from deva_tpu_torch.inference.object_utils import \
    convert_json_dict_to_objects_info  # noqa: E402
from deva_tpu_torch.inference.postprocess_unsup_davis17 import \
    limit_max_id  # noqa: E402
from deva_tpu_torch.inference.result_saver import ResultSaver  # noqa: E402
from deva_tpu_torch.utils.prefetch import Prefetcher  # noqa: E402
from eval_vos_torch import (StepTimer, add_common_args,  # noqa: E402
                            base_config, count_usage, load_model,
                            setup_device)


def make_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--img_path", default="./example/vipseg")
    parser.add_argument("--mask_path")
    parser.add_argument("--json_path", default=None)
    parser.add_argument("--detection_every", type=int, default=5)
    parser.add_argument("--num_voting_frames", type=int, default=3)
    parser.add_argument("--dataset", default="vipseg",
                        help="vipseg/burst/unsup_davis17/demo")
    parser.add_argument("--max_missed_detection_count", type=int, default=5)
    parser.add_argument("--no_metrics", action="store_true")
    parser.add_argument("--temporal_setting", default="semionline",
                        help="semionline/online")
    parser.add_argument("--max_num_objects", type=int, default=-1)
    parser.add_argument("--start", type=int, default=None)
    parser.add_argument("--count", type=int, default=None)
    parser.add_argument("--burst_gt_json",
                        default="../BURST/val/all_classes.json")
    parser.add_argument("--vipseg_root", default="../VIPSeg/VIPSeg_720P")
    parser.add_argument("--postprocess_limit_max_id", type=int, default=20)
    add_common_args(parser)
    return parser


def detection_config(args) -> InferenceConfig:
    """The InferenceConfig of the flags (long-term usage counting is set
    per video by video_processor)."""
    return dataclasses.replace(
        base_config(args),
        max_missed_detection_count=args.max_missed_detection_count,
        max_num_objects=args.max_num_objects,
        detection_every=args.detection_every,
        num_voting_frames=args.num_voting_frames)


def video_processor(model, cfg: InferenceConfig, vid_length: int,
                    device, obj_mesh=None) -> InferenceCore:
    """A fresh InferenceCore for one video of vid_length frames (its
    objects sharded over obj_mesh, when given)."""
    return InferenceCore(model, dataclasses.replace(
        cfg, enable_long_term_count_usage=count_usage(cfg, vid_length)),
        device=device, obj_mesh=obj_mesh)


def run_video(vid_reader, processor, result_saver, args, timer,
              dataset_name, segments_of):
    """One video through the state machine. vid_reader: len() and
    reader[i] -> {"rgb": [H, W, 3] f32, "mask": id mask or None, "info":
    {"frame", "shape", "need_resize", "save", "is_rgb", ...}} (as
    DetectionVideoReader); result_saver: save_mask(prob, frame name,
    need_resize=, shape=, path_to_image=); timer: a StepTimer, entered
    around each step of the device (in semi-online, a vote and its
    incorporation are one step). segments_of(ti, mask, info) ->
    (segments_info json or None, whether ids are long)."""
    vid_length = len(vid_reader)
    next_voting_frame = args.num_voting_frames - 1
    semionline = args.temporal_setting.lower() == "semionline"

    def timed(fn, *a, **kw):
        with timer:
            return fn(*a, **kw)

    def save(prob, frame_info):
        if frame_info.save_needed:
            result_saver.save_mask(
                prob, frame_info.name,
                need_resize=frame_info.info["need_resize"],
                shape=frame_info.shape,
                path_to_image=frame_info.path_to_image)

    with Prefetcher(vid_reader) as prefetch:
        # frame ti+1 (image, detection PNG, JSON path) decodes while the
        # device works on frame ti
        for ti, data in enumerate(prefetch):
            image, mask, info = data["rgb"], data.get("mask"), data["info"]
            if args.save_all:
                info["save"] = True
            if info["is_rgb"]:
                processor.enabled_long_id()
            segments_info_json, long_ids = segments_of(ti, mask, info)
            if long_ids:
                processor.enabled_long_id()
            segments_info = convert_json_dict_to_objects_info(
                mask, segments_info_json, dataset=dataset_name)
            frame_info = FrameInfo(image, mask, segments_info, ti, info)
            last = ti == vid_length - 1

            if semionline:
                if ti + args.num_voting_frames > next_voting_frame:
                    processor.add_to_temporary_buffer(frame_info)
                    if ti == next_voting_frame:
                        buf0 = processor.frame_buffer[0]

                        def vote_and_incorporate():
                            _, consensus_mask, new_segments_info = \
                                processor.vote_in_temporary_buffer(
                                    keyframe_selection="first")
                            return processor.incorporate_detection(
                                buf0.image, consensus_mask,
                                new_segments_info)

                        prob = timed(vote_and_incorporate)
                        next_voting_frame += args.detection_every
                        if next_voting_frame >= vid_length:
                            next_voting_frame = (vid_length +
                                                 args.num_voting_frames)
                        save(prob, buf0)
                        for fi in processor.frame_buffer[1:]:
                            prob = timed(processor.step, fi.image,
                                         end=fi.ti == vid_length - 1)
                            save(prob, fi)
                        processor.clear_buffer()
                else:
                    save(timed(processor.step, image, end=last), frame_info)
            else:  # online
                if ti % args.detection_every == 0:
                    if mask is None:
                        raise ValueError(f"frame {ti} of {vid_reader.vid_name}"
                                         ": no detection mask")
                    prob = timed(processor.incorporate_detection, image, mask,
                                 segments_info)
                else:
                    prob = timed(processor.step, image, end=last)
                save(prob, frame_info)


def main(argv=None):
    np.random.seed(42)  # for id2rgb (reference:eval_with_detections.py:29)
    args = make_parser().parse_args(argv)
    device = setup_device(args)
    model = load_model(args, device)
    obj_mesh, model = apply_obj_sharding(args, model)
    writer = is_writer(args)

    temporal_setting = args.temporal_setting.lower()
    assert temporal_setting in ("semionline", "online")
    dataset_name = args.dataset.lower()
    assert dataset_name in ("vipseg", "burst", "unsup_davis17", "demo")
    is_vipseg = dataset_name == "vipseg"
    is_burst = dataset_name == "burst"
    is_davis = dataset_name == "unsup_davis17"
    is_demo = dataset_name == "demo"

    if args.json_path is None and path.exists(
            path.join(args.mask_path, "pred.json")):
        args.json_path = path.join(args.mask_path, "pred.json")
    out_path = args.output
    if path.exists(path.join(args.mask_path, "pan_pred")):
        args.mask_path = path.join(args.mask_path, "pan_pred")

    if is_burst:
        meta_dataset = BURSTDetectionTestDataset(
            args.img_path, args.mask_path, args.burst_gt_json, args.size,
            start=args.start, count=args.count)
    else:
        meta_dataset = VIPSegDetectionTestDataset(args.img_path,
                                                  args.mask_path, args.size)

    video_id_to_annotation = None
    if args.json_path is not None:
        print(f"Using a global json file {args.json_path}")
        with open(args.json_path) as f:
            video_id_to_annotation = {
                ann["video_id"]: ann["annotations"]
                for ann in json.load(f)["annotations"]}
    per_vid_json = [None]  # decided on the first frame that is read

    base_cfg = detection_config(args)
    timer = StepTimer(device)
    output_json_annotations = []

    for vid_reader in meta_dataset.get_datasets():
        vid_name = vid_reader.vid_name
        vid_length = len(vid_reader)
        processor = video_processor(model, base_cfg, vid_length, device,
                                    obj_mesh)
        result_saver = ResultSaver(out_path, vid_name, dataset=dataset_name,
                                   palette=vid_reader.palette,
                                   object_manager=processor.object_manager) \
            if writer else NullSaver()
        print(f"{vid_name} ({vid_length} frames)")

        def segments_of(ti, mask, info):
            if video_id_to_annotation is not None:
                return (video_id_to_annotation[vid_name][ti]["segments_info"],
                        True)
            json_path = info.get("json")
            if per_vid_json[0] is None:
                per_vid_json[0] = json_path is not None
                print("Using per-video json." if per_vid_json[0] else
                      "Neither global nor per-video json exist.")
            elif json_path is None and per_vid_json[0]:
                raise RuntimeError(f"Per-video json not found for {vid_name}.")
            if not per_vid_json[0]:
                return None, False
            with open(json_path) as f:
                return json.load(f), True

        barrier = video_fault_barrier(vid_name, args.raise_on_error)
        with barrier:
            run_video(vid_reader, processor, result_saver, args, timer,
                      dataset_name, segments_of)
        result_saver.end()
        if barrier.failed or not writer:
            continue
        if is_vipseg:
            output_json_annotations.append(result_saver.video_json)
        elif is_burst:
            os.makedirs(path.join(out_path, vid_name), exist_ok=True)
            with open(path.join(out_path, vid_name, "pred.json"), "w") as f:
                json.dump(result_saver.video_json, f)
        elif is_demo:
            os.makedirs(path.join(out_path, "JSONFiles"), exist_ok=True)
            with open(path.join(out_path, "JSONFiles",
                                f"{vid_name}.json"), "w") as f:
                json.dump(result_saver.video_json, f, indent=4)

    if is_vipseg and writer:
        with open(path.join(out_path, "pred.json"), "w") as f:
            json.dump({"annotations": output_json_annotations}, f)

    print(f"Total processing time: {timer.total_s}")
    print(f"Total processed frames: {timer.frames}")
    if timer.total_s > 0:
        print(f"FPS: {timer.frames / timer.total_s}")
    if device.type == "cuda":
        print("Max allocated memory (MB): "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 20:.1f}")

    if not writer:
        return
    if is_vipseg:
        from deva_tpu_torch.metrics.stuff_merging import merge_stuff
        print("Starting evaluation...")
        merge_stuff(out_path, out_path)
        if not args.no_metrics:
            from deva_tpu_torch.metrics.eval_stq_vipseg import eval_stq
            from deva_tpu_torch.metrics.eval_vpq_vipseg import eval_vpq
            root = args.vipseg_root
            gt = (f"{root}/panomasksRGB",
                  f"{root}/panoptic_gt_VIPSeg_val.json")
            stq = get_context("spawn").Process(target=eval_stq,
                                               args=(out_path, *gt))
            stq.start()
            eval_vpq(out_path, *gt, num_processes=16)
            stq.join()
            if stq.exitcode != 0:
                raise RuntimeError(f"STQ evaluation failed ({stq.exitcode})")
    elif is_davis and args.postprocess_limit_max_id > 0:
        print("Post-processing DAVIS 2017...")
        limit_max_id(out_path, out_path,
                     max_num_objects=args.postprocess_limit_max_id)


if __name__ == "__main__":
    main()
