"""Batched semi-supervised VOS evaluation with deva_tpu_torch (PyTorch + CUDA):
videos are grouped into lockstep batches and propagated B at a time by
deva_tpu_torch/inference/batched.py (one batch-B model call per stage, one
launch of each attention kernel per lockstep frame).

The port's counterpart of evaluation/eval_vos_batched.py, for the generic
(G), DAVIS (D16/D17) and YouTube-VOS (Y18/Y19: masks under Annotations/,
then the zip) layouts, with eval_vos_torch.make_parser's flags plus --batch
(--flip and --save_scores are the single-stream driver's only, as in
deva_tpu). Each group, and each video run alone, is one unit of the
per-video fault barrier (--raise_on_error).

Grouping: videos are lockstepped only with videos of the same processed
frame shape, the same object-count bucket (pad_objects) and the
same long-term usage-counting policy. Videos whose masks arrive after
their first frame (YouTube-VOS style: a new object appears at frame t > 0)
are grouped by frame shape and usage policy and run in lockstep by
run_group_midstream, through deva_tpu_torch/inference/batched_detection.py
(multi-bucket memory, per-video write cadences); a group of one runs the
sequential path (InferenceCore.step per frame), as do videos with no
reachable mask. In a first-frame group, the first frame's output is its
ground-truth mask; shorter videos replay their last frame until the group
ends and those outputs are discarded. `end` semantics (no memory write, no
sensory update on the final frame) only change state that later frames
read, so the per-frame outputs are those of the sequential driver.

Usage (the example clip, on the card; --device cpu for the CPU):
  python evaluation/eval_vos_batched_torch.py --dataset G \
      --generic_path ./example/vos --output ./out_batched --batch 4

Steps are timed with CUDA events on a CUDA device (the host clock on the
CPU), and the report gives the aggregate video-frames per second. TF32 stays
off on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import shutil
import sys
from os import path

import numpy as np
import torch

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))
sys.path.insert(0, path.dirname(path.abspath(__file__)))

from deva_tpu_torch.data.transforms import resize_prob_to  # noqa: E402
from deva_tpu_torch.inference.batched import BatchedPropagator  # noqa: E402
from deva_tpu_torch.inference.batched_detection import \
    BatchedDetectionPropagator  # noqa: E402
from deva_tpu_torch.inference.core import InferenceCore  # noqa: E402
from deva_tpu_torch.inference.eval_args import \
    video_fault_barrier  # noqa: E402
from deva_tpu_torch.utils.prefetch import Prefetcher  # noqa: E402
from eval_vos_torch import (StepTimer, base_config, count_usage,  # noqa
                            load_model, make_dataset, make_parser, save_mask,
                            setup_device)


def save_frame(out_path, reader, info, prob, object_manager) -> None:
    """One output PNG: prob [1 + num_obj, H, W] (tensor or array) resized
    to the frame's shape when it was resized, argmax, object ids."""
    if torch.is_tensor(prob):
        prob = prob.cpu().numpy()
    if info["need_resize"]:
        prob = resize_prob_to(prob, tuple(info["shape"]))
    out_mask = object_manager.tmp_cls_to_obj_cls(np.argmax(prob, axis=0))
    save_mask(out_mask, reader.get_palette(),
              path.join(out_path, reader.vid_name), info["frame"])


def run_sequential(model, cfg, reader, out_path, save_all, timer) -> None:
    """The single-stream path, for videos that cannot be lockstepped."""
    processor = InferenceCore(model, cfg)
    first_mask_loaded = False
    for ti in range(len(reader)):
        data = reader[ti]
        mask = data.get("mask")
        if not first_mask_loaded:
            if mask is None:
                continue
            first_mask_loaded = True
        labels = data.get("valid_labels")
        labels = None if labels is None else [int(v) for v in labels]
        with timer:
            prob = processor.step(data["rgb"], mask, labels,
                                  end=(ti == len(reader) - 1))
        if save_all or data["info"]["save"]:
            save_frame(out_path, reader, data["info"], prob,
                       processor.object_manager)


def run_group(model, cfg, readers, out_path, save_all, timer) -> None:
    """Lockstep-propagate a group of same-shaped videos."""
    first = [r[0] for r in readers]
    images0 = [d["rgb"] for d in first]
    masks0 = [np.asarray(d["mask"], np.int64) for d in first]
    objects = [[int(v) for v in d["valid_labels"]] for d in first]

    bp = BatchedPropagator(model, cfg)
    with timer.frames_of(len(readers)):
        bp.initialize(images0, masks0, objects)
    for vi, (r, d) in enumerate(zip(readers, first)):
        if save_all or d["info"]["save"]:
            # the first-frame output is the (hard) ground-truth mask itself
            prob = np.zeros((len(objects[vi]) + 1,) + masks0[vi].shape,
                            np.float32)
            for oi, obj in enumerate(objects[vi]):
                prob[oi + 1] = masks0[vi] == obj
            prob[0] = 1.0 - prob[1:].sum(0)
            save_frame(out_path, r, d["info"], prob,
                       bp.cores[vi].object_manager)

    lengths = [len(r) for r in readers]
    max_len = max(lengths)
    if not bp.use_lt:
        bp.reserve(max_len // cfg.mem_every + 2)
    last = list(images0)
    with contextlib.ExitStack() as stack:
        # per-video background decode: frame ti+1 loads while the device
        # propagates frame ti
        iters = [iter(stack.enter_context(Prefetcher(r, start=1)))
                 for r in readers]
        for ti in range(1, max_len):
            datas = [next(iters[vi], None) if ti < lengths[vi] else None
                     for vi in range(len(readers))]
            for vi, d in enumerate(datas):
                if d is not None:
                    last[vi] = d["rgb"]
            live = sum(d is not None for d in datas)
            with timer.frames_of(live):
                probs = bp.step_all(last, end=(ti == max_len - 1))
            for vi, d in enumerate(datas):
                if d is not None and (save_all or d["info"]["save"]):
                    save_frame(out_path, readers[vi], d["info"],
                               probs[vi][:len(objects[vi]) + 1],
                               bp.cores[vi].object_manager)


def run_group_midstream(model, cfg, readers, out_path, save_all,
                        timer) -> None:
    """Lockstep a group of same-shaped videos whose ground-truth masks
    arrive mid-stream. The mask ticks are known up front (a file-existence
    probe): on a tick where any video receives a mask, every started video
    steps through its own core (merge, forced memory write, maybe a new
    bucket), so every clock advances once; the spans between ticks run
    through BatchedDetectionPropagator.step_block by plan_block, with
    per-video write cadences, re-attaching when the set of started videos
    changes. A video's frames before its first mask are skipped, and a
    video shorter than the group replays its last frame, whose outputs are
    discarded."""
    b = len(readers)
    cores = [InferenceCore(model, cfg) for _ in range(b)]
    bp = BatchedDetectionPropagator(model, cfg)
    lengths = [len(r) for r in readers]
    max_len = max(lengths)
    started = [False] * b
    last = [None] * b
    attached = []
    event_ticks = sorted({t for vi, r in enumerate(readers)
                          for t in r.mask_frame_indices()
                          if t < lengths[vi]})

    def save(vi, d, prob):
        if save_all or d["info"]["save"]:
            save_frame(out_path, readers[vi], d["info"], prob,
                       cores[vi].object_manager)

    def fetch(iters, ti):
        datas = [next(iters[vi], None) if ti < lengths[vi] else None
                 for vi in range(b)]
        for vi, d in enumerate(datas):
            if d is not None:
                last[vi] = d["rgb"]
        return datas

    with contextlib.ExitStack() as stack:
        iters = [iter(stack.enter_context(Prefetcher(r))) for r in readers]
        ti = 0
        while ti < max_len:
            if ti in event_ticks:
                datas = fetch(iters, ti)
                if attached:
                    bp.detach()
                    attached = []
                for vi, d in enumerate(datas):
                    event = d is not None and d.get("mask") is not None
                    if d is None or not (event or started[vi]):
                        continue
                    labels = [int(v) for v in d["valid_labels"]] \
                        if event else None
                    with timer:
                        prob = cores[vi].step(
                            d["rgb"], d["mask"] if event else None, labels,
                            end=ti == lengths[vi] - 1)
                    started[vi] = True
                    save(vi, d, prob)
                ti += 1
                continue
            active = [vi for vi in range(b) if started[vi]]
            if not active:
                fetch(iters, ti)  # keep the iterators tick-aligned
                ti += 1
                continue
            if attached != active:
                if attached:
                    bp.detach()
                bp.attach([cores[vi] for vi in active])
                attached = active
            next_stop = min([t for t in event_ticks if t > ti] + [max_len])
            k = bp.plan_block(min(next_stop - ti, cfg.mem_every))
            block = [fetch(iters, ti + i) for i in range(k)]
            frames = [np.stack([block[i][vi]["rgb"] if block[i][vi]
                                is not None else last[vi]
                                for i in range(k)]) for vi in active]
            live = sum(block[i][vi] is not None for i in range(k)
                       for vi in active)
            with timer.frames_of(live):
                probs = bp.step_block(frames, end=ti + k == max_len)
            for i in range(k):
                for bi, vi in enumerate(active):
                    d = block[i][vi]
                    if d is not None:  # else replayed past its end
                        n = cores[vi].object_manager.num_obj
                        save(vi, d, probs[bi, i, :n + 1])
            ti += k
        if attached:
            bp.detach()


def main(argv=None):
    parser = make_parser()
    parser.add_argument("--batch", type=int, default=4,
                        help="videos per lockstep group")
    args = parser.parse_args(argv)
    args.dataset = args.dataset.upper()
    device = setup_device(args)
    model = load_model(args, device)
    if args.output is None:
        args.output = f"../output/{args.dataset}_{args.split}"
        print(f"Output path not provided. Defaulting to {args.output}")
    is_youtube = args.dataset.startswith("Y")
    out_path = path.join(args.output, "Annotations") if is_youtube \
        else args.output
    meta_dataset = make_dataset(args)
    if args.dataset == "G" and not args.save_all:
        args.save_all = True
        print("save_all is forced to be true in generic mode.")
    base_cfg = base_config(args)
    timer = StepTimer(device)

    # group keys from each video's mask schedule (a file-existence probe)
    # and its first frame
    groups, mid_groups, sequential = {}, {}, []
    for r in meta_dataset.get_datasets():
        mask_tis = r.mask_frame_indices()
        if not mask_tis:
            sequential.append(r)  # no reachable mask: nothing to propagate
            continue
        d0 = r[0]
        shape = tuple(np.asarray(d0["rgb"]).shape)
        usage = count_usage(base_cfg, len(r))
        if mask_tis == [0] and d0.get("mask") is not None:
            key = (shape, base_cfg.pad_objects(len(d0["valid_labels"])),
                   usage)
            groups.setdefault(key, []).append(r)
        else:  # mid-stream masks: the multi-bucket lockstep path
            mid_groups.setdefault((shape, usage), []).append(r)

    for (shape, o_bucket, usage), rs in sorted(groups.items(), key=str):
        cfg = dataclasses.replace(base_cfg,
                                  enable_long_term_count_usage=usage)
        for i in range(0, len(rs), args.batch):
            chunk = rs[i:i + args.batch]
            names = [r.vid_name for r in chunk]
            print(f"group {shape} x{o_bucket}obj: {names}")
            with video_fault_barrier(", ".join(names), args.raise_on_error):
                run_group(model, cfg, chunk, out_path, args.save_all, timer)
    for (shape, usage), rs in sorted(mid_groups.items(), key=str):
        cfg = dataclasses.replace(base_cfg,
                                  enable_long_term_count_usage=usage)
        for i in range(0, len(rs), args.batch):
            chunk = rs[i:i + args.batch]
            if len(chunk) == 1:
                sequential.append(chunk[0])
                continue
            names = [r.vid_name for r in chunk]
            print(f"mid-stream group {shape}: {names}")
            with video_fault_barrier(", ".join(names), args.raise_on_error):
                run_group_midstream(model, cfg, chunk, out_path,
                                    args.save_all, timer)
    for r in sequential:
        cfg = dataclasses.replace(
            base_cfg, enable_long_term_count_usage=count_usage(base_cfg,
                                                               len(r)))
        print(f"sequential: {r.vid_name}")
        with video_fault_barrier(r.vid_name, args.raise_on_error):
            run_sequential(model, cfg, r, out_path, args.save_all, timer)

    print(f"Total processing time: {timer.total_s}")
    print(f"Total processed frames: {timer.frames}")
    if timer.total_s > 0:
        print(f"Aggregate FPS: {timer.frames / timer.total_s}")
    if device.type == "cuda":
        print("Max allocated memory (MB): "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 20:.1f}")

    if is_youtube:
        print("Making zip for YouTubeVOS...")
        shutil.make_archive(path.join(args.output,
                                      path.basename(args.output)),
                            "zip", args.output, "Annotations")


if __name__ == "__main__":
    main()
