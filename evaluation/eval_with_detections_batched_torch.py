"""Batched detection-driven evaluation with deva_tpu_torch (PyTorch + CUDA),
semi-online and online: videos are grouped by processed frame shape and
long-term usage-counting policy and advanced B at a time in lockstep by
deva_tpu_torch/inference/batched_detection.py. Plain propagation spans run
through step_block (one launch of each attention kernel per lockstep frame
for all (video, bucket) pairs), and the forward predictions of the
detection frames, and (semi-online) every consensus alignment, run as one
batched call for the group; consensus votes, integer programs and
match-and-merge stay per video on the host, as in the sequential driver.

The port's counterpart of evaluation/eval_with_detections_batched.py, with
eval_with_detections_torch.py's flags plus --batch (default 4), for the
vipseg and demo layouts. Semi-online lockstep covers the schedule-uniform
prefix (every video shares next_voting_frame until the shortest video's
last vote); online lockstep covers the whole common prefix (the cadence
ti % detection_every == 0 never diverges). Tail frames, and groups of one
video, run the per-video state machines. For --dataset vipseg the
sequential driver's post-pipeline runs (pred.json, stuff merge, VPQ/STQ
unless --no_metrics).

Usage (the example clip, on the card; --device cpu for the CPU):
  python evaluation/eval_with_detections_batched_torch.py --dataset vipseg \\
      --img_path ./example/vipseg/images --mask_path ./example/vipseg/source \\
      --output ./out_det_b --no_metrics --batch 4

--device defaults to cuda and fails when CUDA is absent; TF32 stays off on
the card. The report gives the aggregate video-frames per second over the
device time of the steps (CUDA events on the card). Each group is one unit
of the per-video fault barrier (deva_tpu_torch/inference/eval_args.py): a
group that fails on its data is logged and skipped, unless
--raise_on_error; kernel and device errors always end the run.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import get_context
from os import path

import numpy as np
import torch

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))
sys.path.insert(0, path.dirname(path.abspath(__file__)))

from deva_tpu_torch.data.vps_test_datasets import \
    VIPSegDetectionTestDataset  # noqa: E402
from deva_tpu_torch.inference.batched_detection import \
    BatchedDetectionPropagator  # noqa: E402
from deva_tpu_torch.inference.core import InferenceCore  # noqa: E402
from deva_tpu_torch.inference.eval_args import (  # noqa: E402
    reject_obj_sharding, video_fault_barrier)
from deva_tpu_torch.inference.frame_utils import FrameInfo  # noqa: E402
from deva_tpu_torch.inference.object_utils import \
    convert_json_dict_to_objects_info  # noqa: E402
from deva_tpu_torch.inference.result_saver import ResultSaver  # noqa: E402
from eval_vos_torch import (StepTimer, count_usage, load_model,  # noqa
                            setup_device)
from eval_with_detections_torch import (detection_config,  # noqa: E402
                                        make_parser)


def _load_json(info):
    jp = info.get("json")
    if jp is None:
        return info.get("segments_info")
    with open(jp) as f:
        return json.load(f)


def _frame_record(reader, ti, dataset_name, save_all=False):
    """reader[ti] -> (data, info, segments_info)."""
    data = reader[ti]
    info = data["info"]
    if save_all:
        info["save"] = True
    segments_info = convert_json_dict_to_objects_info(
        data.get("mask"), _load_json(info), dataset=dataset_name)
    return data, info, segments_info


class _VideoState:
    """One video of a group: reader (len() and reader[ti] -> {"rgb",
    "mask", "info"}, as DetectionVideoReader), core and result saver."""

    def __init__(self, reader, core, saver):
        self.reader = reader
        self.core = core
        self.saver = saver
        self.length = len(reader)


def _save(vs, prob, info):
    if info["save"]:
        vs.saver.save_mask(prob, info["frame"],
                           need_resize=info["need_resize"],
                           shape=info["shape"],
                           path_to_image=info.get("path_to_image"))


def _save_buffered(vs, prob, fi):
    if fi.save_needed:
        vs.saver.save_mask(prob, fi.name, need_resize=fi.info["need_resize"],
                           shape=fi.shape, path_to_image=fi.path_to_image)


def run_sequential_tail(vs: _VideoState, args, dataset_name, ti0: int,
                        next_voting_frame: int, timer) -> int:
    """Finish a video with the per-video semi-online machine from frame ti0.
    Returns the next voting frame."""
    core, n = vs.core, vs.length
    for ti in range(ti0, n):
        data, info, segments_info = _frame_record(vs.reader, ti,
                                                  dataset_name, args.save_all)
        if ti + args.num_voting_frames > next_voting_frame:
            core.add_to_temporary_buffer(FrameInfo(
                data["rgb"], np.asarray(data.get("mask")), segments_info, ti,
                info))
            if ti == next_voting_frame:
                buf0 = core.frame_buffer[0]
                with timer:
                    _, consensus_mask, consensus_info = \
                        core.vote_in_temporary_buffer(
                            keyframe_selection="first")
                    prob = core.incorporate_detection(
                        buf0.image, consensus_mask, consensus_info)
                next_voting_frame += args.detection_every
                if next_voting_frame >= n:
                    next_voting_frame = n + args.num_voting_frames
                _save_buffered(vs, prob, buf0)
                for fi in core.frame_buffer[1:]:
                    with timer:
                        prob = core.step(fi.image, end=fi.ti == n - 1)
                    _save_buffered(vs, prob, fi)
                core.clear_buffer()
        else:
            with timer:
                prob = core.step(data["rgb"], end=ti == n - 1)
            _save(vs, prob, info)
    return next_voting_frame


def run_sequential_tail_online(vs: _VideoState, args, dataset_name,
                               ti0: int, timer) -> None:
    """Finish a video with the per-video online machine from frame ti0:
    incorporate every detection_every-th frame, step otherwise."""
    core, n = vs.core, vs.length
    for ti in range(ti0, n):
        data, info, segments_info = _frame_record(vs.reader, ti,
                                                  dataset_name, args.save_all)
        with timer:
            if ti % args.detection_every == 0:
                if data.get("mask") is None:
                    raise ValueError(f"frame {ti} of {vs.reader.vid_name}: "
                                     "no detection mask")
                prob = core.incorporate_detection(data["rgb"], data["mask"],
                                                  segments_info)
            else:
                prob = core.step(data["rgb"], end=ti == n - 1)
        _save(vs, prob, info)


def _any_engaged(cores) -> bool:
    return any(c.memory is not None and c.memory.engaged for c in cores)


def _step_group_per_core(states, ti, k, args, dataset_name, timer) -> None:
    """No video of the group has objects yet (every detection so far came up
    empty), so there is no state to stack: step each core alone. A step
    without memory returns the background and advances the clock."""
    for i in range(k):
        for vs in states:
            data, info, _ = _frame_record(vs.reader, ti + i, dataset_name,
                                          args.save_all)
            with timer:
                prob = vs.core.step(data["rgb"])
            _save(vs, prob[:vs.core.object_manager.num_obj + 1], info)


def _step_span(bp, states, frames, k, timer):
    """k lockstep frames of the group through step_block -> probabilities
    [B, k, 1 + o_cap, H, W]."""
    with timer.frames_of(len(states) * k):
        return bp.step_block(frames)


def run_group_online(model, cfg, group, args, dataset_name, timer) -> None:
    """Online lockstep over the group's common prefix (the detection cadence
    is global, so the schedules never diverge): each detection frame takes
    the forward predictions of all videos in one batched call (forward_ids,
    before detach, so their sensory update reaches the cores), then
    incorporate_detection per core; the spans between detections run
    through step_block. Tails past the shortest video finish with the
    per-video online machine."""
    states = group
    cores = [vs.core for vs in states]
    min_len = min(vs.length for vs in states)
    bp = BatchedDetectionPropagator(model, cfg)
    attached = False
    ti = 0
    while ti < min_len:
        if ti % args.detection_every == 0:
            records = [_frame_record(vs.reader, ti, dataset_name,
                                     args.save_all) for vs in states]
            probs = []
            with timer.frames_of(len(states)):
                fwd_ids = None
                if attached:
                    fwd_ids = bp.forward_ids([r[0]["rgb"] for r in records])
                    bp.detach()
                    attached = False
                for vi, vs in enumerate(states):
                    data, info, segs = records[vi]
                    if data.get("mask") is None:
                        raise ValueError(f"frame {ti} of "
                                         f"{vs.reader.vid_name}: no "
                                         "detection mask")
                    probs.append(vs.core.incorporate_detection(
                        data["rgb"], data["mask"], segs,
                        forward_mask=None if fwd_ids is None
                        else fwd_ids[vi]))
                if _any_engaged(cores):
                    bp.attach(cores)
                    attached = True
            for vs, prob, (_, info, _) in zip(states, probs, records):
                _save(vs, prob, info)
            ti += 1
            continue
        span = min(args.detection_every - ti % args.detection_every,
                   min_len - ti)
        if not attached:
            _step_group_per_core(states, ti, span, args, dataset_name, timer)
            ti += span
            continue
        k = bp.plan_block(min(span, cfg.mem_every))
        records = [[_frame_record(vs.reader, ti + i, dataset_name,
                                  args.save_all) for vs in states]
                   for i in range(k)]
        frames = [np.stack([records[i][vi][0]["rgb"] for i in range(k)])
                  for vi in range(len(states))]
        probs = _step_span(bp, states, frames, k, timer)
        for i in range(k):
            for vi, vs in enumerate(states):
                _save(vs, probs[vi, i, :vs.core.object_manager.num_obj + 1],
                      records[i][vi][1])
        ti += k
    if attached:
        bp.detach()
    for vs in states:
        run_sequential_tail_online(vs, args, dataset_name, ti, timer)


def run_group(model, cfg, group, args, dataset_name, timer) -> None:
    """Semi-online lockstep over the schedule-uniform prefix of a group: at
    each voting frame the forward predictions (forward_ids, before detach)
    and every consensus alignment (align_consensus_batched) run as one
    batched call each, the votes and incorporate_detection per core (the
    votes' host work in a thread pool), and the rest of the buffer through
    step_block; the spans before buffering resumes run through step_block
    too. Lockstep ends where the shortest video, past its last vote, would
    step a frame that a longer one buffers; the tails finish with the
    per-video semi-online machine."""
    states = group
    cores = [vs.core for vs in states]
    min_len = min(vs.length for vs in states)
    bp = BatchedDetectionPropagator(model, cfg)
    next_voting = args.num_voting_frames - 1
    attached = False
    ti = 0
    while ti < min_len:
        if next_voting >= min_len and \
                ti + args.num_voting_frames > next_voting:
            # the shortest video votes no more and steps this frame, where
            # a longer one buffers it: the schedules diverge
            break
        if not (ti + args.num_voting_frames > next_voting):
            # a plain propagation span before buffering resumes
            span = min(next_voting - args.num_voting_frames + 1 - ti,
                       min_len - ti)
            if not attached:
                _step_group_per_core(states, ti, span, args, dataset_name,
                                     timer)
                ti += span
                continue
            k = bp.plan_block(min(span, cfg.mem_every))
            records = [[_frame_record(vs.reader, ti + i, dataset_name,
                                      args.save_all) for vs in states]
                       for i in range(k)]
            frames = [np.stack([records[i][vi][0]["rgb"] for i in range(k)])
                      for vi in range(len(states))]
            probs = _step_span(bp, states, frames, k, timer)
            for i in range(k):
                for vi, vs in enumerate(states):
                    _save(vs, probs[vi, i,
                                    :vs.core.object_manager.num_obj + 1],
                          records[i][vi][1])
            ti += k
            continue
        for vs in states:
            data, info, segs = _frame_record(vs.reader, ti, dataset_name,
                                             args.save_all)
            vs.core.add_to_temporary_buffer(FrameInfo(
                data["rgb"], np.asarray(data.get("mask")), segs, ti, info))
        if ti == next_voting:
            buf0s = [vs.core.frame_buffer[0] for vs in states]
            with timer.frames_of(len(states)):
                fwd_ids = None
                if attached:
                    fwd_ids = bp.forward_ids([b.image for b in buf0s])
                    bp.detach()
                    attached = False
                projs = bp.align_consensus_batched(cores,
                                                   keyframe_selection="first")
                with ThreadPoolExecutor(min(4, len(states))) as pool:
                    votes = list(pool.map(
                        lambda cp: cp[0].vote_in_temporary_buffer(
                            keyframe_selection="first",
                            precomputed_proj=cp[1]), zip(cores, projs)))
                probs = [vs.core.incorporate_detection(
                    buf0s[vi].image, votes[vi][1], votes[vi][2],
                    forward_mask=None if fwd_ids is None else fwd_ids[vi])
                    for vi, vs in enumerate(states)]
            for vs, prob, buf0 in zip(states, probs, buf0s):
                _save_buffered(vs, prob, buf0)
            next_voting += args.detection_every
            if not _any_engaged(cores):
                # every consensus so far was empty: per-core buffer steps
                for vs in states:
                    for fi in vs.core.frame_buffer[1:]:
                        with timer:
                            prob = vs.core.step(fi.image)
                        _save_buffered(vs, prob[
                            :vs.core.object_manager.num_obj + 1], fi)
                    vs.core.clear_buffer()
                ti += 1
                continue
            bp.attach(cores)
            attached = True
            nbuf = len(states[0].core.frame_buffer)
            j = 1
            while j < nbuf:
                k = bp.plan_block(min(nbuf - j, cfg.mem_every))
                frames = [np.stack([np.asarray(vs.core.frame_buffer[j + i]
                                               .image) for i in range(k)])
                          for vs in states]
                probs = _step_span(bp, states, frames, k, timer)
                for i in range(k):
                    for vi, vs in enumerate(states):
                        _save_buffered(vs, probs[
                            vi, i, :vs.core.object_manager.num_obj + 1],
                            vs.core.frame_buffer[j + i])
                j += k
            for vs in states:
                vs.core.clear_buffer()
        ti += 1
    if attached:
        bp.detach()
    for vs in states:
        # a video past its last vote steps to its end (the per-video
        # machine's clamp after a vote)
        run_sequential_tail(vs, args, dataset_name, ti,
                            next_voting if next_voting < vs.length
                            else vs.length + args.num_voting_frames, timer)


def main(argv=None):
    np.random.seed(42)  # for id2rgb, as the sequential driver
    parser = make_parser()
    parser.add_argument("--batch", type=int, default=4,
                        help="videos per lockstep group")
    args = parser.parse_args(argv)
    reject_obj_sharding(args, "eval_with_detections_batched_torch.py")
    device = setup_device(args)
    model = load_model(args, device)
    dataset_name = args.dataset.lower()
    if dataset_name not in ("vipseg", "demo"):
        raise SystemExit("eval_with_detections_batched_torch.py takes "
                         "--dataset vipseg or demo")
    temporal_setting = args.temporal_setting.lower()
    assert temporal_setting in ("semionline", "online")
    if path.exists(path.join(args.mask_path, "pan_pred")):
        args.mask_path = path.join(args.mask_path, "pan_pred")
    meta_dataset = VIPSegDetectionTestDataset(args.img_path, args.mask_path,
                                              args.size)
    base_cfg = detection_config(args)
    is_vipseg = dataset_name == "vipseg"
    timer = StepTimer(device)

    # lockstep groups: the processed frame shape and the long-term
    # usage-counting policy (from the video's length)
    groups = {}
    for reader in meta_dataset.get_datasets():
        shape = tuple(np.asarray(reader[0]["rgb"]).shape[:2])
        key = (shape, count_usage(base_cfg, len(reader)))
        groups.setdefault(key, []).append(reader)

    output_json_annotations = []
    for (shape, usage), readers in sorted(groups.items(), key=str):
        cfg = dataclasses.replace(base_cfg,
                                  enable_long_term_count_usage=usage)
        for i in range(0, len(readers), args.batch):
            chunk = readers[i:i + args.batch]
            states = []
            for r in chunk:
                core = InferenceCore(model, cfg, device=device)
                core.enabled_long_id()
                saver = ResultSaver(args.output, r.vid_name,
                                    dataset=dataset_name, palette=r.palette,
                                    object_manager=core.object_manager)
                states.append(_VideoState(r, core, saver))
            print(f"group {shape} x{len(chunk)}: "
                  f"{[r.vid_name for r in chunk]}")
            with video_fault_barrier(f"group {shape} x{len(chunk)}",
                                     args.raise_on_error):
                if len(states) == 1:
                    vs, = states
                    if temporal_setting == "online":
                        run_sequential_tail_online(vs, args, dataset_name,
                                                   0, timer)
                    else:
                        run_sequential_tail(vs, args, dataset_name, 0,
                                            args.num_voting_frames - 1,
                                            timer)
                elif temporal_setting == "online":
                    run_group_online(model, cfg, states, args,
                                     dataset_name, timer)
                else:
                    run_group(model, cfg, states, args, dataset_name,
                              timer)
            for vs in states:
                vs.saver.end()
                if is_vipseg:
                    output_json_annotations.append(vs.saver.video_json)

    print(f"Total processing time: {timer.total_s}")
    print(f"Total processed frames: {timer.frames}")
    if timer.total_s > 0:
        print(f"Aggregate FPS: {timer.frames / timer.total_s}")
    if device.type == "cuda":
        print("Max allocated memory (MB): "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 20:.1f}")

    if is_vipseg:
        with open(path.join(args.output, "pred.json"), "w") as f:
            json.dump({"annotations": output_json_annotations}, f)
        from deva_tpu_torch.metrics.stuff_merging import merge_stuff
        print("Starting evaluation...")
        merge_stuff(args.output, args.output)
        if not args.no_metrics:
            from deva_tpu_torch.metrics.eval_stq_vipseg import eval_stq
            from deva_tpu_torch.metrics.eval_vpq_vipseg import eval_vpq
            root = args.vipseg_root
            gt = (f"{root}/panomasksRGB",
                  f"{root}/panoptic_gt_VIPSeg_val.json")
            stq = get_context("spawn").Process(target=eval_stq,
                                               args=(args.output, *gt))
            stq.start()
            eval_vpq(args.output, *gt, num_processes=16)
            stq.join()
            if stq.exitcode != 0:
                raise RuntimeError(f"STQ evaluation failed ({stq.exitcode})")


if __name__ == "__main__":
    main()
