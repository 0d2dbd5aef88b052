"""Text-prompted open-vocabulary tracking over an image folder, with
deva_tpu_torch (PyTorch + CUDA).

The port's counterpart of demo/demo_with_text.py: the same flags (the
detector flags of deva_tpu_torch/ext/ext_eval_args.py, the model, memory
and device flags of evaluation/eval_vos_torch.py), the same per-frame state
machine (ext/with_text_processor.py) and the same outputs (Annotations/
RGB id PNGs, Visualizations/ overlays and pred.json under --output).

  python demo/demo_with_text_torch.py --img_path ./frames \\
      --prompt "person.dog" --output ./out [--sam_variant mobile]

Detectors: --sam_variant original/sam_hq run Grounding DINO
(--GROUNDING_DINO_HF_PATH) and the HF SAM (--SAM_HF_PATH) through
`transformers`, which must be installed; mobile/sam_hq_light run Grounding
DINO beside the port's MobileSAM / Light-HQ-SAM (seeded random weights
unless --MOBILE_SAM_CHECKPOINT_PATH / --LIGHT_HQ_SAM_CHECKPOINT_PATH
exists). --model takes an upstream .pth or a deva_tpu .npz; without one
the propagation weights are a seeded random init. --device defaults to cuda
and fails when CUDA is absent (--device cpu runs on the CPU); TF32 stays
off on the card. The video runs inside the fault barrier
(deva_tpu_torch/inference/eval_args.py; --raise_on_error re-raises).
Not carried over from deva_tpu's demo: --obj_shards (object-axis
sharding) and --profile.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from argparse import ArgumentParser
from os import path

import numpy as np
import torch

ROOT = path.dirname(path.dirname(path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, path.join(ROOT, "evaluation"))

from deva_tpu_torch.config import InferenceConfig  # noqa: E402
from deva_tpu_torch.data.simple_video_reader import \
    SimpleVideoReader  # noqa: E402
from deva_tpu_torch.ext.detectors import build_text_detector  # noqa: E402
from deva_tpu_torch.ext.ext_eval_args import (  # noqa: E402
    add_ext_eval_args, add_text_default_args)
from deva_tpu_torch.ext.with_text_processor import \
    process_frame_with_text  # noqa: E402
from deva_tpu_torch.inference.core import InferenceCore  # noqa: E402
from deva_tpu_torch.inference.demo_utils import flush_buffer  # noqa: E402
from deva_tpu_torch.inference.eval_args import \
    video_fault_barrier  # noqa: E402
from deva_tpu_torch.inference.result_saver import ResultSaver  # noqa: E402
from eval_vos_torch import (StepTimer, add_common_args,  # noqa: E402
                            base_config, count_usage, load_model,
                            setup_device)

DESCRIPTION = ("deva_tpu_torch demo. Not carried over from deva_tpu's "
               "demo: --obj_shards (object-axis sharding, not ported yet) "
               "and --profile.")


def make_parser(add_defaults=add_text_default_args) -> ArgumentParser:
    """The demo's flags: the port's common flags, the detector flags and
    the demo's defaults (add_text_default_args or add_auto_default_args)."""
    parser = ArgumentParser(description=DESCRIPTION)
    add_common_args(parser)
    add_ext_eval_args(parser)
    add_defaults(parser)
    return parser


def demo_config(args, vid_length: int) -> InferenceConfig:
    """The InferenceConfig of the flags for a video of vid_length frames
    (deva_tpu's demos: long-term usage counting by the video's length)."""
    cfg = base_config(args)
    return dataclasses.replace(
        cfg, enable_long_term_count_usage=count_usage(cfg, vid_length),
        detection_every=args.detection_every,
        num_voting_frames=args.num_voting_frames,
        max_missed_detection_count=args.max_missed_detection_count,
        max_num_objects=args.max_num_objects)


def run_demo(deva: InferenceCore, detector, reader, saver, ext_cfg,
             timer: StepTimer) -> None:
    """The video through the text processor, frame by frame, then the
    frames left in the semi-online buffer. reader: len() and reader[i] ->
    (uint8 RGB frame, name, path) (as SimpleVideoReader); saver: save_mask
    (as ResultSaver); timer: a StepTimer, entered around each frame's
    processing and around the flush (one step of the buffer's frames)."""
    for ti in range(len(reader)):
        frame, _, im_path = reader[ti]
        with timer:
            process_frame_with_text(deva, detector, ext_cfg, im_path, saver,
                                    ti, image_np=frame)
    if deva.frame_buffer:
        with timer.frames_of(len(deva.frame_buffer)):
            flush_buffer(deva, saver, prompts=[
                p for p in ext_cfg["prompt"].split(".") if p.strip()])


def drive(args, source, run, device) -> None:
    """The demo on --img_path with `source` (a detector or a generator):
    one InferenceCore with long ids, a demo ResultSaver under --output,
    run(deva, source, reader, saver, vars(args), timer) inside the fault
    barrier, then pred.json, FPS and the peak memory."""
    if args.output is None:
        raise SystemExit("--output is required")
    model = load_model(args, device)
    reader = SimpleVideoReader(args.img_path)
    deva = InferenceCore(model, demo_config(args, len(reader)),
                         device=device)
    deva.enabled_long_id()
    saver = ResultSaver(args.output, None, dataset="demo",
                        object_manager=deva.object_manager)
    timer = StepTimer(device)
    barrier = video_fault_barrier(path.basename(path.normpath(
        args.img_path)), args.raise_on_error)
    with barrier:
        run(deva, source, reader, saver, vars(args), timer)
    saver.end()
    if not barrier.failed:
        os.makedirs(args.output, exist_ok=True)
        with open(path.join(args.output, "pred.json"), "w") as f:
            json.dump(saver.video_json, f, indent=4)

    print(f"Total processing time: {timer.total_s}")
    print(f"Total processed frames: {timer.frames}")
    if timer.total_s > 0:
        print(f"FPS: {timer.frames / timer.total_s}")
    if device.type == "cuda":
        print("Max allocated memory (MB): "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 20:.1f}")


def main(argv=None):
    np.random.seed(42)
    args = make_parser().parse_args(argv)
    if args.prompt is None:
        raise SystemExit("--prompt is required (classes separated by '.')")
    device = setup_device(args)
    drive(args, build_text_detector(args), run_demo, device)


if __name__ == "__main__":
    main()
