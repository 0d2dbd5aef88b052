"""Referring-YouTubeVOS evaluation with deva_tpu_torch (PyTorch + CUDA):
per object, score-weighted consensus picks a keyframe, then bidirectional
propagation from its soft mask; binary (foreground > background) PNGs and
the submission zip.

The port's counterpart of evaluation/eval_ref_youtubevos.py: the same flags,
the same output (Annotations/<video>/<object>/<frame>.png on the frames the
meta-expressions list, with --save_all on every frame, a key.txt per
object, then the zip), the same video list (the official val subset,
deva_tpu_torch/utils/subsets/referring-youtubevos-val.txt). One consensus
core per video: its image feature store serves every object's vote and
both propagation passes (evaluation/eval_ref_davis_torch.py has the
machinery).

Usage (on the card; --device cpu for the CPU):
  python evaluation/eval_ref_youtubevos_torch.py \\
      --img_path ../YouTube/all_frames/valid_all_frames/JPEGImages \\
      --mask_path MASKS --json_path META_EXPRESSIONS.json --output ./out_ryv

The model, memory, attention and dtype flags are eval_vos_torch.py's. Each
video runs inside the per-video fault barrier
(deva_tpu_torch/inference/eval_args.py), --raise_on_error as there.
"""
from __future__ import annotations

import shutil
import sys
from argparse import ArgumentParser
from os import path

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))
sys.path.insert(0, path.dirname(path.abspath(__file__)))

from deva_tpu_torch.data.referring_test_datasets import \
    ReferringYouTubeVOSTestDataset  # noqa: E402
from deva_tpu_torch.inference.core import InferenceCore  # noqa: E402
from deva_tpu_torch.inference.eval_args import \
    video_fault_barrier  # noqa: E402
from deva_tpu_torch.utils.load_subset import \
    load_referring_yv_val  # noqa: E402
from eval_ref_davis_torch import (binary_mask, consensus,  # noqa: E402
                                  report, run_bidirectional, save_png,
                                  write_key)
from eval_vos_torch import (StepTimer, add_common_args,  # noqa: E402
                            base_config, load_model, setup_device)


def make_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument(
        "--img_path",
        default="../YouTube/all_frames/valid_all_frames/JPEGImages")
    parser.add_argument("--mask_path")
    parser.add_argument(
        "--json_path",
        default="../YouTube/meta_expressions/valid/meta_expressions.json")
    parser.add_argument("--num_voting_frames", type=int, default=10)
    add_common_args(parser)
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    device = setup_device(args)
    model = load_model(args, device)
    base_cfg = base_config(args)
    out_path = args.output
    meta_dataset = ReferringYouTubeVOSTestDataset(args.img_path,
                                                  args.mask_path,
                                                  args.json_path,
                                                  size=args.size)
    video_subset = load_referring_yv_val()
    print(f"Subset size: {len(video_subset)}")
    timer = StepTimer(device)

    for vid_name in sorted(video_subset):
        with video_fault_barrier(vid_name, args.raise_on_error):
            video_scores = meta_dataset.get_scores(vid_name)
            store_core = InferenceCore(model, base_cfg, device=device)
            for object_name in meta_dataset.get_objects(vid_name):
                out_dir = path.join(out_path, "Annotations", vid_name,
                                    object_name)
                time_indices, keyframe_ti, projected_mask = consensus(
                    store_core, meta_dataset, vid_name,
                    args.num_voting_frames, video_scores[object_name],
                    timer, reader_args=(object_name,))

                def save_fn(processor, prob, info):
                    if args.save_all or info["save"]:
                        save_png(binary_mask(prob, info), out_dir,
                                 info["frame"])

                run_bidirectional(store_core, meta_dataset, vid_name,
                                  keyframe_ti, projected_mask, save_fn,
                                  timer, reader_args=(object_name,))
                write_key(out_dir, time_indices, keyframe_ti)

    report(timer, device)
    print("Making zip for YouTubeVOS...")
    shutil.make_archive(path.join(args.output, path.basename(args.output)),
                        "zip", args.output, "Annotations")


if __name__ == "__main__":
    main()
