"""Unsupervised DAVIS-16 saliency evaluation with deva_tpu_torch (PyTorch +
CUDA): score-less consensus picks the keyframe with the most confident
foreground, then bidirectional propagation from its soft mask; binary PNG
output.

The port's counterpart of evaluation/eval_saliency.py: the same flags, the
same output (<video>/<frame>.png as 0/255 foreground on every frame, and a
key.txt per video). As in deva_tpu's driver, the passes step with
image_ti_override but delete each frame's features after its step
(delete_buffer left at True); evaluation/eval_ref_davis_torch.py has the
machinery.

Usage (on the card; --device cpu for the CPU):
  python evaluation/eval_saliency_torch.py \\
      --img_path ../DAVIS/2016/JPEGImages/480p --mask_path SALIENCY_MASKS \\
      --output ./out_sal

The model, memory, attention and dtype flags are eval_vos_torch.py's. Each
video runs inside the per-video fault barrier
(deva_tpu_torch/inference/eval_args.py), --raise_on_error as there.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser
from os import path

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))
sys.path.insert(0, path.dirname(path.abspath(__file__)))

from deva_tpu_torch.data.saliency_test_datasets import \
    DAVISSaliencyTestDataset  # noqa: E402
from deva_tpu_torch.inference.core import InferenceCore  # noqa: E402
from deva_tpu_torch.inference.eval_args import \
    video_fault_barrier  # noqa: E402
from eval_ref_davis_torch import (binary_mask, consensus,  # noqa: E402
                                  report, run_bidirectional, save_png,
                                  write_key)
from eval_vos_torch import (StepTimer, add_common_args,  # noqa: E402
                            base_config, load_model, setup_device)


def run_video(store_core: InferenceCore, meta_dataset, vid_name: str,
              num_voting_frames: int, save_fn, timer: StepTimer):
    """One video of the saliency protocol: the score-less consensus, then
    both passes with delete_buffer=True, as eval_saliency.py runs them.
    -> (the sampled time indices, the keyframe's time index)."""
    time_indices, keyframe_ti, projected_mask = consensus(
        store_core, meta_dataset, vid_name, num_voting_frames, None, timer)
    run_bidirectional(store_core, meta_dataset, vid_name, keyframe_ti,
                      projected_mask, save_fn, timer, delete_buffer=True)
    return time_indices, keyframe_ti


def make_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--img_path", default="../DAVIS/2016/JPEGImages/480p")
    parser.add_argument("--mask_path")
    parser.add_argument("--imset", default=None)
    parser.add_argument("--num_voting_frames", type=int, default=10)
    add_common_args(parser)
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    device = setup_device(args)
    model = load_model(args, device)
    base_cfg = base_config(args)
    out_path = args.output
    meta_dataset = DAVISSaliencyTestDataset(args.img_path, args.mask_path,
                                            imset=args.imset, size=args.size)
    timer = StepTimer(device)

    for vid_name in meta_dataset.get_videos():
        with video_fault_barrier(vid_name, args.raise_on_error):
            store_core = InferenceCore(model, base_cfg, device=device)
            out_dir = path.join(out_path, vid_name)

            def save_fn(processor, prob, info):
                save_png(binary_mask(prob, info), out_dir, info["frame"])

            time_indices, keyframe_ti = run_video(
                store_core, meta_dataset, vid_name, args.num_voting_frames,
                save_fn, timer)
            write_key(out_dir, time_indices, keyframe_ti)
            print(f"{vid_name}: keyframe {keyframe_ti}")

    report(timer, device)


if __name__ == "__main__":
    main()
