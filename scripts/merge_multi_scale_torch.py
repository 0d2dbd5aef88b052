"""Merge multi-scale score dumps (from eval_vos_torch.py --save_scores) by
summing probabilities, remapping tmp ids back via the saved backward mapping,
and writing palette PNGs (+ submission zips).

The port's counterpart of scripts/merge_multi_scale.py, with deva_tpu_torch's
palettes (no jax). Behavioral anchor: reference:scripts/merge_multi_scale.py
(hickle .hkl score files become .npy here).

Usage: python scripts/merge_multi_scale_torch.py --dataset Y --output out \
    --list run_scale1 run_scale2 ...
"""
import glob
import os
import shutil
import sys
from argparse import ArgumentParser
from functools import partial
from multiprocessing import Pool
from os import path

import numpy as np

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))

from deva_tpu_torch.utils.palette import davis_palette, youtube_palette


def search_options(options, name):
    for option in options:
        if path.exists(path.join(option, name)):
            return path.join(option, name)
    return None


def process_vid(vid, *, all_options, out_path, dataset, palette):
    vid_path = search_options(all_options, vid)
    backward_mapping = None
    if vid_path is not None and path.exists(path.join(vid_path,
                                                      "backward.npy")):
        backward_mapping = np.load(path.join(vid_path, "backward.npy"),
                                   allow_pickle=True).item()

    frames = [f for f in os.listdir(path.join(all_options[0], vid))
              if "backward" not in f]
    this_out_path = path.join(out_path, "Annotations", vid) \
        if "Y" in dataset else path.join(out_path, vid)
    os.makedirs(this_out_path, exist_ok=True)

    for f in frames:
        result_sum = None
        for option in all_options:
            p = path.join(option, vid, f)
            if not path.exists(p):
                continue
            result = np.load(p).astype(np.float32)
            result_sum = result if result_sum is None else result_sum + result
        result_sum = np.argmax(result_sum, axis=0)

        if backward_mapping is not None:
            idx_mask = np.zeros_like(result_sum, dtype=np.uint8)
            for l, i in backward_mapping.items():
                idx_mask[result_sum == i] = l
        else:
            idx_mask = result_sum.astype(np.uint8)

        from PIL import Image
        img = Image.fromarray(idx_mask)
        img.putpalette(palette)
        img.save(path.join(this_out_path, f[:-4] + ".png"))


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--dataset", default="Y", help="D/Y")
    parser.add_argument("--list", nargs="+")
    parser.add_argument("--pattern", default=None)
    parser.add_argument("--output")
    parser.add_argument("--num_proc", default=4, type=int)
    args = parser.parse_args(argv)

    all_options = args.list if args.pattern is None else \
        glob.glob(args.pattern)
    palette = davis_palette() if "D" in args.dataset else youtube_palette()

    all_options = [path.join(o, "Scores") for o in all_options]
    vids = sorted({v for o in all_options for v in os.listdir(o)})
    print(f"Total number of videos: {len(vids)}")

    worker = partial(process_vid, all_options=all_options,
                     out_path=args.output, dataset=args.dataset,
                     palette=palette)
    with Pool(processes=args.num_proc) as pool:
        list(pool.imap_unordered(worker, vids))

    if "D" in args.dataset:
        shutil.make_archive(args.output, "zip", args.output)
    if "Y" in args.dataset:
        shutil.make_archive(path.join(args.output,
                                      path.basename(args.output)),
                            "zip", args.output, "Annotations")


if __name__ == "__main__":
    main()
