"""Score a VOS propagation run with deva_tpu_torch's DAVIS J&F evaluator.

The port's counterpart of evaluation/eval_jf.py: the same flags and the same
CSV files, scored by deva_tpu_torch/metrics/jf.py (numpy and scipy, no jax),
so eval_vos_torch.py output can be scored where deva_tpu cannot be imported:

    python evaluation/eval_jf_torch.py --results_path OUT/Annotations \
        --davis_path DAVIS/2017/trainval --split val
    # or explicit ground-truth directories (generic datasets):
    python evaluation/eval_jf_torch.py --results_path OUT \
        --gt_path GT_ANNOTATIONS

Writes global_results.csv + per_sequence_results.csv next to the
predictions (the davis2017-evaluation file layout) and prints the global
table.
"""
import csv
import os
import sys
from argparse import ArgumentParser
from multiprocessing import Pool

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deva_tpu_torch.metrics.jf import aggregate, evaluate_sequence_dirs


def _score_one(args):
    pred_dir, gt_dir, name = args
    return evaluate_sequence_dirs(pred_dir, gt_dir, name=name)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--results_path", required=True,
                        help="directory of per-sequence prediction PNG dirs")
    parser.add_argument("--davis_path", default=None,
                        help="DAVIS root (Annotations/480p + ImageSets)")
    parser.add_argument("--gt_path", default=None,
                        help="directory of per-sequence ground-truth PNG "
                             "dirs (alternative to --davis_path)")
    parser.add_argument("--split", default="val")
    parser.add_argument("--year", default="2017")
    parser.add_argument("--num_procs", type=int, default=1)
    args = parser.parse_args(argv)

    if args.davis_path:
        gt_root = os.path.join(args.davis_path, "Annotations", "480p")
        split_file = os.path.join(args.davis_path, "ImageSets", args.year,
                                  f"{args.split}.txt")
        with open(split_file) as f:
            seqs = [ln.strip() for ln in f if ln.strip()]
    elif args.gt_path:
        gt_root = args.gt_path
        seqs = sorted(d for d in os.listdir(gt_root)
                      if os.path.isdir(os.path.join(gt_root, d)))
    else:
        parser.error("one of --davis_path / --gt_path is required")

    jobs = [(os.path.join(args.results_path, s),
             os.path.join(gt_root, s), s) for s in seqs]
    missing = [s for (p, _, s) in jobs if not os.path.isdir(p)]
    if missing:
        print(f"warning: no predictions for {len(missing)} sequence(s): "
              f"{missing[:5]}{'...' if len(missing) > 5 else ''} "
              f"(scored as empty)", file=sys.stderr)

    if args.num_procs > 1:
        with Pool(args.num_procs) as pool:
            results = pool.map(_score_one, jobs)
    else:
        results = [_score_one(j) for j in jobs]

    table = aggregate(results)
    cols = ["J&F", "J_mean", "J_recall", "J_decay",
            "F_mean", "F_recall", "F_decay"]
    with open(os.path.join(args.results_path, "global_results.csv"),
              "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(cols)
        wr.writerow([f"{table[c]:.6f}" for c in cols])
    with open(os.path.join(args.results_path, "per_sequence_results.csv"),
              "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["sequence", "object", "J_mean", "F_mean"])
        for r in results:
            for oid in r.object_ids:
                wr.writerow([r.name, oid,
                             f"{float(r.j_per_object[oid].mean()):.6f}",
                             f"{float(r.f_per_object[oid].mean()):.6f}"])

    print(" ".join(f"{c}={table[c]:.4f}" for c in cols))


if __name__ == "__main__":
    main()
