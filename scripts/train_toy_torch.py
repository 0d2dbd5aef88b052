"""Train a tiny DEVA from scratch on synthetic moving squares and serve it,
with deva_tpu_torch (PyTorch + CUDA): the self-contained proof that the
port's training stack produces a model that tracks
(deva_tpu_torch/training/toy.py).

The port's counterpart of scripts/train_toy.py, with its flag (--steps)
and its prints, plus --device (cuda by default; --device cpu on the CPU):

  python scripts/train_toy_torch.py --steps 120 [--device cpu]

Training runs on the one device; deva_tpu's data-parallel mesh over its
devices (train_toy's n_data) has no meaning on one card and is not carried
over. Serving goes through InferenceCore, whose fused step launches the
exact attention kernels on a card.
"""
import sys
from os import path

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else 120
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    from deva_tpu_torch.training.toy import (eval_iou, resolve_device,
                                             tiny_model, train_toy)

    device = resolve_device(device)
    iou0 = eval_iou(tiny_model().to(device).eval())
    print(f"random-init held-out IoU: {iou0:.4f}")
    net, losses = train_toy(steps=steps, device=device)
    iou1 = eval_iou(net)
    print(f"trained held-out IoU after {steps} steps: {iou1:.4f}")


if __name__ == "__main__":
    main()
