"""Full-width learn-to-track proof with deva_tpu_torch (PyTorch + CUDA).

The port's counterpart of scripts/train_fullwidth_proof.py: the same proof
as scripts/train_toy_torch.py at the production model width
(ModelConfig(): pix 512 / key 64 / value 512), on synthetic moving-square
clips (deva_tpu_torch/training/toy.py), the port's train step (forward,
backward, AdamW; --remat through torch.utils.checkpoint), then the serving
stack (InferenceCore) on held-out clips. It answers whether the flagship
configuration trains on the card, at what step time, and whether it
learns, without any dataset.

  python scripts/train_fullwidth_proof_torch.py [--steps 80] [--b 4] [--t 4]
      [--hw 128] [--remat] [--f32] [--smoke] [--device cuda|cpu]

The flags and prints are deva_tpu's, and so is the end: the held-out IoU
must gain more than 0.2 over the random init, then PROOF-OK (--smoke, a
plumbing check with too few steps to learn, prints SMOKE-OK instead).
bf16 compute unless --f32. --device defaults to cuda and fails without
CUDA. Training runs on the one device; deva_tpu's n_data (the
data-parallel mesh over its devices) has no meaning on one card and is not
carried over. Reference training-shape anchor:
reference:deva/model/trainer.py:71-202, docs/TRAINING.md:39-42.
"""
import sys
import time
from os import path

sys.path.insert(0, path.dirname(path.dirname(path.abspath(__file__))))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv

    def arg(flag, default, cast=int):
        return cast(argv[argv.index(flag) + 1]) if flag in argv else default

    steps = arg("--steps", 80)
    b = arg("--b", 4)
    t = arg("--t", 4)
    hw = arg("--hw", 128)
    remat = "--remat" in argv

    from deva_tpu_torch.config import ModelConfig
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    from deva_tpu_torch.training.toy import eval_iou, resolve_device, \
        train_toy

    device = resolve_device(arg("--device", "cuda", str))
    if device.type == "cuda":  # parity with deva_tpu's f32: no TF32
        import torch
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = "float32" if "--f32" in argv else "bfloat16"
    net = init_weights(DEVANetwork(ModelConfig(dtype=dtype)), seed=0)
    print(f"devices: [{device}]  model: full-width {dtype}  "
          f"batch {b} x {t} frames @ {hw}^2  remat={remat}", flush=True)

    # square scaled with the crop so stride-16 features see it well
    size = max(12, hw // 4)

    t0 = time.perf_counter()
    iou0 = eval_iou(net.to(device).eval(), h=hw, w=hw, size=size)
    print(f"random-init held-out IoU: {iou0:.3f} "
          f"({time.perf_counter() - t0:.0f}s)", flush=True)

    t0 = time.perf_counter()

    def log(msg):
        print(f"{msg}  (+{time.perf_counter() - t0:.0f}s)", flush=True)

    net, losses = train_toy(
        steps=steps, b=b, t=t, lr=1e-4, seed=0,
        log_every=max(1, steps // 8), log=log, net=net,
        h=hw, w=hw, size=size, remat=remat, device=device)
    total = time.perf_counter() - t0
    print(f"trained {steps} steps in {total:.0f}s "
          f"({steps * b / total:.2f} samples/s incl. compile)", flush=True)

    iou1 = eval_iou(net, h=hw, w=hw, size=size)
    print(f"held-out IoU: {iou0:.3f} -> {iou1:.3f}  "
          f"loss {losses[0]:.2f} -> {losses[-1]:.2f}", flush=True)
    if "--smoke" in argv:  # plumbing check only (too few steps to learn)
        print("SMOKE-OK", flush=True)
        return
    assert iou1 > iou0 + 0.2, "full-width model failed to learn"
    print("PROOF-OK", flush=True)


if __name__ == "__main__":
    main()
