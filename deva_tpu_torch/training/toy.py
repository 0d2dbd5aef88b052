"""Learn-to-track on synthetic data: train, then serve.

Port of deva_tpu/training/toy.py. A tiny-width DEVA trained from scratch on
procedurally generated moving-square clips with the real unrolled train
step, then evaluated through the port's serving stack (InferenceCore, whose
fused step launches the exact attention kernels on a CUDA device) on
held-out clips. The calibration is deva_tpu's (toy.py:11-13: 120 steps of
batch 8 at lr 3e-4, the bootstrapped CE kept in its full-CE phase).

Hyperparameter note (deva_tpu's): the hard-pixel mining schedule must stay
in its full-CE phase for a run this short; with the warm-up compressed to
~10 steps the model collapses to background. train_toy sets start_warm far
beyond the run length instead.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def make_clip(rng: np.random.Generator, t: int, h: int = 48, w: int = 48,
              size: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic clip: a bright square moving linearly (clamped at the
    borders) over a fixed blocky dark background with per-frame pixel noise.
    Returns (frames [t, h, w, 3] float32, masks [t, h, w] int32 in {0, 1})."""
    bg = np.kron(rng.uniform(0, 0.6, (h // 8, w // 8, 3)), np.ones((8, 8, 1)))
    x = int(rng.integers(0, w - size))
    y = int(rng.integers(0, h - size))
    dx, dy = int(rng.integers(-3, 4)), int(rng.integers(-3, 4))
    color = rng.uniform(0.7, 1.0, 3)
    frames, masks = [], []
    for _ in range(t):
        img = bg + 0.02 * rng.standard_normal((h, w, 3))
        img[y:y + size, x:x + size] = color
        m = np.zeros((h, w), np.int32)
        m[y:y + size, x:x + size] = 1
        frames.append(img.astype(np.float32))
        masks.append(m)
        x = int(np.clip(x + dx, 0, w - size))
        y = int(np.clip(y + dy, 0, h - size))
    return np.stack(frames), np.stack(masks)


def make_batch(rng: np.random.Generator, b: int, t: int, h: int = 48,
               w: int = 48, size: int = 12) -> Dict[str, np.ndarray]:
    """Trainer-format batch (VOSDataset's keys: rgb / first_frame_gt /
    cls_gt / selector)."""
    rgbs, gts = zip(*[make_clip(rng, t, h, w, size) for _ in range(b)])
    rgb = np.stack(rgbs)
    cls_gt = np.stack(gts)
    first = (cls_gt[:, 0] == 1)[:, None].astype(np.float32)
    selector = np.ones((b, 1), np.float32)
    return {"rgb": rgb, "first_frame_gt": first, "cls_gt": cls_gt,
            "selector": selector}


def tiny_model(seed: int = 0):
    """deva_tpu's toy widths (pix 64, key 16, value 32), seeded weights, on
    the CPU."""
    from deva_tpu_torch.config import ModelConfig
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    return init_weights(DEVANetwork(ModelConfig(pix_feat_dim=64, key_dim=16,
                                                value_dim=32)), seed)


def resolve_device(device) -> torch.device:
    """A torch.device; 'cuda' without CUDA raises (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda but CUDA is not available "
                           "(pass device='cpu' to run on the CPU)")
    return device


@torch.no_grad()
def eval_iou(net, n_clips: int = 3, t: int = 5, seed: int = 999,
             h: int = 48, w: int = 48, size: int = 12) -> float:
    """Serve held-out clips with the inference stack on the network's
    device: first-frame mask in, propagate, mean IoU over the remaining
    frames."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    cfg = InferenceConfig(mem_every=2, top_k=8, enable_long_term=False)
    rng = np.random.default_rng(seed)
    ious = []
    for _ in range(n_clips):
        frames, masks = make_clip(rng, t, h, w, size)
        core = InferenceCore(net, cfg)
        core.step(frames[0], masks[0], objects=[1])
        for ti in range(1, t):
            pred = (core.step(frames[ti]).argmax(0) == 1).cpu().numpy()
            gt = masks[ti] == 1
            ious.append((pred & gt).sum() / max(1, (pred | gt).sum()))
    return float(np.mean(ious))


def train_toy(steps: int = 120, b: int = 8, t: int = 4, lr: float = 3e-4,
              seed: int = 0, log_every: int = 10, log=print,
              net=None, h: int = 48, w: int = 48, size: int = 12,
              remat: bool = False, device="cuda"):
    """Train DEVA from scratch on moving squares on `device` (the card
    unless device='cpu'); -> (the trained network, in eval mode on that
    device, [total_loss at each logged step]). The default network is
    tiny_model()."""
    from deva_tpu_torch.config import TrainConfig
    from deva_tpu_torch.training.trainer import Trainer

    device = resolve_device(device)
    if net is None:
        net = tiny_model()
    net = net.to(device)
    # start_warm >> steps: the bootstrapped CE stays in its full-CE phase
    # (module note)
    cfg = TrainConfig(num_frames=t, num_ref_frames=2, lr=lr,
                      start_warm=10 ** 6, end_warm=2 * 10 ** 6,
                      iterations=10 * steps, steps=(8 * steps, 9 * steps),
                      remat=remat)
    trainer = Trainer(net, cfg, schedule="step", seed=seed + 1)
    rng = np.random.default_rng(seed)
    losses = []
    for i in range(steps):
        metrics = trainer.train_step(make_batch(rng, b, t, h, w, size))
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["total_loss"])
            losses.append(loss)
            log(f"step {i}: total_loss {loss:.4f}")
    return net.eval(), losses
