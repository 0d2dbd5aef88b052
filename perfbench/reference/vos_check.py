"""The correctness check of a batched VOS cell.

The reference is this directory's frozen copy of the port's plain path
(plain PyTorch: every attention through the dense twins, the integer
program in Python), run one video at a time through its InferenceCore.step
(the single-stream semantics that BatchedPropagator's lockstep equals, video
by video), in float32 with TF32 off, on the same weights and frames. It
computes everything from the inputs: the first-frame encoding, the rings,
the long-term consolidation, every later frame.

Variants of the reference, each run the same way:
  "reference"  float32 compute and rings, TF32 off;
  "control"    one precision step below the configuration's: TF32
               convolutions and products for a float32 configuration;
               float8 (e4m3, one scale per tensor) convolution operands
               and ring entries for a bfloat16 one (models/layers.py:
               set_fp8, inference/memory.py:Bucket.quantize);
  "probe"      the reference with every input frame perturbed by a
               relative 2**-23 (one float32 rounding): how far this seed's
               network carries a rounding of its input;
  "plain"      the reference at the configuration's own precision (its
               compute and ring dtypes).

`gaps(candidates)` runs the reference once and returns, per checked video
and frame, the mean, median and largest |p_candidate - p_reference| over
the frame's 1 + n probability maps.

Why a ratio is compared (PERF.md): how far a rounding difference travels
through the network depends on the seed's random weights, so the absolute
gaps of sound runs spread over two orders of magnitude from seed to seed,
as do the control's, and overlap. Divided frame by frame by the gap of a
normaliser run on the same seed (the probe for a float32 configuration, the
plain run at the configuration's precision for a bfloat16 one), sound runs
read about 1 on every seed and the control tens to hundreds.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from reference.config import InferenceConfig, ModelConfig
from reference.inference.core import InferenceCore
from reference.inference.memory import Bucket
from reference.models.layers import FP8, set_fp8
from reference.models.network import DEVANetwork

PROBE_EPS = 2.0 ** -23


@contextlib.contextmanager
def tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8_ring(x: torch.Tensor) -> torch.Tensor:
    """x stored as float8 e4m3 with one scale for the appended block, read
    back in x's dtype."""
    scale = x.abs().amax().float().clamp(min=1e-30) / torch.finfo(FP8).max
    return ((x.float() / scale).to(FP8).float() * scale).to(x.dtype)


@contextlib.contextmanager
def fp8_rings(on: bool):
    saved = Bucket.quantize
    Bucket.quantize = staticmethod(_fp8_ring) if on else None
    try:
        yield
    finally:
        Bucket.quantize = saved


def _variant(config: dict, variant: str):
    """(model kwargs, inference kwargs, TF32, fp8) of a reference variant."""
    model_kw = dict(config["model"])
    infer_kw = dict(config["inference"])
    low = variant == "control"
    bf16 = model_kw.get("dtype", "float32") == "bfloat16"
    if variant != "plain":
        model_kw["dtype"] = "bfloat16" if (low and bf16) else "float32"
        infer_kw["ring_dtype"] = "bfloat16" if (low and bf16) else "float32"
    return model_kw, infer_kw, low and not bf16, low and bf16


def _model(model_kw: dict, weights: dict, device, fp8: bool):
    with torch.device("meta"):
        net = DEVANetwork(ModelConfig(**model_kw))
    net = net.to_empty(device=device)
    net.load_state_dict({k: v.to(device) for k, v in weights.items()},
                        strict=True)
    if fp8:
        set_fp8(net)
    return net.eval()


@torch.no_grad()
def run(config: dict, group, lanes: List[int], inputs, weights, device,
        variant: str = "reference"):
    """Yield (lane, frame index t >= 1, probabilities [1 + n, H, W]) of the
    reference variant over each lane's video, frame after frame."""
    model_kw, infer_kw, use_tf32, fp8 = _variant(config, variant)
    net = _model(model_kw, weights, device, fp8)
    gen = torch.Generator().manual_seed(0)

    def frame(video, t):
        x = torch.as_tensor(inputs.frame(video, t))
        if variant == "probe":
            sign = torch.randint(0, 2, x.shape, generator=gen) * 2 - 1
            x = x * (1 + PROBE_EPS * sign)
        return x

    with tf32(use_tf32), fp8_rings(fp8):
        for lane in lanes:
            video, n = group.bank[lane], group.objects[lane]
            core = InferenceCore(net, InferenceConfig(**infer_kw),
                                 device=device)
            core.step(frame(video, 0), inputs.mask(video, n),
                      list(range(1, n + 1)))
            length = group.lengths[lane]
            for t in range(1, length):
                yield lane, t, core.step(frame(video, t),
                                         end=t == length - 1)


@torch.no_grad()
def gaps(config: dict, group, candidates: Dict[str, Dict[int, list]],
         inputs, weights, device) -> Dict[str, Dict[int, list]]:
    """candidates: name -> lane -> outputs for frames 1, 2, ... (on the
    host). Runs the reference once; returns name -> lane -> [(mean, median,
    max) of |candidate - reference| per frame], over the frames each
    candidate holds."""
    lanes = sorted({lane for c in candidates.values() for lane in c})
    out = {name: {lane: [] for lane in c} for name, c in candidates.items()}
    for lane, t, ref in run(config, group, lanes, inputs, weights, device):
        for name, c in candidates.items():
            if lane in c and t - 1 < len(c[lane]):
                gap = (c[lane][t - 1].to(device) - ref).abs()
                out[name][lane].append((gap.mean().item(),
                                        gap.median().item(),
                                        gap.max().item()))
    return out


def outputs(config: dict, group, lanes, inputs, weights, device,
            variant: str) -> Dict[int, list]:
    """A reference variant's outputs on the host, lane -> frames 1, 2, ..."""
    got = {lane: [] for lane in lanes}
    for lane, _, prob in run(config, group, lanes, inputs, weights, device,
                             variant):
        got[lane].append(prob.cpu())
    return got


def summary(rows: Dict[int, list]) -> Dict[str, float]:
    """The statistics of one candidate's gaps (lane -> per-frame (mean,
    median, max)): the largest per-frame mean, median and max, and the
    largest first-frame mean."""
    every = [r for frames in rows.values() for r in frames]
    return {"mean": max(r[0] for r in every),
            "median": max(r[1] for r in every),
            "max": max(r[2] for r in every),
            "first": max(frames[0][0] for frames in rows.values()),
            "frames": len(every)}


def ratios(candidate: Dict[int, list], normaliser: Dict[int, list]):
    """The candidate's mean gap over the normaliser's mean gap on the same
    frame, for every checked frame."""
    return [c[0] / max(n[0], 1e-30) for lane in candidate
            for c, n in zip(candidate[lane], normaliser[lane])]


def compared(candidate: Dict[int, list], normaliser: Dict[int, list]):
    """The compared numbers of a candidate's gaps: the 90th percentile of
    its per-frame ratios, which a fault that runs through the group moves,
    and the largest, which a fault in a few frames moves (the last, shorter
    block of a group; one lane's tail)."""
    r = ratios(candidate, normaliser)
    return {"gap_ratio_p90": float(np.percentile(r, 90)),
            "gap_ratio_max": float(max(r))}


def check(config: dict, group, kept: Dict[int, list], inputs, weights,
          device) -> Dict[str, float]:
    """The compared numbers of the program's outputs `kept` (lane -> frames
    1, 2, ...), the program's gaps to the reference in units of the
    configuration's normaliser's gaps ("probe" for float32, "plain" for
    bfloat16: config["check"]["normaliser"]). Beside them, not compared,
    the largest per-frame mean gap."""
    norm = config["check"]["normaliser"]
    lanes = sorted(kept)
    base = outputs(config, group, lanes, inputs, weights, device, norm)
    g = gaps(config, group, {"program": kept, norm: base}, inputs, weights,
             device)
    return {**compared(g["program"], g[norm]),
            "prob_mean_gap": summary(g["program"])["mean"]}
