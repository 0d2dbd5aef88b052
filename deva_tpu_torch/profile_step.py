"""Where the time of deva_tpu_torch's 480p propagation step goes, on a CUDA
device.

Runs the main path (the default InferenceConfig with --topk_method, two
objects, seeded weights, smooth-noise 854x480 frames like chip_smoke.py;
--amp for bf16 compute and bf16 rings, --ring_dtype for the rings alone,
as in eval_vos_torch.py)
for --frames frames, the first through InferenceCore.step and the others
through step (--chunk 1) or step_chunk in chunks of --chunk frames (with
--preencode_blocks, the pre-encoded block body). With --batch B, B videos
in lockstep through inference/batched.py's BatchedPropagator instead
(video 0 the frames above, the others seeded apart): the first frame
through initialize, the others through step_all (--chunk 1) or step_block
by --chunk. With --detections, the online detection-fusion path of
chip_smoke.py phase 6b instead: InferenceCore.incorporate_detection every
5th frame with 12 VIPSeg-style segments (detection_clips.detections),
step otherwise, max_missed_detection_count 5. Prints every frame's wall time (a chunk's
time shared by its frames; with --batch, the time of one lockstep step of
all B videos), and
traces the last --window frames (whole chunks) with torch.profiler: device
time per layer (the model's four modes and the memory attention, as
profiler ranges), device time per kernel, the device's busy share of the
window's wall time, and the peak allocated device memory of the run.

    python -m deva_tpu_torch.profile_step --frames 60 --window 10 \
        --topk_method approx --chunk 5 --trace step_trace.json
    python -m deva_tpu_torch.profile_step --amp --topk_method approx --chunk 5
    python -m deva_tpu_torch.profile_step --batch 4 [--amp]
    python -m deva_tpu_torch.profile_step --detections
"""
from __future__ import annotations

import argparse
import functools
import os
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from deva_tpu_torch.config import InferenceConfig, ModelConfig
from deva_tpu_torch.detection_clips import detections
from deva_tpu_torch.inference.batched import BatchedPropagator
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.models.network import DEVANetwork, init_weights


LAYERS = ("encode_image", "transform_key", "encode_mask", "segment",
          "attention")
# kernels summed by kind, by substrings of their names (first match wins):
# the port's four attention kernels, layout transposes around cuDNN's
# convolutions, the convolutions and GEMMs, dtype casts
KERNEL_GROUPS = (
    ("attention kernels", ("sim_topk", "topk_readout", "segmax",
                           "denom_readout")),
    ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("convolutions and GEMMs", ("conv", "xmma", "implicit", "cudnn",
                                "gemm", "cutlass", "sm90", "sm80")),
    ("casts", ("copy_kernel", "to_copy")))


def _labeled(fn, name):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return run


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--topk_method", default="auto",
                    choices=["auto", "exact", "approx"])
    ap.add_argument("--chunk", type=int, default=1,
                    help="frames per step_chunk call; 1 = step per frame")
    ap.add_argument("--preencode_blocks", action="store_true",
                    help="step_chunk's pre-encoded block body")
    ap.add_argument("--amp", action="store_true",
                    help="bfloat16 compute and (unless --ring_dtype) rings")
    ap.add_argument("--ring_dtype", default=None,
                    help="float32/bfloat16; default bfloat16 with --amp")
    ap.add_argument("--batch", type=int, default=1,
                    help="videos in lockstep (BatchedPropagator); 1 = the "
                    "single-stream InferenceCore")
    ap.add_argument("--detections", action="store_true",
                    help="online detection fusion (chip_smoke.py phase 6b) "
                    "in place of the two-object VOS path")
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the window here")
    args = ap.parse_args()
    if args.detections and (args.batch > 1 or args.chunk > 1):
        raise SystemExit("--detections runs one video, frame by frame")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    h, w = 480, 854

    def video(seed):
        rng = np.random.default_rng(seed)
        base = rng.standard_normal((h // 8, -(-w // 8), 3)).astype(np.float32)
        return torch.stack([
            torch.from_numpy((base + 0.1 * rng.standard_normal(base.shape))
                             .repeat(8, 0).repeat(8, 1)[:h, :w]
                             .astype(np.float32))
            for _ in range(args.frames)]).to(dev)

    # [B, T, H, W, 3]: video 0 is the single-stream run's
    frames = torch.stack([video(11 + v) for v in range(args.batch)])
    mask = np.zeros((h, w), np.int64)
    mask[60:300, 330:520] = 1
    mask[260:450, 250:620] = 2

    net = init_weights(DEVANetwork(ModelConfig(
        dtype="bfloat16" if args.amp else "auto")), seed=0).to(dev).eval()
    for mode in LAYERS[:4]:
        setattr(net, mode, _labeled(getattr(net, mode), mode))
    cfg = InferenceConfig(
        topk_method=args.topk_method, max_missed_detection_count=5,
        preencode_blocks=args.preencode_blocks,
        ring_dtype=args.ring_dtype or ("bfloat16" if args.amp else "auto"))
    if args.batch > 1:
        core = BatchedPropagator(net, cfg)
        core._attend_and_count = _labeled(core._attend_and_count,
                                          "attention")
    else:
        core = InferenceCore(net, cfg)
        # the fused step's attention, and the composed path's
        core._fused._attend_rings = _labeled(core._fused._attend_rings,
                                             "attention")
    frames0 = frames[0]
    if args.detections:
        from deva_tpu_torch.inference.object_utils import \
            convert_json_dict_to_objects_info
        det_masks, det_infos = detections(args.frames, h, w)
        core.object_manager._rng = np.random.default_rng(5)

    # frame 0 takes the mask; then runs of --chunk frames
    runs = [(0, 1)] + [(i, min(args.chunk, args.frames - i))
                       for i in range(1, args.frames, args.chunk)]
    start_window = next(i for i, n in runs
                        if i >= args.frames - args.window)
    step_ms = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i, n in runs:
        if i == start_window:
            prof.start()
            window_t0 = time.perf_counter()
        if i == 1 and args.batch == 1:
            core.memory.match_memory = _labeled(core.memory.match_memory,
                                                "attention")
        t0 = time.perf_counter()
        if args.detections and i % 5 == 0:
            core.incorporate_detection(
                frames0[i], det_masks[i], convert_json_dict_to_objects_info(
                    det_masks[i], det_infos[i], dataset="vipseg"))
        elif args.detections:
            core.step(frames0[i])
        elif args.batch > 1:
            if i == 0:
                core.initialize(frames[:, 0], [mask] * args.batch,
                                [[1, 2]] * args.batch)
            elif args.chunk == 1:
                core.step_all(frames[:, i])
            else:
                core.step_block(frames[:, i:i + n])
        elif i == 0:
            core.step(frames0[0], mask, [1, 2])
        elif args.chunk == 1:
            core.step(frames0[i])
        else:
            core.step_chunk(frames0[i:i + n])
        torch.cuda.synchronize()
        step_ms += [(time.perf_counter() - t0) * 1000 / n] * n
    window_s = time.perf_counter() - window_t0
    prof.stop()
    window = args.frames - start_window

    step = f"lockstep step of {args.batch} videos" if args.batch > 1 \
        else "frame"
    unit = "step" if args.batch > 1 else "frame"
    print(f"{step} wall ms:", " ".join(f"{t:.1f}" for t in step_ms))
    print(f"median frames 10+: {statistics.median(step_ms[10:]):.3f} ms "
          f"per {step}")
    events = prof.key_averages()
    # on the device timeline, the layer ranges appear as annotations
    # spanning their kernels; keep them apart from the kernels themselves
    on_device = [e for e in events if e.device_type.name == "CUDA"]
    layers = {e.key: _device_us(e) for e in on_device if e.key in LAYERS}
    kernels = [e for e in on_device if e.key not in LAYERS]
    busy_us = sum(_device_us(e) for e in kernels)
    print(f"window: {window} {unit}s, wall {window_s * 1000:.1f} ms, "
          f"device busy {busy_us / 1000:.1f} ms "
          f"({busy_us / (window_s * 1e6):.1%}), idle "
          f"{1 - busy_us / (window_s * 1e6):.1%}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"peak allocated {peak / 2**20:.1f} MiB over the run, "
          f"{(peak - frames.numel() * 4) / 2**20:.1f} MiB without the "
          f"{frames.numel() * 4 / 2**20:.1f} MiB of input frames kept on "
          "the device")
    for name, us in sorted(layers.items(), key=lambda kv: -kv[1]):
        print(f"layer {name}: {us / 1000 / window:.3f} ms/{unit} on the "
              f"device timeline ({us / (window_s * 1e6):.1%} of the wall)")
    groups = {}
    for e in kernels:
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in e.key.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + _device_us(e)
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"group {group}: {us / 1000 / window:.3f} ms/{unit} "
              f"({us / max(busy_us, 1e-9):.1%} of the busy time)")
    for e in sorted(kernels, key=_device_us, reverse=True)[:25]:
        print(f"kernel {_device_us(e) / 1000 / window:8.3f} ms/{unit} "
              f"x{e.count / window:5.1f}  {e.key[:110]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
