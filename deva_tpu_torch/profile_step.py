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
step otherwise, max_missed_detection_count 5; with --detections --batch
B, B such videos in lockstep through evaluation/eval_with_detections_
batched_torch.py's run_group_online (chip_smoke.py phase 7b: the forward
predictions of a detection frame in one forward_ids call,
incorporate_detection per core, the spans between detections through
BatchedDetectionPropagator.step_block), --segments segments a detection
frame, the frames read from the host as the driver reads them. Prints
every frame's wall time (a chunk's time shared by its frames; with
--batch, the time of one lockstep step of all B videos; with --detections
--batch, the driver's StepTimer's device time of each step per lockstep
frame), and
traces the last --window frames (whole chunks) with torch.profiler and the
port's own spans (utils/tracing.py, on for the window only): device time
per layer (the spans' profiler ranges: the step, the frame upload, the
model's four modes, the memory attention, long-term consolidation), each
span's calls and total and self host ms, the upload counters, device time
per kernel, the device's busy share of the window's wall time, and the
peak allocated device memory of the run.

    python -m deva_tpu_torch.profile_step --frames 60 --window 10 \
        --topk_method approx --chunk 5 --trace step_trace.json
    python -m deva_tpu_torch.profile_step --amp --topk_method approx --chunk 5
    python -m deva_tpu_torch.profile_step --batch 4 [--amp]
    python -m deva_tpu_torch.profile_step --detections
    python -m deva_tpu_torch.profile_step --detections --batch 4 --segments 4
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
import types

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from deva_tpu_torch.config import InferenceConfig, ModelConfig
from deva_tpu_torch.detection_clips import detections
from deva_tpu_torch.inference.batched import BatchedPropagator
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.models.network import DEVANetwork, init_weights
from deva_tpu_torch.utils import tracing

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


def _start_window(prof) -> None:
    """The window begins: the profiler, then the port's spans."""
    prof.start()
    tracing.enable()


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


class _Reader:
    """One in-memory video for the batched detection driver: frames [T, H,
    W, 3] on the host, detection id masks, segments_info dicts."""

    def __init__(self, frames, masks, infos, name):
        self.frames, self.masks, self.infos = frames, masks, infos
        self.vid_name = name

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return {"rgb": self.frames[i], "mask": self.masks[i], "info": {
            "frame": f"{i:05d}.jpg", "shape": self.frames[i].shape[:2],
            "need_resize": False, "save": True,
            "segments_info": self.infos[i]}}


class _WindowSaver:
    """A saver that writes nothing; the last video's starts the profiler
    after the step that saves frame `start` - 1 (the driver saves a step's
    frames after the step ran, before the next one starts)."""

    def __init__(self, prof=None, start=0, timer=None):
        self.prof, self.start, self.timer = prof, start, timer
        self.started = None

    def save_mask(self, prob, frame, **kwargs):
        if self.prof is not None and self.started is None and \
                int(frame[:5]) >= self.start - 1:
            _start_window(self.prof)
            self.started = (time.perf_counter(), self.timer.frames)


def _run_group_online(args, net, cfg, frames, det_masks, det_infos, prof):
    """--detections --batch: the videos through the batched driver's
    run_group_online, the profiler on from the first step after the one
    that saves frame frames - window - 1. -> (the StepTimer's device ms of
    each step per lockstep frame, lockstep frames in the window, the
    window's wall seconds)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "evaluation"))
    import eval_with_detections_batched_torch as bdrv

    class Timer(bdrv.StepTimer):
        """The driver's StepTimer, keeping each step's frame count."""

        def __init__(self, device):
            super().__init__(device)
            self.steps_frames = []

        def __exit__(self, *exc):
            self.steps_frames.append(self._count)
            return super().__exit__(*exc)

    timer = Timer(frames.device)
    states = []
    for v in range(args.batch):
        core = InferenceCore(net, cfg)
        core.enabled_long_id()
        core.object_manager._rng = np.random.default_rng(5 + v)
        saver = _WindowSaver(prof, args.frames - args.window, timer) \
            if v == args.batch - 1 else _WindowSaver()
        states.append(bdrv._VideoState(_Reader(
            frames[v].cpu().numpy(), det_masks, det_infos, f"video{v}"),
            core, saver))
    bdrv.run_group_online(net, cfg, states, types.SimpleNamespace(
        detection_every=5, save_all=False), "vipseg", timer)
    torch.cuda.synchronize()
    t0, frames0 = states[-1].saver.started
    step_ms = []
    for ms, n in zip(timer.steps_ms, timer.steps_frames):
        k = n // args.batch
        step_ms += [ms / k] * k
    return step_ms, (timer.frames - frames0) // args.batch, \
        time.perf_counter() - t0


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
    ap.add_argument("--segments", type=int, default=12,
                    help="segments a detection frame with --detections")
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the window here")
    args = ap.parse_args()
    if args.detections and args.chunk > 1:
        raise SystemExit("--detections runs frame by frame")
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
    cfg = InferenceConfig(
        topk_method=args.topk_method, max_missed_detection_count=5,
        preencode_blocks=args.preencode_blocks,
        ring_dtype=args.ring_dtype or ("bfloat16" if args.amp else "auto"))
    if args.batch > 1 and not args.detections:
        core = BatchedPropagator(net, cfg)
    elif args.batch == 1:
        core = InferenceCore(net, cfg)
    frames0 = frames[0]
    if args.detections:
        from deva_tpu_torch.inference.object_utils import \
            convert_json_dict_to_objects_info
        det_masks, det_infos = detections(args.frames, h, w, args.segments)
        if args.batch == 1:
            core.object_manager._rng = np.random.default_rng(5)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if args.detections and args.batch > 1:
        step_ms, window, window_s = _run_group_online(
            args, net, cfg, frames, det_masks, det_infos, prof)
    else:
        # frame 0 takes the mask; then runs of --chunk frames
        runs = [(0, 1)] + [(i, min(args.chunk, args.frames - i))
                           for i in range(1, args.frames, args.chunk)]
        start_window = next(i for i, n in runs
                            if i >= args.frames - args.window)
        step_ms = []
        for i, n in runs:
            if i == start_window:
                _start_window(prof)
                window_t0 = time.perf_counter()
            t0 = time.perf_counter()
            if args.detections and i % 5 == 0:
                core.incorporate_detection(
                    frames0[i], det_masks[i],
                    convert_json_dict_to_objects_info(
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
        window = args.frames - start_window
    tracing.disable()
    prof.stop()
    records, counters = tracing.drain()

    step = f"lockstep step of {args.batch} videos" if args.batch > 1 \
        else "frame"
    unit = "step" if args.batch > 1 else "frame"
    clock = "device (StepTimer)" if args.detections and args.batch > 1 \
        else "wall"
    print(f"{step} {clock} ms:", " ".join(f"{t:.1f}" for t in step_ms))
    print(f"median frames 10+: {statistics.median(step_ms[10:]):.3f} ms "
          f"per {step}")
    events = prof.key_averages()
    # on the device timeline, the spans' ranges appear as annotations
    # spanning their kernels; keep them apart from the kernels themselves
    on_device = [e for e in events if e.device_type.name == "CUDA"]
    layers = {e.key: _device_us(e) for e in on_device
              if e.key.startswith("deva.")}
    kernels = [e for e in on_device if e.key not in layers]
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
    for name, row in sorted(tracing.summary(records).items(),
                            key=lambda kv: -kv[1]["host_ms"]):
        print(f"span {name}: {row['calls']} calls, host "
              f"{row['host_ms'] / window:.3f} ms/{unit}, self "
              f"{row['self_ms'] / window:.3f} ms/{unit}")
    for name, n in sorted(counters.items()):
        print(f"counter {name}: {n} ({n / window:.0f}/{unit})")
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
