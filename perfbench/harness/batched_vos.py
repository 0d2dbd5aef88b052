"""Batched semi-supervised VOS: groups of videos in lockstep through
deva_tpu_torch's BatchedPropagator, as evaluation/eval_vos_batched_torch.py's
run_group drives them.

A group's first frames (and masks) go through `initialize`; then every
later frame through `step_all` (block 1) or blocks of frames through
`step_block` (block K, the last block of a group shorter). Ended videos
keep stepping on their last frame, and those outputs are discarded, as in
the driver. After each call the labels of every live frame (the argmax of
its probabilities) are copied to the host, as a saver takes them.

The traffic mix (perfbench/traffic/<mix>.json, `"driver": "batched_vos"`,
this module) lists its `videos`, each [name, frames, objects], at
`height` x `width`. They are grouped as eval_vos_batched_torch.main groups a
dataset: by object bucket (InferenceConfig.pad_objects of the video's
object count, the o_cap its group runs at), in the listing's order, `batch`
at a time. A pass runs every group once, in an order drawn from the seed,
so every seed runs the same work. Frames come from a bank of `batch`
synthetic videos (harness/frames.py) drawn from the seed; lane i of a pass's
k-th group reads bank video (k + i) mod batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from harness import frames as frame_bank
from harness.clock import Stopwatch, Window


@dataclasses.dataclass
class Group:
    names: List[str]
    lengths: List[int]
    objects: List[int]
    bank: List[int]  # the bank video of each lane


def driver_groups(traffic: dict, pad_objects) -> List[Group]:
    """The mix's groups, as the driver forms them (the buckets in ascending
    order; `bank` left empty)."""
    buckets: Dict[int, list] = {}
    for name, length, n in traffic["videos"]:
        buckets.setdefault(pad_objects(n), []).append((name, length, n))
    b = traffic["batch"]
    return [Group(*[list(x) for x in zip(*vids[i:i + b])], bank=[])
            for _, vids in sorted(buckets.items())
            for i in range(0, len(vids), b)]


def passes(traffic: dict, seed: int, pad_objects):
    """The endless sequence of passes over the mix (lists of groups), each
    in an order drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    base = driver_groups(traffic, pad_objects)
    b = traffic["batch"]
    while True:
        yield [dataclasses.replace(
            base[j], bank=[(k + i) % b for i in range(len(base[j].names))])
            for k, j in enumerate(rng.permutation(len(base)))]


class Inputs:
    """The frame bank and the first-frame masks of the mix."""

    def __init__(self, traffic: dict, seed: int, device):
        self.bank, self.labels = frame_bank.make_bank(
            traffic["batch"], max(v[1] for v in traffic["videos"]),
            traffic["height"], traffic["width"],
            max(v[2] for v in traffic["videos"]), seed, device)

    def frame(self, video: int, t: int) -> np.ndarray:
        return self.bank[video, t].numpy()

    def mask(self, video: int, n_objects: int) -> np.ndarray:
        return frame_bank.first_mask(self.labels[video, 0], n_objects)


class Keep:
    """Host copies of every lane's outputs of a group, for the check:
    buffers allocated (pinned, on a card) before the window, filled by
    copies that do not wait for the host."""

    def __init__(self, group: Group, height: int, width: int, device):
        pin = torch.device(device).type == "cuda"
        self.buffers = {lane: torch.empty(
            (length - 1, n + 1, height, width), pin_memory=pin)
            for lane, (length, n) in enumerate(zip(group.lengths,
                                                   group.objects))}
        self.filled = {lane: 0 for lane in self.buffers}

    def add(self, lane: int, prob: torch.Tensor) -> None:
        self.buffers[lane][self.filled[lane]].copy_(prob, non_blocking=True)
        self.filled[lane] += 1

    def outputs(self) -> Dict[int, list]:
        """lane -> [probabilities of frame 1, 2, ...] (after a
        synchronisation)."""
        return {lane: list(buf[:self.filled[lane]])
                for lane, buf in self.buffers.items()}


def run_group(propagator_cls, net, infer_cfg, block: int, group: Group,
              inputs: Inputs, tracer, window: Window = None,
              keep: Keep = None) -> None:
    """One group through the port. window: counts each live frame and its
    latency; keep: takes the probabilities [1 + n, H, W] of its lanes'
    later frames (1, 2, ...)."""
    device = next(net.parameters()).device
    watch = Stopwatch(device)
    b = len(group.lengths)
    lengths, max_len = group.lengths, max(group.lengths)
    images0 = [inputs.frame(v, 0) for v in group.bank]
    masks0 = [inputs.mask(v, n) for v, n in zip(group.bank, group.objects)]
    objects = [list(range(1, n + 1)) for n in group.objects]

    bp = propagator_cls(net, infer_cfg)
    token = watch.start()
    with tracer.span("pb.init"):
        bp.initialize(images0, masks0, objects)
    ms = watch.stop(token)
    if window is not None:
        window.done(b, ms)  # the group's first frames
    if not bp.use_lt:
        bp.reserve(max_len // infer_cfg.mem_every + 2)

    def frame_of(lane, t):
        return inputs.frame(group.bank[lane], min(t, lengths[lane] - 1))

    ti = 1
    while ti < max_len:
        k = min(block, max_len - ti)
        end = ti + k == max_len
        token = watch.start()
        if block == 1:
            frames = [frame_of(lane, ti) for lane in range(b)]
            with tracer.span("pb.step"):
                probs = bp.step_all(frames, end=end)[:, None]
        else:
            frames = [inputs.bank[group.bank[lane], ti:ti + k].numpy()
                      if ti + k <= lengths[lane] else
                      np.stack([frame_of(lane, t) for t in range(ti, ti + k)])
                      for lane in range(b)]
            with tracer.span("pb.step"):
                probs = bp.step_block(frames, end=end)
        ms = watch.stop(token)
        live = [(lane, i) for lane in range(b) for i in range(k)
                if ti + i < lengths[lane]]
        probs.argmax(2).to(torch.uint8).cpu()  # the labels a saver takes
        if keep is not None:
            for lane, i in live:
                keep.add(lane, probs[lane, i, :group.objects[lane] + 1])
        if window is not None:
            window.done(len(live), ms)
        ti += k


class BatchedVOS:
    """A run of a `batched_vos` cell: set-up, the window, the check."""

    def __init__(self, cell, seed: int, device, tracer):
        from deva_tpu_torch.config import InferenceConfig, ModelConfig
        from deva_tpu_torch.inference.batched import BatchedPropagator
        from deva_tpu_torch.models.network import DEVANetwork
        from harness import port_spans, weights

        self.cell, self.seed, self.device, self.tracer = \
            cell, seed, device, tracer
        cfg, self.traffic = cell.config, cell.traffic
        self.block = int(cfg["block"])
        self.inputs = Inputs(self.traffic, seed, device)
        sd = weights.make_state_dict(cfg["model"], seed, device)
        self.net = weights.load_into(DEVANetwork, ModelConfig(**cfg["model"]),
                                     sd, device)
        # the benchmark's copy of the weights waits on the host for the
        # reference
        self.weights = {k: v.cpu() for k, v in sd.items()}
        del sd
        self.infer_cfg = InferenceConfig(**cfg["inference"])
        self.propagator = BatchedPropagator
        port_spans.install(tracer, self.net)
        self.passes = passes(self.traffic, seed, self.infer_cfg.pad_objects)
        self.first_pass = next(self.passes)
        self.first = self.first_pass[0]
        self.keep = Keep(self.first, self.traffic["height"],
                         self.traffic["width"], device)

    def warm_up(self) -> None:
        """For each shape of the mix's groups (videos in the group, and
        their o_cap), one group of it as long as `warmup_length` (through
        the first long-term consolidation), outside the window."""
        w = self.traffic["warmup_length"]
        shapes = {}
        for g in self.first_pass:
            shapes.setdefault((len(g.names),
                               self.infer_cfg.pad_objects(max(g.objects))), g)
        for g in shapes.values():
            b = len(g.names)
            run_group(self.propagator, self.net, self.infer_cfg, self.block,
                      Group(g.names, [w] * b, g.objects, list(range(b))),
                      self.inputs, self.tracer)

    def measure(self, window: Window) -> None:
        """Whole passes until the window has expired (the pass in progress
        runs to its end, so every run measures the same work); the first
        group keeps its outputs."""
        groups, keep = self.first_pass, self.keep
        while True:
            for group in groups:
                run_group(self.propagator, self.net, self.infer_cfg,
                          self.block, group, self.inputs, self.tracer,
                          window, keep)
                keep = None
            window.end_pass()
            if window.expired():
                break
            groups = next(self.passes)

    def free(self) -> None:
        del self.net

    def check(self) -> Dict[str, float]:
        """The compared numbers of the program's kept outputs (reference/
        vos_check.py)."""
        from reference import vos_check
        return vos_check.check(self.cell.config, self.first,
                               self.keep.outputs(), self.inputs,
                               self.weights, self.device)


Driver = BatchedVOS  # the class harness/cli.py runs for this driver
