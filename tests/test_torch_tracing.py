"""deva_tpu_torch/utils/tracing.py and its spans on the inference path.

A BatchedPropagator group (initialize, step_all, step_block, a long-term
consolidation) runs under torch.profiler with tracing off and on: off, no
`deva.` range and no record; on, the spans nest as the step path places
them, share their deva.step's id, sit on the profiler's clock, count the
frames' bytes and the model modes' object slots, and leave the outputs
bitwise as they were.
"""
import functools
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deva_tpu_torch.config import InferenceConfig, ModelConfig
from deva_tpu_torch.inference import batched, memory
from deva_tpu_torch.inference.batched import BatchedPropagator
from deva_tpu_torch.inference.core import InferenceCore, frames_to_device
from deva_tpu_torch.models.network import DEVANetwork, init_weights
from deva_tpu_torch.utils import tracing

H, W = 64, 96
B, T = 2, 19
# a write every 3 frames, blocks of 3 ending on the writes, and the working
# memory full at 4 frames of tokens: consolidations after the writes of
# frames 9 and 15
LT_CFG = dict(mem_every=3, top_k=8, enable_long_term=True,
              enable_long_term_count_usage=True, max_mid_term_frames=4,
              min_mid_term_frames=2, num_prototypes=8,
              max_long_term_elements=24)
MODES = ("deva.encode_image", "deva.transform_key", "deva.encode_mask",
         "deva.segment")


@functools.lru_cache(maxsize=None)
def _net():
    return init_weights(DEVANetwork(ModelConfig()), seed=0).eval()


def _clip():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((B, 1, H // 8, W // 8, 3))
    noise = 0.1 * rng.standard_normal((B, T, H // 8, W // 8, 3))
    frames = np.kron(base + noise, np.ones((1, 1, 8, 8, 1)))
    mask = np.zeros((H, W), np.int64)
    mask[8:28, 10:40] = 1
    mask[36:60, 50:90] = 2
    return frames.astype(np.float32), mask


def _group(frames, mask):
    """initialize, step_all on frames 1-3 (a list, then a stacked array),
    step_block by 3 over the rest (stacked, then a list of [K, H, W, 3]);
    -> (outputs, the calls' frames as each call took them)."""
    bp = BatchedPropagator(_net(), InferenceConfig(**LT_CFG))
    calls = [[frames[v, 0] for v in range(B)]]
    bp.initialize(calls[0], [mask] * B, [[1, 2], [1]])
    outs = []
    for t in range(1, 4):
        f = [frames[v, t] for v in range(B)] if t % 2 else frames[:, t]
        calls.append(f)
        outs.append(bp.step_all(f))
    for i, t in enumerate(range(4, T, 3)):
        f = frames[:, t:t + 3] if i % 2 else \
            [frames[v, t:t + 3] for v in range(B)]
        calls.append(f)
        outs.append(bp.step_block(f))
    return outs, calls


def _traced_group(on: bool, monkeypatch=None):
    """The group under torch.profiler, the tracer on or off; -> (outputs,
    the calls' frames, the records, the counters, the profiler's events,
    consolidations counted at the prototype selection)."""
    consolidations = []
    real = batched.consolidate_prototypes_batched

    def spy(*args, **kwargs):
        consolidations.append(1)
        return real(*args, **kwargs)

    frames, mask = _clip()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batched, "consolidate_prototypes_batched", spy)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if on:
                tracing.enable()
            try:
                outs, calls = _group(frames, mask)
            finally:
                tracing.disable()
    records, counters = tracing.drain()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("deva.")]
    return outs, calls, records, counters, events, len(consolidations)


@pytest.fixture(scope="module")
def runs():
    tracing.drain()
    return {"off": _traced_group(False), "on": _traced_group(True)}


def test_off_records_nothing(runs):
    _, _, records, counters, events, _ = runs["off"]
    assert records == [] and counters == {}
    assert [e.name() for e in events] == []
    assert tracing.span("deva.x") is tracing.span("deva.y")
    assert tracing.step() is tracing.span("deva.x")


def test_outputs_bitwise_equal_on_and_off(runs):
    off, on = runs["off"][0], runs["on"][0]
    assert len(off) == len(on) == 3 + 5
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_spans_nest_under_their_step(runs):
    _, calls, records, _, _, _ = runs["on"]
    steps = [i for i, r in enumerate(records) if r.name == tracing.STEP]
    # initialize (its cores' InferenceCore.step opens none), step_all x3,
    # step_block x5
    assert len(steps) == len(calls) == 9
    assert [records[i].step for i in steps] == list(range(9))
    for i, r in enumerate(records):
        if r.name == tracing.STEP:
            assert r.parent is None
            continue
        parent = records[r.parent]
        assert parent.name == tracing.STEP, r
        assert r.step == parent.step
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    names = Counter(r.name for r in records)
    # per lockstep frame one encode_image, transform_key, segment and
    # attention; initialize encodes each video's first frame alone
    frames = 3 + 15
    assert names["deva.encode_image"] == names["deva.transform_key"] == \
        frames + B
    assert names["deva.segment"] == names["deva.attention"] == frames
    # memory writes: each video's first frame, then frames 3, 6, ..., 18
    assert names["deva.encode_mask"] == B + 6
    assert names["deva.upload"] == len(calls) - 1 + B
    by_step = Counter(r.step for r in records)
    assert all(by_step[s] >= 5 for s in range(9))


def test_records_sit_on_the_profilers_ranges(runs):
    """Each record holds its profiler range: read just before the range
    opens and just after it closes, on the profiler's clock."""
    _, _, records, _, events, _ = runs["on"]
    assert Counter(r.name for r in records) == \
        Counter(e.name() for e in events)
    for name in set(r.name for r in records):
        recs = [r for r in records if r.name == name]
        evs = sorted((e for e in events if e.name() == name),
                     key=lambda e: e.start_ns())
        for r, e in zip(recs, evs):
            assert r.start_ns <= e.start_ns() + 100_000
            assert e.start_ns() + e.duration_ns() <= r.end_ns + 100_000
            assert abs(e.start_ns() - r.start_ns) < 20_000_000


def test_self_time_is_total_less_children(runs):
    records = runs["on"][2]
    rows = tracing.summary(records)
    steps = [r for r in records if r.name == tracing.STEP]
    children = sum(r.end_ns - r.start_ns for r in records
                   if r.parent is not None)
    total = sum(r.end_ns - r.start_ns for r in steps)
    step = rows[tracing.STEP]
    assert step["calls"] == len(steps)
    assert step["host_ms"] == pytest.approx(total / 1e6, rel=1e-12)
    assert step["self_ms"] == pytest.approx((total - children) / 1e6,
                                            rel=1e-9)
    for name in MODES + ("deva.attention", "deva.upload"):
        # no span opens inside these: self time is their whole time
        assert rows[name]["self_ms"] == pytest.approx(rows[name]["host_ms"])


def test_summary_of_nested_records():
    rec = tracing.Record
    records = [rec("deva.step", 0, 10_000_000, None, 0),
               rec("deva.upload", 1_000_000, 2_000_000, 0, 0),
               rec("deva.segment", 3_000_000, 7_000_000, 0, 0),
               rec("deva.attention", 4_000_000, 5_000_000, 2, 0),
               rec("deva.step", 20_000_000, 21_000_000, None, 1)]
    rows = tracing.summary(records)
    assert rows["deva.step"] == {"calls": 2, "host_ms": 11.0,
                                 "self_ms": 6.0}
    assert rows["deva.segment"] == {"calls": 1, "host_ms": 4.0,
                                    "self_ms": 3.0}
    assert rows["deva.attention"]["self_ms"] == 1.0


def test_upload_counts_the_frames_bytes(runs):
    _, calls, _, counters, _, _ = runs["on"]
    nbytes = sum(sum(f.nbytes for f in c) if isinstance(c, list)
                 else c.nbytes for c in calls)
    assert nbytes == B * T * H * W * 3 * 4
    assert {k: v for k, v in counters.items() if k.startswith("upload.")} \
        == {"upload.bytes": nbytes, "upload.pageable_bytes": nbytes}


def test_mode_counters_count_the_live_slots(runs):
    """segment and encode_mask count their object slots and the live ones.
    The videos hold 2 objects and 1 at o_cap 2: every lockstep frame
    decodes, and every memory write encodes, 3 of 4 slots; initialize's
    cores encode their own o_cap (2 and 1), every slot live."""
    _, _, records, counters, _, _ = runs["on"]
    writes = sum(r.name == "deva.encode_mask" for r in records) - B
    assert writes == 6
    assert counters["segment.slots"] == 4 * (T - 1)
    assert counters["segment.live_slots"] == 3 * (T - 1)
    assert counters["encode_mask.slots"] == 3 + 4 * writes
    assert counters["encode_mask.live_slots"] == 3 + 3 * writes


@pytest.mark.parametrize("kind", ["array", "tensor", "list", "float64"])
def test_upload_of_one_call(kind):
    frames = _clip()[0][:, 0]
    x = {"array": frames, "tensor": torch.from_numpy(frames),
         "list": list(frames),
         "float64": frames.astype(np.float64)}[kind]
    tracing.enable()
    try:
        out = frames_to_device(x, torch.device("cpu"))
    finally:
        tracing.disable()
    records, counters = tracing.drain()
    assert torch.equal(out, torch.from_numpy(frames))
    assert [r.name for r in records] == ["deva.upload"]
    assert records[0].step is None and records[0].parent is None
    # the bytes as f32, whatever the host dtype
    assert counters == {"upload.bytes": frames.nbytes,
                        "upload.pageable_bytes": frames.nbytes}


def test_consolidate_spans_count_the_consolidations(runs):
    records, consolidations = runs["on"][2], runs["on"][5]
    assert consolidations == 2
    assert sum(r.name == "deva.consolidate" for r in records) == 2
    assert runs["off"][5] == 2


def test_single_stream_consolidate_and_step(monkeypatch):
    """InferenceCore.step: one deva.step a frame, its upload and attention
    inside it, and one deva.consolidate per consolidation of
    MemoryEngine.maybe_consolidate."""
    compress = []
    real = memory.MemoryEngine._compress
    monkeypatch.setattr(memory.MemoryEngine, "_compress",
                        lambda self, bid: compress.append(bid) or
                        real(self, bid))
    frames, mask = _clip()
    core = InferenceCore(_net(), InferenceConfig(**LT_CFG))
    tracing.enable()
    try:
        core.step(frames[0, 0], mask, [1, 2])
        for t in range(1, 14):
            core.step(torch.from_numpy(frames[0, t]))
    finally:
        tracing.disable()
    records, counters = tracing.drain()
    names = Counter(r.name for r in records)
    assert names[tracing.STEP] == names["deva.upload"] == 14
    assert names["deva.attention"] == names["deva.segment"] == 13
    assert len(compress) >= 1
    assert names["deva.consolidate"] == len(compress)
    assert counters["upload.bytes"] == 14 * frames[0, 0].nbytes
    for r in records:
        assert (r.parent is None) == (r.name == tracing.STEP)


def test_drain_refuses_an_open_span():
    tracing.enable()
    try:
        with tracing.span("deva.x"):
            with pytest.raises(RuntimeError):
                tracing.drain()
    finally:
        tracing.disable()
    records, _ = tracing.drain()
    assert [r.name for r in records] == ["deva.x"]


@pytest.mark.cuda
def test_pinned_frames_are_not_pageable():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    frames = torch.from_numpy(_clip()[0][:, 0])
    pinned = frames.pin_memory()
    on_card = frames.to(dev)
    tracing.enable()
    try:
        a = frames_to_device(pinned, dev)
        b = frames_to_device(frames, dev)
        c = frames_to_device(on_card, dev)
        d = frames_to_device([pinned[0], frames[1]], dev)
    finally:
        tracing.disable()
    _, counters = tracing.drain()
    for x in (a, b, c, d):
        assert torch.equal(x.cpu(), frames)
    n = frames.numel() * 4
    assert counters == {"upload.bytes": 3 * n,
                        "upload.pageable_bytes": n + n // 2}
