"""Packed live object slots (models/network.py:LiveSlots): `segment` and
`encode_mask` on the live (video, object) slots only, against the same
calls on every slot, at published widths on 64x96 frames; and a
BatchedPropagator group whose videos pad 5 and 3 objects to o_cap 8 against
each video's own InferenceCore.

Live outputs agree to 1e-5 (the convolutions sum in another order at another
batch size). Every probability channel agrees to 1e-5, padded ones included:
a padded slot reaches the aggregate as probability 0 either way. Padded
sensory rows keep the incoming state and padded value rows are 0."""
import functools

import numpy as np
import pytest
import torch

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.batched import BatchedPropagator
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.models.network import (DEVANetwork, init_weights,
                                           live_slots)
from deva_tpu_torch.utils import tracing

from torch_batched_common import compare

H, W = 64, 96
TOL = dict(rtol=0, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _net():
    return init_weights(DEVANetwork(), seed=0).eval()


@pytest.fixture
def traced():
    """The port's tracer on for the test, its counters returned by the
    handed-back function."""
    tracing.drain()
    tracing.enable()
    try:
        yield lambda: tracing.drain()[1]
    finally:
        tracing.disable()
        tracing.drain()


def _inputs(b, o_cap, seed):
    g = torch.Generator().manual_seed(seed)
    image = torch.randn((b, 3, H, W), generator=g)
    ms, _ = _net().encode_image(image)
    grouped = lambda: torch.randn((b, o_cap, 512, H // 16, W // 16),
                                  generator=g)
    return (image, ms, grouped(), grouped(),
            torch.rand((b, o_cap, H, W), generator=g))


@pytest.mark.parametrize("o_cap,num_obj", [(8, [5, 3]), (2, [1, 2, 2])])
@torch.no_grad()
def test_packed_modes_match_every_slot(traced, o_cap, num_obj):
    b = len(num_obj)
    net = _net()
    image, ms, readout, sensory, masks = _inputs(b, o_cap, seed=o_cap)
    live = live_slots(num_obj, o_cap, "cpu")
    sel = (torch.arange(o_cap)[None] < torch.tensor(num_obj)[:, None])
    selector = sel.float()
    n_slots, n_live = b * o_cap, sum(num_obj)
    assert len(live.index) == n_live

    full = net.segment(ms, readout, sensory, masks, selector=selector)
    assert traced() == {"segment.slots": n_slots,
                        "segment.live_slots": n_slots}
    packed = net.segment(ms, readout, sensory, masks, selector=selector,
                         live=live)
    assert traced() == {"segment.slots": n_slots,
                        "segment.live_slots": n_live}
    torch.testing.assert_close(packed[2], full[2], **TOL)  # every channel
    torch.testing.assert_close(packed[0][sel], full[0][sel], **TOL)
    assert torch.equal(packed[0][~sel], sensory[~sel])
    kept = net.segment(ms, readout, sensory, masks, selector=selector,
                       update_sensory=False, live=live)
    assert kept[0] is sensory
    torch.testing.assert_close(kept[2], packed[2], rtol=0, atol=0)
    traced()

    value, deep = net.encode_mask(image, ms[0], sensory, masks)
    assert traced() == {"encode_mask.slots": n_slots,
                        "encode_mask.live_slots": n_slots}
    p_value, p_deep = net.encode_mask(image, ms[0], sensory, masks,
                                      live=live)
    assert traced() == {"encode_mask.slots": n_slots,
                        "encode_mask.live_slots": n_live}
    torch.testing.assert_close(p_value[sel], value[sel], **TOL)
    torch.testing.assert_close(p_deep[sel], deep[sel], **TOL)
    assert not p_value[~sel].any()
    assert torch.equal(p_deep[~sel], sensory[~sel])


@torch.no_grad()
def test_every_slot_live_runs_the_unpacked_modes():
    """A live set that covers every slot is no packing: the same
    operations, so bitwise the same outputs; and live slots need a selector
    and no object-sharding group."""
    net = _net()
    image, ms, readout, sensory, masks = _inputs(2, 2, seed=5)
    live = live_slots([2, 2], 2, "cpu")
    selector = torch.ones((2, 2))
    for a, b in zip(net.segment(ms, readout, sensory, masks,
                                selector=selector, live=live),
                    net.segment(ms, readout, sensory, masks,
                                selector=selector)):
        assert torch.equal(a, b)
    for a, b in zip(net.encode_mask(image, ms[0], sensory, masks, live=live),
                    net.encode_mask(image, ms[0], sensory, masks)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="selector"):
        net.segment(ms, readout, sensory, masks, live=live)
    with pytest.raises(ValueError, match="group"):
        net.segment(ms, readout, sensory, masks, selector=selector,
                    live=live, group=object())


def _video(rng, t, n_obj):
    """t frames of a moving texture and a first mask of n_obj boxes."""
    base = rng.standard_normal((H // 8, W // 8, 3)).astype(np.float32)
    frames = [np.kron(base + 0.1 * rng.standard_normal(base.shape),
                      np.ones((8, 8, 1))).astype(np.float32)
              for _ in range(t)]
    mask0 = np.zeros((H, W), np.int64)
    for i in range(n_obj):
        r, c = divmod(i, 3)
        mask0[4 + 30 * r:28 + 30 * r, 4 + 30 * c:28 + 30 * c] = i + 1
    return frames, mask0


COUNTS = [5, 3]
# long-term memory on, a write every second frame (24 tokens a frame) and a
# consolidation at frame 4
LT_CFG = InferenceConfig(mem_every=2, top_k=8, enable_long_term=True,
                         enable_long_term_count_usage=True,
                         max_mid_term_frames=3, min_mid_term_frames=1,
                         num_prototypes=8, max_long_term_elements=10000,
                         topk_method="exact")


@functools.lru_cache(maxsize=None)
def _sequential(t):
    """The videos, and each one's own InferenceCore run: its probabilities
    of frames 1.., ring size and long-term size."""
    rng = np.random.default_rng(21)
    vids = [_video(rng, t, n) for n in COUNTS]
    runs = []
    for frames, mask0 in vids:
        core = InferenceCore(_net(), LT_CFG)
        core.step(frames[0], mask0, list(range(1, int(mask0.max()) + 1)))
        probs = [core.step(f).numpy() for f in frames[1:]]
        runs.append((probs, core.memory.buckets[0].size,
                     core.memory.long_buckets[0].size))
    return vids, runs


@pytest.mark.parametrize("block", [1, 2])
def test_packed_group_matches_each_videos_core(block):
    """Videos of 5 and 3 objects at o_cap 8 (the second's slots 5/8
    padding), through a consolidation: step_all (block 1) and step_block
    (blocks of 2) against each video's own InferenceCore, within compare()'s
    atol; ring and long-term sizes equal."""
    t = 7
    vids, runs = _sequential(t)
    bp = BatchedPropagator(_net(), LT_CFG)
    bp.initialize([v[0][0] for v in vids], [v[1] for v in vids],
                  [list(range(1, n + 1)) for n in COUNTS])
    assert bp.o_cap == 8 and len(bp.live.index) == sum(COUNTS)
    for ti in range(1, t, block):
        if block == 1:
            probs = bp.step_all([v[0][ti] for v in vids]).numpy()[:, None]
        else:
            probs = bp.step_block(np.stack([np.stack(v[0][ti:ti + block])
                                            for v in vids])).numpy()
        for i in range(block):
            for vi, n in enumerate(COUNTS):
                compare(runs[vi][0][ti + i - 1], probs[vi, i, :n + 1], 5e-3,
                        f"frame {ti + i} video {vi}")
    for vi, (_, size, lt_size) in enumerate(runs):
        assert int(bp.sizes[vi]) == size
        assert int(bp.lt_sizes[vi]) == lt_size > 0
