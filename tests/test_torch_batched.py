"""deva_tpu_torch's BatchedPropagator against deva_tpu's without long-term
memory (tests/torch_batched_common.py says how), plus its end-of-video and
usage-counting guards: the cases of tests/test_batched.py."""
import numpy as np
import pytest

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.batched import BatchedPropagator

from torch_batched_common import (H, W, nets, pair,  # noqa: F401
                                  pallas_interpret, same_schedule,
                                  step_both, video, videos)


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_no_long_term_matches_deva_tpu(method):
    """tests/test_batched.py::test_batched_equals_sequential's configuration:
    no long-term memory, a write every second frame, 1 and 2 objects."""
    vids = videos(6, 5)
    ours, ref = pair(vids, mem_every=2, top_k=8, enable_long_term=False,
                     topk_method=method)
    assert ours.o_cap == 2 and ours.num_obj.tolist() == [1, 2]
    for ti in range(1, 5):
        step_both(ours, ref, [v[0][ti] for v in vids], label=f"frame {ti}")
    same_schedule(ours, ref)


def test_block_end_no_write():
    """tests/test_batched.py::test_block_end_no_write: an end=True block
    writes no memory and leaves the memory schedule as it was."""
    frames, mask0 = videos(8, 4)[0]
    bp = BatchedPropagator(nets()[0], InferenceConfig(
        mem_every=3, top_k=8, enable_long_term=False))
    bp.initialize([frames[0]], [mask0], [[1]])
    size0 = int(bp.sizes[0])
    probs = bp.step_block(np.stack([np.stack(frames[1:4])]), end=True)
    assert probs.shape == (1, 3, 2, H, W)
    assert int(bp.sizes[0]) == size0
    assert bp._last_mem_ti() == 0


def test_eviction_requires_usage_counting():
    """tests/test_batched.py::test_batched_lt_eviction_requires_usage_
    counting: saturating long-term memory with usage counting off raises
    (every usage is 0, so the strictly-greater threshold would wipe the
    long-term store) instead of corrupting state."""
    cfg = InferenceConfig(mem_every=1, top_k=8, enable_long_term=True,
                          enable_long_term_count_usage=False,
                          max_mid_term_frames=3, min_mid_term_frames=1,
                          num_prototypes=8, max_long_term_elements=10,
                          topk_method="exact")
    frames, mask0 = video(np.random.default_rng(12), 8, 1)
    bp = BatchedPropagator(nets()[0], cfg)
    bp.initialize([frames[0]], [mask0], [[1]])
    with pytest.raises(AssertionError, match="count_usage"):
        for ti in range(1, 8):
            bp.step_all([frames[ti]])
