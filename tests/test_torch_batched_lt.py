"""deva_tpu_torch's BatchedPropagator against deva_tpu's with long-term
memory (tests/torch_batched_common.py says how): lockstep consolidation,
usage counting and per-video eviction, for both top-k methods
(tests/test_batched.py::test_batched_long_term_equals_sequential)."""
import pytest

from torch_batched_common import (LT_CFG, pair,  # noqa: F401
                                  pallas_interpret, same_schedule,
                                  step_both, videos)


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_long_term_matches_deva_tpu(method):
    """12 frames, 24 tokens a frame, a write every frame: consolidation
    every two writes after warm-up and eviction at 16 long-term tokens,
    frame by frame against deva_tpu's batched path; the ring and long-term
    sizes and the schedule must be equal throughout."""
    t = 12
    vids = videos(9, t)
    ours, ref = pair(vids, topk_method=method, **LT_CFG)
    limit = LT_CFG["max_long_term_elements"] - LT_CFG["num_prototypes"]
    evicted = False
    for ti in range(1, t):
        step_both(ours, ref, [v[0][ti] for v in vids], label=f"frame {ti}")
        same_schedule(ours, ref)
        evicted |= bool((ours.lt_sizes >= limit).any())
    assert ours._lt_engaged and evicted, ours.lt_sizes
