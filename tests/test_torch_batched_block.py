"""deva_tpu_torch's BatchedPropagator: step_block against deva_tpu's and
against its own step_all, the delayed consolidation trigger against
deva_tpu (tests/torch_batched_common.py says how), and the batched path
against the port's own sequential InferenceCore at tests/test_batched.py's
budgets (at most 2% of the pixels off by more than 5e-3, at most 2% argmax
flips)."""
import jax.numpy as jnp
import numpy as np
import pytest

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.batched import BatchedPropagator
from deva_tpu_torch.inference.core import InferenceCore

from torch_batched_common import (H, LT_CFG, OBJECTS, W,  # noqa: F401
                                  compare, nets, pair, pallas_interpret,
                                  same_schedule, step_both, videos)


def test_step_block_matches_deva_tpu_and_step_all():
    """tests/test_batched.py::test_block_equals_per_frame_stepping: blocks of
    K=3 (two read frames, then a write) against deva_tpu's step_block, and
    against the port's own step_all within 1e-5 (the same operations)."""
    t = 7
    vids = videos(7, t)
    cfg = dict(mem_every=3, top_k=8, enable_long_term=False)
    ours, ref = pair(vids, **cfg)
    per_frame = BatchedPropagator(nets()[0], InferenceConfig(**cfg))
    per_frame.initialize([v[0][0] for v in vids], [v[1] for v in vids],
                         OBJECTS)
    for bp in (ours, ref):
        bp.reserve(2)
    for t0 in (1, 4):
        block = np.stack([np.stack(v[0][t0:t0 + 3]) for v in vids])
        p_ours = ours.step_block(block).numpy()
        p_ref = np.asarray(ref.step_block(jnp.asarray(block)))
        assert p_ours.shape == (2, 3, 3, H, W)
        for i in range(3):
            p_one = per_frame.step_all([v[0][t0 + i] for v in vids]).numpy()
            np.testing.assert_allclose(p_ours[:, i], p_one, atol=1e-5)
            for vi in range(2):
                compare(p_ref[vi, i], p_ours[vi, i], 5e-3,
                        f"frame {t0 + i} video {vi}")
    same_schedule(ours, ref)
    np.testing.assert_array_equal(ours.sizes, per_frame.sizes)
    assert ours._last_mem_ti() == per_frame._last_mem_ti() == 6


def test_delayed_consolidation_trigger_matches_deva_tpu():
    """tests/test_batched.py::test_delayed_consolidation_trigger: with
    max_mid_term_frames <= min_mid_term_frames + 1 the min-size guard
    delays consolidation one write past max_work, so the stacked rings hold
    min_work + 2*hw tokens; compress fires at 96 tokens and sieves to 48."""
    t = 8
    vids = videos(51, t)
    ours, ref = pair(vids, mem_every=1, top_k=8, enable_long_term=True,
                     max_mid_term_frames=3, min_mid_term_frames=2,
                     num_prototypes=8, topk_method="exact")
    assert ours.key.shape[1] >= 4 * 24
    for ti in range(1, t):
        step_both(ours, ref, [v[0][ti] for v in vids], label=f"frame {ti}")
    same_schedule(ours, ref)
    assert int(ours.sizes[0]) == 48 and ours._lt_engaged


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_batched_matches_sequential_core(method):
    """The port's batched path against its own sequential InferenceCore, one
    core per video, with long-term consolidation and eviction; ring and
    long-term sizes exactly equal."""
    t = 12
    vids = videos(9, t)
    net = nets()[0]
    cfg = InferenceConfig(topk_method=method, **LT_CFG)
    seq, cores = [], []
    for (frames, mask0), objs in zip(vids, OBJECTS):
        core = InferenceCore(net, cfg)
        core.step(frames[0], mask0, objs)
        seq.append([core.step(f).numpy() for f in frames[1:]])
        cores.append(core)
    bp = BatchedPropagator(net, cfg)
    bp.initialize([v[0][0] for v in vids], [v[1] for v in vids], OBJECTS)
    for ti in range(1, t):
        probs = bp.step_all([v[0][ti] for v in vids]).numpy()
        for vi, objs in enumerate(OBJECTS):
            got, want = probs[vi][:len(objs) + 1], seq[vi][ti - 1]
            bad = (np.abs(got - want) > 5e-3).any(axis=0)
            assert bad.mean() <= 0.02, (vi, ti, bad.mean())
            flips = got.argmax(0) != want.argmax(0)
            assert flips.mean() <= 0.02, (vi, ti, flips.mean())
    for vi, core in enumerate(cores):
        assert int(bp.sizes[vi]) == core.memory.buckets[0].size
        assert int(bp.lt_sizes[vi]) == core.memory.long_buckets[0].size > 0
