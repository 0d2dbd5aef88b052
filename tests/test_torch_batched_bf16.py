"""deva_tpu_torch's BatchedPropagator in deva_tpu's serving dtypes (bf16
compute, bf16 rings, approx top-k, long-term memory on) against deva_tpu's
bf16 batched path (tests/torch_batched_common.py says how), with
tests/test_amp.py's whole-clip budget per frame and video: mean |dprob| <
0.03, confident-pixel flips (reference margin > 0.25) under 2%, none above
margin 0.6, as tests/test_torch_amp_clip.py holds the single-video path."""
import jax.numpy as jnp
import numpy as np
import torch

from torch_batched_common import (LT_CFG, pair,  # noqa: F401
                                  pallas_interpret, same_schedule, videos)


def test_bf16_matches_deva_tpu_bf16():
    t = 8
    vids = videos(13, t)
    ours, ref = pair(vids, dtype="bfloat16", ring_dtype="bfloat16",
                     topk_method="approx", **LT_CFG)
    assert ours.key.dtype == ours.lt_key.dtype == torch.bfloat16
    assert ours.lt_use.dtype == torch.float32
    for ti in range(1, t):
        frames = [v[0][ti] for v in vids]
        p_ours = ours.step_all(frames).numpy()
        p_ref = np.asarray(ref.step_all([jnp.asarray(f) for f in frames]),
                           np.float32)
        for vi in range(len(vids)):
            po, pr = p_ours[vi], p_ref[vi]
            assert np.abs(po - pr).mean() < 0.03, (ti, vi)
            top2 = np.sort(pr, axis=0)[-2:]
            margin = top2[1] - top2[0]
            flips = po.argmax(0) != pr.argmax(0)
            assert (flips & (margin > 0.25)).mean() < 0.02, (ti, vi)
            assert not (flips & (margin > 0.6)).any(), (ti, vi)
        same_schedule(ours, ref)
    assert ours._lt_engaged
