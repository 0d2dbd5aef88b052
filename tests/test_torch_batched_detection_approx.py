"""deva_tpu_torch's BatchedDetectionPropagator with the approx top-k method
(deva_tpu's threshold support, segmax + denom_readout on the card) on
multi-bucket memory: against deva_tpu's propagator with long-term memory,
and against the port's sequential cores without it
(tests/torch_batched_detection_common.py says how)."""
import numpy as np

from torch_batched_common import pallas_interpret  # noqa: F401
from torch_batched_detection_common import (bucket_table, check_frames,
                                            run_batched, run_sequential,
                                            side, video)
from test_torch_batched_detection import CFG
from test_torch_batched_detection_lt import LT_CFG


def test_approx_multibucket_lt_matches_deva_tpu():
    """The approx method on multi-bucket memory with long-term memory,
    through step_block: each (video, slot) pair attends its concatenated
    [long-term ; working] ring with the single-ring approx kernels, as
    deva_tpu's batched body calls attend_pallas_approx (interpret mode).
    The working ring holds up to 16 frames of 24 tokens, so the rings pass
    384 tokens and the group maxima fold groups of 4; consolidation runs
    and a second bucket opens at the second detection."""
    cfg = dict(LT_CFG, topk_method="approx", max_mid_term_frames=16,
               min_mid_term_frames=8, max_long_term_elements=10000)
    det_every, t = 9, 19
    rng = np.random.default_rng(24)
    vids = [video(rng, t), video(rng, t, third_at=det_every)]
    got, cores, bp = run_batched(side(True, **cfg), vids, det_every,
                                 block=True)
    ref, ref_cores, _ = run_batched(side(False, **cfg), vids, det_every,
                                    block=True)
    assert any(len(c.memory.buckets) >= 2 for c in cores)
    assert any(lt.size > 0 for c in cores
               for lt in c.memory.long_buckets.values())
    for b, c in zip(cores, ref_cores):
        assert bucket_table(b) == bucket_table(c)
    check_frames(ref, got, "deva_tpu batched", tail=0.06)


def test_approx_batched_equals_sequential():
    """Without long-term memory the rings hold at most 128 valid tokens
    here, so no group of the approx kernels holds two valid tokens and
    their support is the top-k (ties included), as the sequential cores'
    fused step and composed dense form take it: the batched flow matches
    the port's sequential flow."""
    cfg = dict(CFG, topk_method="approx")
    det_every, t = 3, 8
    rng = np.random.default_rng(21)
    vids = [video(rng, t), video(rng, t, third_at=det_every)]
    seq, seq_cores = run_sequential(side(True, **cfg), vids, det_every)
    got, cores, bp = run_batched(side(True, **cfg), vids, det_every,
                                 block=True)
    assert bp.approx and any(len(c.memory.buckets) >= 2 for c in cores)
    assert max(b.size for c in cores for b in c.memory.buckets.values()) \
        <= 128
    for a, b in zip(seq_cores, cores):
        assert bucket_table(a) == bucket_table(b)
    check_frames(seq, got, "port sequential")
