"""deva_tpu_torch's semi-online detection fusion against deva_tpu's, on the
CPU: the in-clip vote (spatial alignment onto the keyframe, the IoU table,
the integer program), incorporate_detection of the consensus, and the
buffered frames after it.

Set-up and budgets as tests/test_torch_detection.py (shared in
tests/torch_detection_common.py): consensus masks and selected ids equal,
detection frames by compare_detection, the other frames by compare_prob
(atol 3e-3 on at most 0.02% of the pixels), object tables equal.
"""
import numpy as np
import pytest
import torch

from torch_detection_common import (  # noqa: F401
    compare_detection, compare_prob, config, cores, models, object_table,
    run_semionline, synthetic_detections)

torch.set_num_threads(2)


@pytest.mark.parametrize("perfect_alignment", [False, True])
def test_semionline_consensus_parity(models, perfect_alignment):
    """Semi-online: 3 voting frames, a vote every 3 frames over 8 frames:
    equal consensus masks and selected ids on every vote, frames within
    the budgets. Through the cores' spatial_alignment the random weights
    give most segments too little support (at 480p the vote selects
    nothing, tests/test_vipseg_pipeline_golden.py:19-29); with a perfect
    alignment (precomputed_proj) both votes select segments, and the
    integer program, the merge and the frames after it are held too.
    Both packages solve the program with their native library (the port's
    a copy of deva_tpu's), so tied optima come out alike."""
    frames, masks, infos = synthetic_detections(np.random.default_rng(4), 8)
    ours, ref = cores(models, config())
    o_fw, r_fw = {}, {}
    o_probs, o_votes = run_semionline(ours, frames, masks, infos,
                                      perfect_alignment=perfect_alignment,
                                      forwards=o_fw)
    r_probs, r_votes = run_semionline(ref, frames, masks, infos,
                                      perfect_alignment=perfect_alignment,
                                      forwards=r_fw)
    assert len(o_votes) == len(r_votes) == 2
    for (om, oi), (rm, ri) in zip(o_votes, r_votes):
        np.testing.assert_array_equal(om, rm)
        assert oi == ri, (oi, ri)
        assert oi or not perfect_alignment, oi
    assert sorted(o_probs) == sorted(r_probs) == list(range(8))
    for ti in r_probs:
        if ti in r_fw:
            compare_detection(r_probs[ti], o_probs[ti], ti, r_fw[ti],
                              o_fw[ti])
        else:
            compare_prob(r_probs[ti], o_probs[ti], ti)
    assert object_table(ours) == object_table(ref)
    assert not ours.frame_buffer and len(ours.image_feature_store) == 0
