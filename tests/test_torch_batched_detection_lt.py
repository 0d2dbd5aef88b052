"""deva_tpu_torch's BatchedDetectionPropagator with long-term memory and
block stepping, against the port's sequential cores and deva_tpu's
propagator (tests/torch_batched_detection_common.py says how): lockstep
consolidation, usage counting and eviction over the triggered (video, slot)
pairs (the approx method: test_torch_batched_detection_approx.py), and
step_block against step_all (the cases of tests/test_batched_detection.py)."""
import numpy as np
import torch

from deva_tpu_torch.config import InferenceConfig, ModelConfig
from deva_tpu_torch.inference.batched_detection import \
    BatchedDetectionPropagator
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.models.network import DEVANetwork, init_weights

from torch_batched_common import pallas_interpret  # noqa: F401
from torch_batched_detection_common import (bucket_table, check_frames,
                                            run_batched, run_sequential,
                                            side, video)

# tests/test_batched_detection.py::test_batched_lt_equals_sequential: 24
# tokens a frame, a write every frame, consolidation at 4 writes, eviction
# at the third consolidation (long-term cap 24, 8 prototypes)
LT_CFG = dict(mem_every=1, top_k=8, enable_long_term=True,
              enable_long_term_count_usage=True, max_mid_term_frames=4,
              min_mid_term_frames=2, num_prototypes=8,
              max_long_term_elements=24, max_missed_detection_count=5,
              topk_method="exact")


def test_batched_lt_equals_sequential():
    """Consolidation, usage counting and eviction fire inside the attached
    lockstep stepping: frames, buckets and long-term sizes match the port's
    sequential flow and deva_tpu's batched flow."""
    det_every, t = 4, 12
    rng = np.random.default_rng(23)
    vids = [video(rng, t), video(rng, t, third_at=det_every)]
    seq, seq_cores = run_sequential(side(True, **LT_CFG), vids, det_every)
    got, cores, _ = run_batched(side(True, **LT_CFG), vids, det_every)
    ref, ref_cores, _ = run_batched(side(False, **LT_CFG), vids, det_every)
    assert any(lt.size > 0 for c in cores
               for lt in c.memory.long_buckets.values())
    for a, b, c in zip(seq_cores, cores, ref_cores):
        assert bucket_table(a) == bucket_table(b) == bucket_table(c)
    check_frames(seq, got, "port sequential", tail=0.06)
    check_frames(ref, got, "deva_tpu batched", tail=0.06)


def _cores(s, vids):
    """tests/test_batched_detection.py::test_step_block_equals_step_all's
    cores: a detection at frame 0, one step each, video 0's cadence reset
    as if a detection had come at frame 1."""
    cores = []
    for vi, (frames, masks, infos) in enumerate(vids):
        core = s.core(5 + vi)
        core.incorporate_detection(frames[0], masks[0], s.segs(infos[0]))
        cores.append(core)
    cores[0].step(vids[0][0][1], None, None)
    cores[0].last_mem_ti = 1
    cores[1].step(vids[1][0][1], None, None)
    return cores


def test_step_block_equals_step_all():
    """Blocks (read frames plus one possibly masked write frame) match
    per-frame step_all, with diverged cadences and consolidation."""
    s = side(True, **dict(LT_CFG, mem_every=3, max_long_term_elements=10000))
    t = 10
    rng = np.random.default_rng(41)
    vids = [video(rng, t), video(rng, t, third_at=0)]
    bp_a = s.propagator()
    bp_a.attach(_cores(s, vids))
    probs_a = [bp_a.step_all([v[0][ti] for v in vids]) for ti in range(2, t)]
    bp_a.detach()
    bp_b = s.propagator()
    bp_b.attach(_cores(s, vids))
    probs_b, ks = [], []
    ti = 2
    while ti < t:
        k = bp_b.plan_block(min(s.cfg["mem_every"], t - ti))
        out = bp_b.step_block([np.stack(v[0][ti:ti + k]) for v in vids])
        probs_b += [out[:, i] for i in range(k)]
        ks.append(k)
        ti += k
    bp_b.detach()
    assert max(ks) > 1, ks
    np.testing.assert_array_equal(bp_a.sizes, bp_b.sizes)
    np.testing.assert_array_equal(bp_a.lt_sizes, bp_b.lt_sizes)
    np.testing.assert_array_equal(bp_a.last_mem_ti, bp_b.last_mem_ti)
    assert (bp_a.lt_sizes > 0).any()
    for i, (a, o) in enumerate(zip(probs_a, probs_b)):
        assert a.shape == o.shape
        bad = ((o - a).abs() > 5e-3).any(dim=1).float().mean()
        assert bad <= 0.02, f"frame {i}: {bad:.2%} differ"


def test_step_block_end_freezes_sensory():
    """step_block(end=True) freezes sensory on its last frame, as per-frame
    step_all(end=True) does (tests/test_batched_detection.py's narrow
    model)."""
    net = init_weights(DEVANetwork(ModelConfig(
        pix_feat_dim=64, key_dim=16, value_dim=32)), seed=0).eval()
    cfg = InferenceConfig(mem_every=5, top_k=4, enable_long_term=False,
                          max_missed_detection_count=5, topk_method="exact")
    s = side(True)
    t = 4
    rng = np.random.default_rng(43)
    vids = [video(rng, t), video(rng, t)]

    def make():
        cores = []
        for vi, (frames, masks, infos) in enumerate(vids):
            core = InferenceCore(net, cfg)
            core.enabled_long_id()
            core.object_manager._rng = np.random.default_rng(5 + vi)
            core.incorporate_detection(frames[0], masks[0],
                                       s.segs(infos[0]))
            cores.append(core)
        bp = BatchedDetectionPropagator(net, cfg)
        bp.attach(cores)
        return cores, bp

    cores_a, bp_a = make()
    pa = [bp_a.step_all([v[0][ti] for v in vids], end=ti == t - 1)
          for ti in range(1, t)]
    bp_a.detach()
    cores_b, bp_b = make()
    out = bp_b.step_block([np.stack(v[0][1:]) for v in vids], end=True)
    bp_b.detach()
    for i in range(t - 1):
        torch.testing.assert_close(out[:, i], pa[i], rtol=0, atol=1e-4)
    for ca, cb in zip(cores_a, cores_b):
        torch.testing.assert_close(cb.memory.sensory, ca.memory.sensory,
                                   rtol=0, atol=1e-4)
