"""deva_tpu_torch's BatchedDetectionPropagator without long-term memory,
against the port's sequential cores and against deva_tpu's propagator
(tests/torch_batched_detection_common.py says how): the cases of
tests/test_batched_detection.py that step multi-bucket detection videos in
lockstep, an empty lane, the attach/detach round trip and diverged write
cadences."""
import numpy as np
import torch

from deva_tpu_torch.detection_clips import host

from torch_batched_common import pallas_interpret  # noqa: F401
from torch_batched_detection_common import (H, W, bucket_table,
                                            check_frames, run_batched,
                                            run_sequential, side, video)

CFG = dict(mem_every=2, top_k=8, enable_long_term=False,
           max_missed_detection_count=3, topk_method="exact")


def test_batched_detection_equals_sequential():
    """Video 1 grows a third object at the second detection, so it opens a
    new bucket: the batched flow matches the port's sequential flow and
    deva_tpu's batched flow frame by frame, and all three end with the same
    buckets."""
    det_every, t = 3, 8
    rng = np.random.default_rng(21)
    vids = [video(rng, t), video(rng, t, third_at=det_every)]
    seq, seq_cores = run_sequential(side(True, **CFG), vids, det_every)
    got, cores, _ = run_batched(side(True, **CFG), vids, det_every)
    ref, ref_cores, _ = run_batched(side(False, **CFG), vids, det_every)
    check_frames(seq, got, "port sequential")
    check_frames(ref, got, "deva_tpu batched")
    assert any(len(c.memory.buckets) >= 2 for c in cores)
    for a, b, c in zip(seq_cores, cores, ref_cores):
        assert bucket_table(a) == bucket_table(b) == bucket_table(c)


def test_empty_lane_rides_along():
    """A video whose detections are empty until frame 3 rides along as an
    empty lane (pure background), leaves its neighbour untouched, and
    engages at its first detection, matching the sequential flow."""
    det_every, t = 3, 6
    rng = np.random.default_rng(33)
    vid0 = video(rng, t)
    f1, m1, i1 = video(rng, t)
    for ti in range(det_every):
        m1[ti] = np.zeros((H, W), np.int64)
        i1[ti] = []
    vids = [vid0, (f1, m1, i1)]
    seq, seq_cores = run_sequential(side(True, **CFG), vids, det_every)
    got, cores, _ = run_batched(side(True, **CFG), vids, det_every)
    check_frames(seq[:1], got[:1], "engaged lane", tail=0.02)
    for ti in range(det_every):
        assert got[1][ti].shape[0] == 1
        assert (got[1][ti].argmax(0) == 0).all()
    assert cores[1].memory is not None and cores[1].memory.engaged
    check_frames(seq[1:], got[1:], "re-engaged lane", tail=0.02,
                 frames=range(det_every, t))
    assert bucket_table(seq_cores[1]) == bucket_table(cores[1])


def test_batched_detection_state_roundtrip():
    """attach -> detach with no step leaves a two-bucket core's rings,
    sizes, objects, sensory and clocks as they were."""
    s = side(True, **CFG)
    frames, masks, infos = video(np.random.default_rng(22), 4, third_at=2)
    core = s.core()
    core.incorporate_detection(frames[0], masks[0], s.segs(infos[0]))
    core.step(frames[1], None, None)
    core.incorporate_detection(frames[2], masks[2], s.segs(infos[2]))
    assert len(core.memory.buckets) == 2
    before = {bid: (b.key.clone(), b.value.clone(), b.size, b.obj_ids)
              for bid, b in core.memory.buckets.items()}
    sensory, last_mask = core.memory.sensory.clone(), core.last_mask.clone()
    clocks = (core.curr_ti, core.last_mem_ti)
    bp = s.propagator()
    bp.attach([core])
    bp.detach()
    for bid, (key, value, size, ids) in before.items():
        b = core.memory.buckets[bid]
        assert (b.size, b.obj_ids) == (size, ids)
        assert torch.equal(b.key[:size], key[:size])
        assert torch.equal(b.value[:size], value[:size])
    assert torch.equal(core.memory.sensory, sensory)
    assert torch.equal(core.last_mask, last_mask)
    assert (core.curr_ti, core.last_mem_ti) == clocks


def _diverged(s, vids, t, extra_det_ti):
    """Video 0 takes an extra detection at extra_det_ti (resetting its
    cadence) while video 1 plain-steps, both on their own cores between a
    detach and an attach; the other frames step in lockstep. -> (per-video
    probabilities, cores, masked-write launches)."""
    cores = []
    for vi, (frames, masks, infos) in enumerate(vids):
        core = s.core(5 + vi)
        core.incorporate_detection(frames[0], masks[0], s.segs(infos[0]))
        cores.append(core)
    bp = s.propagator()
    bp.attach(cores)
    got = [[None] for _ in vids]
    masked = 0
    for ti in range(1, t):
        if ti == extra_det_ti:
            bp.detach()
            got[0].append(host(cores[0].incorporate_detection(
                vids[0][0][ti], vids[0][1][ti], s.segs(vids[0][2][ti]))))
            got[1].append(host(cores[1].step(vids[1][0][ti], None, None)))
            bp.attach(cores)
            continue
        due = bp.curr_ti + 1 - bp.last_mem_ti >= s.cfg["mem_every"]
        masked += bool(due.any() and not due.all())
        probs = host(bp.step_all([v[0][ti] for v in vids]))
        for vi in range(len(vids)):
            got[vi].append(probs[vi, :cores[vi].object_manager.num_obj + 1])
    bp.detach()
    return got, cores, masked


def test_masked_writes_diverged_cadence():
    """Diverged memory cadences write through masked writes: each video
    writes at its own cadence inside the shared batch, matching its
    sequential flow and deva_tpu's batched flow."""
    cfg = dict(CFG, mem_every=3)
    t, extra = 7, 2
    rng = np.random.default_rng(31)
    vids = [video(rng, t), video(rng, t)]
    seq = []
    for vi in range(2):
        s = side(True, **cfg)
        frames, masks, infos = vids[vi]
        core = s.core(5 + vi)
        probs = []
        for ti in range(t):
            if ti == 0 or (vi == 0 and ti == extra):
                p = core.incorporate_detection(frames[ti], masks[ti],
                                               s.segs(infos[ti]))
            else:
                p = core.step(frames[ti], None, None)
            probs.append(host(p))
        seq.append((probs, core))
    got, cores, masked = _diverged(side(True, **cfg), vids, t, extra)
    ref, ref_cores, _ = _diverged(side(False, **cfg), vids, t, extra)
    assert masked > 0, "no masked write ran"
    for vi in range(2):
        got[vi][0] = ref[vi][0] = seq[vi][0][0]
    check_frames([p for p, _ in seq], got, "port sequential")
    check_frames(ref, got, "deva_tpu batched")
    for (_, sc), bc, rc in zip(seq, cores, ref_cores):
        assert sc.last_mem_ti == bc.last_mem_ti == rc.last_mem_ti
        assert bucket_table(sc) == bucket_table(bc) == bucket_table(rc)
