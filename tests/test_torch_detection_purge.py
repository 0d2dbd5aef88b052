"""deva_tpu_torch's purge of objects missed too often against deva_tpu's,
on the CPU: the object table, the memory buckets and the sensory rows after
incorporate_detection purges, and the fused step taken again once one
bucket holds every object.

Set-up and budgets as tests/test_torch_detection.py (shared in
tests/torch_detection_common.py): detection frames by compare_detection,
the other frames by compare_prob (atol 3e-3 on at most 0.02% of the
pixels), object tables equal; sensory rows within 2e-3. With a perfect
forward prediction (forward_mask=) the detection frames are held by
compare_prob as well: no pixel may differ because a forward argmax did.
"""
import numpy as np
import torch

from torch_detection_common import (  # noqa: F401
    compare_detection, compare_prob, config, cores, host, incorporate,
    models, object_table, perfect_forward, run_online, seg_infos, softmax,
    synthetic_detections)

torch.set_num_threads(2)


def test_purge_parity(models):
    """Segment 4 is detected in frames 0-1 only: with a detection every
    other frame and max_missed_detection_count 2 it is poked at 2, 4 and 6
    and purged at 6. Equal object tables and bucket objects after every
    detection frame; the kept sensory rows within 2e-3 of deva_tpu's, the
    purged rows zero."""
    frames, masks, infos = synthetic_detections(np.random.default_rng(6), 8)
    ours, ref = cores(models, config())
    o_tables, r_tables = [], []
    for ti, img in enumerate(frames):
        if ti % 2:
            compare_prob(host(ref.step(img)), host(ours.step(img)), ti)
            continue
        r_fw, o_fw = [], []
        r = incorporate(ref, img, masks[ti], seg_infos(ref, infos[ti]),
                        r_fw)
        o = incorporate(ours, img, masks[ti], seg_infos(ours, infos[ti]),
                        o_fw)
        compare_detection(r, o, ti, r_fw[0], o_fw[0])
        for core, tables in ((ours, o_tables), (ref, r_tables)):
            tables.append((object_table(core), [
                b.obj_ids for b in core.memory.buckets.values()]))
    assert o_tables == r_tables
    ids = [row[0] for row in o_tables[-1][0]]
    assert 4 not in ids and 4 in [row[0] for row in o_tables[-2][0]]
    n = ours.object_manager.num_obj
    o_sens = host(ours.memory.sensory)                  # [O_cap, Cs, h, w]
    r_sens = np.moveaxis(host(ref.memory.sensory), -1, 1)  # from NHWC
    np.testing.assert_allclose(o_sens[:n], r_sens[:n], atol=2e-3)
    assert not o_sens[n:].any() and not r_sens[n:].any()


def test_purge_parity_perfect_forward(models):
    """test_purge_parity's clip and schedule with a perfect forward
    prediction (detection_clips.perfect_forward as forward_mask=): every
    detected segment matches its object and nothing on the host depends on
    a device output, so every frame, detection frames included, is held by
    compare_prob with no allowance for a flipped forward argmax. Segment 4
    is purged at frame 6 as before; equal object tables and buckets, every
    sensory row within 2e-3 of deva_tpu's."""
    frames, masks, infos = synthetic_detections(np.random.default_rng(6), 8)
    ours, ref = cores(models, config())
    o = run_online(ours, frames, masks, infos, every=2, perfect=True)
    r = run_online(ref, frames, masks, infos, every=2, perfect=True)
    for ti, (rp, op) in enumerate(zip(r, o)):
        compare_prob(rp, op, ti)
    assert object_table(ours) == object_table(ref)
    assert sorted(row[0] for row in object_table(ours)) == [1, 2, 3]
    assert [b.obj_ids for b in ours.memory.buckets.values()] == \
        [b.obj_ids for b in ref.memory.buckets.values()]
    o_sens = host(ours.memory.sensory)                  # [O_cap, Cs, h, w]
    r_sens = np.moveaxis(host(ref.memory.sensory), -1, 1)  # from NHWC
    np.testing.assert_allclose(o_sens, r_sens, atol=2e-3)


def test_fused_step_after_purge(models):
    """incorporate_detection with forward_mask= (in unpadded space: the
    frames are cut to 56x88, padded to 64x96 inside), a perfect forward
    prediction, so every detected segment matches its object. Five
    segments open the clip (one bucket of 8 object slots), segment 4
    first appears at frame 2, alone in a second bucket (6 objects: the
    core keeps 8 slots), is poked at 4, 6 and 8 and purged at 8: its bucket
    goes, and the one left holds every object in order in as many slots as
    the core, so frame 9 takes the fused step again. Frames within
    compare_prob's budget of deva_tpu, equal object tables."""
    frames, masks, infos = synthetic_detections(
        np.random.default_rng(8), 11, appear=99, show=2, vanish=3)
    for m, info in zip(masks, infos):
        for sid, rows, cols in ((5, (2, 18), (64, 76)),
                                (6, (2, 18), (80, 94)),
                                (7, (20, 34), (66, 92))):
            m[slice(*rows), slice(*cols)] = sid
            info.append({"id": sid, "isthing": 1, "category_id": 11})
    frames = [f[4:60, 4:92] for f in frames]
    masks = [m[4:60, 4:92] for m in masks]
    ours, ref = cores(models, config())
    calls = []
    fused = ours._fused

    def spy(*args, **kwargs):
        calls.append(ours.curr_ti)
        return fused(*args, **kwargs)

    ours._fused = spy
    for ti, img in enumerate(frames):
        if ti % 2:
            r, o = ref.step(img), ours.step(img)
        else:
            r, o = (core.incorporate_detection(
                img, masks[ti], seg_infos(core, infos[ti]),
                forward_mask=perfect_forward(core, masks[ti]))
                for core in (ref, ours))
            r, o = softmax(r), softmax(o)
        assert host(o).shape == (ours.object_manager.num_obj + 1, 56, 88)
        compare_prob(host(r), host(o), ti)
        if ti == 2:
            assert [len(b.obj_ids) for b in ours.memory.buckets.values()] \
                == [5, 1] and ours.o_cap == 8
    assert [b.obj_ids for b in ours.memory.buckets.values()] == \
        [ours.object_manager.all_obj_ids]
    assert object_table(ours) == object_table(ref)
    assert sorted(o[0] for o in object_table(ours)) == [1, 2, 5, 6, 7]
    # propagation frames: 1 fused, 3-7 (two buckets) composed, 9 fused
    assert calls == [1, 9], calls
