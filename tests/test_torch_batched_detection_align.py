"""deva_tpu_torch's BatchedDetectionPropagator: align_consensus_batched and
forward_ids against the port's per-video path and deva_tpu's propagator
(tests/torch_batched_detection_common.py says how), and the launch design:
one call of each kernel wrapper of the method per lockstep frame for all
B*S (video, slot) pairs, with the queries repeated per pair into contiguous
operands."""
import numpy as np
import pytest

from deva_tpu.inference.frame_utils import FrameInfo as JaxFrameInfo

from deva_tpu_torch.detection_clips import host
from deva_tpu_torch.inference.frame_utils import FrameInfo
from deva_tpu_torch.ops import approx_kernels as apx
from deva_tpu_torch.ops import attention_kernels as ak

from torch_batched_common import pallas_interpret  # noqa: F401
from torch_batched_detection_common import side, video
from test_torch_batched_detection import CFG
from test_torch_batched_detection_lt import LT_CFG


def _buffered(s, vids, n):
    """One core per video with the first n frames in its buffer."""
    cores = []
    frame_info = FrameInfo if s.port else JaxFrameInfo
    for vi, (frames, masks, infos) in enumerate(vids):
        core = s.core(5 + vi)
        for ti in range(n):
            core.add_to_temporary_buffer(frame_info(
                frames[ti], masks[ti], s.segs(infos[ti]), ti,
                {"frame": f"{ti:05d}.jpg", "shape": masks[ti].shape,
                 "save": True}))
        cores.append(core)
    return cores


def test_batched_consensus_alignment_matches_per_video():
    """tests/test_batched_detection.py's case: video 1 has three segments
    and video 0 two, so the items share a padded object axis. The batched
    alignments feed the same votes as the per-video alignments (consensus
    masks within 1% of the pixels, the same categories selected), and their
    id maps are deva_tpu's within 1% of each item's pixels. Also
    forward_ids is np.argmax of forward_probs over the live channels (on
    at least 99% of the pixels; the two calls update sensory in turn)."""
    cfg = dict(CFG, num_voting_frames=3)
    rng = np.random.default_rng(7)
    vids = [video(rng, 3), video(rng, 3, third_at=0)]
    ours, theirs = side(True, **cfg), side(False, **cfg)
    cores = _buffered(ours, vids, 3)
    projs = ours.propagator().align_consensus_batched(
        cores, keyframe_selection="first")
    ref = side(False, **cfg).propagator().align_consensus_batched(
        _buffered(theirs, vids, 3), keyframe_selection="first")
    assert sorted(projs[0]) == sorted(ref[0]) == [1, 2]
    for vi in range(2):
        for i, ids in projs[vi].items():
            assert ids.shape == ref[vi][i].shape
            frac = (ids != ref[vi][i]).mean()
            assert frac < 0.01, f"video {vi} frame {i}: {frac:.2%} differ"
    for vi, c in enumerate(cores):
        ti_b, mask_b, info_b = c.vote_in_temporary_buffer(
            keyframe_selection="first", precomputed_proj=projs[vi])
        ti_r, mask_r, info_r = c.vote_in_temporary_buffer(
            keyframe_selection="first")
        assert ti_b == ti_r
        assert (mask_b != mask_r).mean() < 0.01
        assert [o.category_ids for o in info_b] == \
            [o.category_ids for o in info_r]

    for c, (frames, masks, infos) in zip(cores, vids):
        c.incorporate_detection(frames[0], masks[0], ours.segs(infos[0]))
        c.clear_buffer()
    bp = ours.propagator()
    bp.attach(cores)
    imgs = [v[0][1] for v in vids]
    sensory = bp.sensory.clone()
    fwd = bp.forward_probs(imgs)
    bp.sensory = sensory
    ids = bp.forward_ids(imgs)
    assert ids.dtype == np.uint8 and ids.shape == (2,) + vids[0][1][0].shape
    for vi, c in enumerate(cores):
        n = c.object_manager.num_obj
        assert (ids[vi] != np.argmax(fwd[vi][:n + 1], axis=0)).mean() < 0.01
    bp.detach()


def _spy(monkeypatch, module, names):
    """Replace module.<name> by a wrapper that records each call's
    positional arguments: {name: [args, ...]}."""
    calls = {name: [] for name in names}
    for name in names:
        fn = getattr(module, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name].append(args)
            return _fn(*args, **kw)
        monkeypatch.setattr(module, name, spy)
    return calls


def _multibucket(method):
    """Two videos with multi-bucket, long-term memory state (video 1 opens
    a third object's bucket at frame 2) and their propagator, attached."""
    s = side(True, **dict(LT_CFG, topk_method=method,
                          max_long_term_elements=10000))
    rng = np.random.default_rng(51)
    vids = [video(rng, 7, third_at=2), video(rng, 7)]
    cores = []
    for vi, (frames, masks, infos) in enumerate(vids):
        core = s.core(5 + vi)
        for ti in (0, 2):
            core.incorporate_detection(frames[ti], masks[ti],
                                       s.segs(infos[ti]))
        cores.append(core)
    bp = s.propagator()
    bp.attach(cores)
    return vids, bp


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_one_launch_per_lockstep_frame(monkeypatch, method):
    """Every lockstep frame (step_all, each frame of step_block, the forward
    prediction) calls each kernel wrapper of the method once, for all B*S
    (video, slot) pairs: on the card, one launch of each kernel per frame.
    With the exact method the value rings go to topk_readout as two
    segments ([long-term ; working]), read in place."""
    vids, bp = _multibucket(method)
    b, s = bp.key.shape[:2]
    assert b == 2 and s >= 2
    names = ("sim_topk", "topk_readout") if method == "exact" else \
        ("segmax", "denom_readout")
    calls = _spy(monkeypatch, ak if method == "exact" else apx, names)
    frames = 0
    bp.step_all([v[0][3] for v in vids])
    frames += 1
    k = bp.plan_block(3)
    bp.step_block([np.stack(v[0][4:4 + k]) for v in vids])
    frames += k
    bp.forward_ids([v[0][4 + k] for v in vids])
    frames += 1
    for name in names:
        assert len(calls[name]) == frames, (name, len(calls[name]), frames)
    if method == "exact":
        for args in calls["sim_topk"]:
            assert args[0].shape[0] == b * s  # qk [B*S, Q, Ck]
        for args in calls["topk_readout"]:
            lt_value, value = args[2]
            assert lt_value.shape[0] == value.shape[0] == b * s
    else:
        for args in calls["segmax"]:
            assert args[0].qcat.shape[0] == b * s
    bp.detach()


def test_qk_repeat_is_contiguous(monkeypatch):
    """The pairs' queries reach sim_topk materialised: [B*S, Q, Ck]
    contiguous, no stride-0 expanded view (the kernels' wrappers reject
    those), each pair's rows its video's queries."""
    vids, bp = _multibucket("exact")
    s = bp.key.shape[1]
    calls = _spy(monkeypatch, ak, ("sim_topk",))
    bp.step_all([v[0][3] for v in vids])
    qk, qe = calls["sim_topk"][0][:2]
    for t in (qk, qe):
        assert t.is_contiguous() and t.stride(0) == t.shape[1] * t.shape[2]
        for v in range(len(vids)):
            for j in range(1, s):
                assert host(t[v * s + j] == t[v * s]).all()
    assert not host(qk[0] == qk[s]).all()
    bp.detach()
