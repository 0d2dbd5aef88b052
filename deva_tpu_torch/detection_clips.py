"""Synthetic clips with detections, the online detection loops over them
(per video, and in lockstep through a BatchedDetectionPropagator), and the
helpers that hold one run of detection fusion against another: written
once for chip_smoke.py's phases 6 and 7, profile_step.py --detections,
tests/test_torch_cuda.py and the tests/test_torch_detection*.py and
tests/test_torch_batched_detection*.py files.

Two clips:
- `small_clip`: 64x96 frames of tests/test_detection_parity.py's kind
  (8x-upsampled smooth random frames, 24 tokens at stride 16) with
  VIPSeg-style segments_info. Segment 1 moves right 2 px a frame, 2 stands
  still, 3 (stuff) appears at `appear`, and 4 is detected only in frames
  [show, vanish), so that after enough detection frames without it
  max_missed_detection_count purges it.
- `detections`: 854x480 detections (scaled for other sizes), 12 segments a
  frame: four stuff bands and eight moving thing boxes, one more thing from
  frame 20 and one gone from frame 25; or fewer segments a frame.

The loops and helpers take this package's InferenceCore and
BatchedDetectionPropagator or any with their interface (`_segment`, `pad`,
`object_manager`, `incorporate_detection`, `step`; `forward_probs`,
`detach`, `attach`, `plan_block`, `step_all`, `step_block`): `host` brings
tensors and array-likes alike to a numpy array.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deva_tpu_torch.inference.object_info import ObjectInfo
from deva_tpu_torch.ops.pad import pad_amounts

SMALL_H, SMALL_W = 64, 96

# detections at 854x480 (scaled for other sizes): four stuff bands (rows,
# VIPSeg category) and nine thing boxes (id, VIPSeg category, slot, first
# frame, frame it is gone from), 80x120 boxes in two rows of five slots
# that move right 1 px a frame; thing 8 appears at frame 20 and thing 7
# vanishes at frame 25, so a frame has 12 segments (13 in frames 20-24)
DET_STUFF = (((0, 100), 21), ((100, 190), 15), ((370, 425), 18),
             ((425, 480), 19))
DET_THINGS = tuple((i, cat, i - 1, 20 if i == 8 else 0,
                    25 if i == 7 else 10 ** 6)
                   for i, cat in enumerate((60, 48, 49, 51, 62, 50, 52, 61,
                                            43), start=1))


def small_clip(rng: np.random.Generator, t: int, appear: int = 3,
               show: int = 0, vanish: int = 2):
    """-> frames [64, 96, 3] f32, detection id masks [64, 96] int64, and
    their segments_info dicts (id, isthing, category_id)."""
    h, w = SMALL_H, SMALL_W
    frames, masks, infos = [], [], []
    base = rng.standard_normal((h // 8, w // 8, 3)).astype(np.float32)
    for i in range(t):
        img = base + 0.1 * rng.standard_normal((h // 8, w // 8, 3))
        frames.append(np.kron(img, np.ones((8, 8, 1))).astype(np.float32))
        m = np.zeros((h, w), np.int64)
        m[8:28, 10 + 2 * i:40 + 2 * i] = 1
        m[36:60, 50:90] = 2
        info = [{"id": 1, "isthing": 1, "category_id": 5},
                {"id": 2, "isthing": 1, "category_id": 7}]
        if i >= appear:
            m[2:18, 60:88] = 3
            info.append({"id": 3, "isthing": 0, "category_id": 20})
        if show <= i < vanish:
            m[40:60, 4:34] = 4
            info.append({"id": 4, "isthing": 1, "category_id": 9})
        masks.append(m)
        infos.append(info)
    return frames, masks, infos


def detections(t: int, h: int = 480, w: int = 854, segments: int = 12):
    """t frames of detections (DET_STUFF, DET_THINGS; ids 1-9 things,
    21-24 stuff) as eval_with_detections_torch.py reads them: id masks
    [h, w] and segments_info dicts. segments=12 (the default) keeps them
    all; fewer keep the first segments // 3 stuff bands and the first
    segments - segments // 3 things (4: one band and things 1-3, in every
    frame)."""
    stuff, things = DET_STUFF, DET_THINGS
    if segments != 12:
        stuff = DET_STUFF[:segments // 3]
        things = DET_THINGS[:segments - segments // 3]
    sy, sx = h / 480, w / 854
    masks, infos = [], []
    for i in range(t):
        m = np.zeros((h, w), np.int64)
        info = []
        for sid, ((r0, r1), cat) in enumerate(stuff, start=21):
            m[int(r0 * sy):int(r1 * sy)] = sid
            info.append({"id": sid, "category_id": cat})
        for tid, cat, slot, first, gone in things:
            if first <= i < gone:
                r0 = int((200 + 85 * (slot // 5)) * sy)
                c0 = int((15 + 165 * (slot % 5) + i) * sx)
                m[r0:r0 + int(80 * sy), c0:c0 + int(120 * sx)] = tid
                info.append({"id": tid, "category_id": cat})
        masks.append(m)
        infos.append(info)
    return masks, infos


def segment_infos(dicts, cls=ObjectInfo) -> List:
    """small_clip's segments_info dicts as ObjectInfos of `cls`, isthing
    from the raw flag (as tests/test_detection_parity.py sets it)."""
    return [cls(id=d["id"], category_id=d["category_id"],
                isthing=bool(d["isthing"])) for d in dicts]


def online_sequential(cores, clips, det_every: int,
                      segs=segment_infos) -> List[List[np.ndarray]]:
    """The online loop of each clip (frames, detection id masks,
    segments_info dicts) on its own core: incorporate_detection every
    det_every frames, step otherwise; segs turns a frame's dicts into the
    core's ObjectInfos. -> per-video per-frame outputs on the host."""
    return [[host(core.incorporate_detection(img, masks[ti],
                                             segs(infos[ti]))
                  if ti % det_every == 0 else core.step(img))
             for ti, img in enumerate(frames)]
            for core, (frames, masks, infos) in zip(cores, clips)]


def online_lockstep(bp, cores, clips, det_every: int, block: bool = False,
                    perfect: bool = False, segs=segment_infos):
    """The online loop of the clips in lockstep on `bp` over `cores`
    (tests/test_batched_detection.py:_run_batched): a detection frame's
    forward predictions in one forward_probs call before detach (perfect:
    perfect_forward per core instead, and no forward call), then
    incorporate_detection per core and attach; the propagation frames
    through step_all, or (block) through step_block by plan_block.
    -> (per-video per-frame outputs on the host, {detection frame:
    per-video forward predictions [1 + n, H, W]} where bp made them)."""
    t = len(clips[0][0])
    out = [[] for _ in clips]
    forwards = {}
    ti = 0
    while ti < t:
        if ti % det_every == 0:
            fwd = None
            if ti > 0:
                if not perfect:
                    fwd = host(bp.forward_probs([c[0][ti] for c in clips]))
                bp.detach()
            for vi, (core, (frames, masks, infos)) in enumerate(
                    zip(cores, clips)):
                fm = None
                if perfect:
                    fm = perfect_forward(core, masks[ti])
                elif fwd is not None:
                    n = core.object_manager.num_obj
                    forwards.setdefault(ti, []).append(fwd[vi][:n + 1])
                    fm = np.argmax(fwd[vi][:n + 1], axis=0)
                out[vi].append(host(core.incorporate_detection(
                    frames[ti], masks[ti], segs(infos[ti]), forward_mask=fm)))
            bp.attach(cores)
            ti += 1
            continue
        span = det_every - ti % det_every
        k = bp.plan_block(min(span, t - ti)) if block else 1
        if block:
            probs = host(bp.step_block([np.stack(c[0][ti:ti + k])
                                        for c in clips]))
        else:
            probs = host(bp.step_all([c[0][ti] for c in clips]))[:, None]
        for i in range(k):
            for vi, core in enumerate(cores):
                out[vi].append(probs[vi, i, :core.object_manager.num_obj + 1])
        ti += k
    bp.detach()
    return out, forwards


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def object_table(core):
    """(id, tmp id, poke_count, isthing, voted category) per object, in the
    object manager's order."""
    return [(o.id, t, o.poke_count, o.isthing, o.vote_category_id())
            for o, t in core.object_manager.obj_to_tmp_id.items()]


def incorporate_seen(core, image, mask, segments, **kwargs):
    """core.incorporate_detection -> (its logits, the forward prediction it
    made for match_and_merge: probabilities [1 + n, H, W] on the host,
    unpadded, or None where it made none)."""
    seen = []
    segment = core._segment

    def spy(*args, **kw):
        seen.append(segment(*args, **kw))
        return seen[-1]

    n = core.object_manager.num_obj
    core._segment = spy
    try:
        logits = core.incorporate_detection(image, mask, segments, **kwargs)
    finally:
        del core._segment  # the class's method again
    if not seen:
        return logits, None
    lw, uw, lh, uh = core.pad
    forward = host(seen[0])[:n + 1]
    h, w = forward.shape[-2:]
    return logits, forward[:, lh:h - uh, lw:w - uw]


def paint_flips(forward_a, forward_b) -> Optional[np.ndarray]:
    """Pixels [H, W] where two forward predictions [1 + n, H, W] (or two
    projections) have another argmax: match_and_merge and the consensus
    vote paint each pixel's id from the argmax, so only there may two runs
    paint different ids. None where neither run made a prediction."""
    if forward_a is None and forward_b is None:
        return None
    forward_a, forward_b = host(forward_a), host(forward_b)
    assert forward_a.shape == forward_b.shape, \
        (forward_a.shape, forward_b.shape)
    return forward_a.argmax(0) != forward_b.argmax(0)


def check_detection_frame(ref, out, allowed, atol: float,
                          max_share: float, label: str):
    """A detection frame's probabilities `out` against `ref` [1 + n, H, W]:
    every pixel beyond atol must lie in `allowed` (bool [H, W], or None for
    none: the pixels where the two runs painted their masks from other
    argmaxes, paint_flips), and `allowed` may cover at most max_share of the
    frame. -> (pixels beyond atol, share of the frame allowed)."""
    ref, out = host(ref), host(out)
    assert ref.shape == out.shape, (label, ref.shape, out.shape)
    bad = (np.abs(out - ref) > atol).any(axis=0)
    if allowed is None:
        allowed = np.zeros(bad.shape, bool)
    share = float(allowed.mean())
    assert share <= max_share, (
        f"{label}: the painted ids may differ on {share:.2%} of the frame, "
        f"over the {max_share:.2%} allowed")
    assert not (bad & ~allowed).any(), (
        f"{label}: {int((bad & ~allowed).sum())} pixels differ beyond {atol} "
        "where both runs painted the same ids")
    return int(bad.sum()), share


def aligned_proj(frames):
    """A perfect spatial alignment for vote_in_temporary_buffer's
    precomputed_proj: each buffered frame after the keyframe projects onto
    itself ({frame index: channel-index map, padded domain}). Random weights
    align noise, so no segment finds support and the vote selects nothing;
    with this the vote's IoU table, integer program and merge get real
    work."""
    out = {}
    for i, f in enumerate(frames[1:], 1):
        lw, uw, lh, uh = pad_amounts(*f.mask.shape, 16)
        m = np.pad(np.asarray(f.mask), ((lh, uh), (lw, uw)))
        proj = np.zeros(m.shape, np.int64)
        for channel, seg in enumerate(f.segments_info):
            proj[m == seg.id] = channel + 1
        out[i] = proj
    return out


def perfect_forward(core, mask) -> np.ndarray:
    """A perfect forward prediction for incorporate_detection(forward_mask=):
    the detection mask in the core's tmp ids, where the detection's segment
    ids are the object ids (small_clip's are: no collision redraws them).
    Every detected segment then matches its object, and match_and_merge's
    result depends on no device output."""
    out = np.zeros(np.shape(mask), np.int64)
    for obj, tmp in core.object_manager.obj_to_tmp_id.items():
        out[np.asarray(mask) == obj.id] = tmp
    return out
