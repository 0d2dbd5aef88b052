"""evaluation/eval_with_detections_batched_torch.py:run_group (semi-online
lockstep) in process on the CPU, on tests/test_batched_detection.py's
64x96 clips, where the last vote of the shortest video falls before its
last frame: every frame of every video is saved once, and each video
stays within tests/test_batched_detection.py's budgets of the port's
per-video semi-online machine (run_sequential_tail from frame 0).

deva_tpu's run_group never ends its lockstep early (its break needs a
frame past the pending vote, which the loop never reaches), so there the
frames after the shortest video's last vote stay in the buffer unsaved;
the port ends the lockstep where the schedules diverge, so this case is
held to the port's sequential machine alone.
"""
import os
import sys
import types

import numpy as np
import pytest
import torch

from deva_tpu_torch.detection_clips import host

from torch_batched_common import nets
from torch_batched_detection_common import check_frames, side, video

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "evaluation"))
import eval_with_detections_batched_torch as bdrv  # noqa: E402

CFG = dict(mem_every=2, top_k=8, enable_long_term=False,
           max_missed_detection_count=3)


class Reader:
    """An in-memory clip read as the driver reads a video."""

    def __init__(self, clip, name):
        self.clip, self.vid_name = clip, name

    def __len__(self):
        return len(self.clip[0])

    def __getitem__(self, i):
        frames, masks, infos = self.clip
        return {"rgb": frames[i], "mask": masks[i], "info": {
            "frame": f"{i:05d}.jpg", "shape": masks[i].shape,
            "need_resize": False, "save": True, "segments_info": infos[i]}}


class Keeper:
    """A saver that keeps each frame's output on the host."""

    def __init__(self):
        self.frames, self.order = {}, []

    def save_mask(self, prob, frame, **kwargs):
        self.order.append(int(frame[:5]))
        self.frames[int(frame[:5])] = host(prob)


def states(clips):
    s = side(True, **CFG)
    return [bdrv._VideoState(Reader(clip, f"v{vi}"), s.core(5 + vi),
                             Keeper()) for vi, clip in enumerate(clips)]


@pytest.mark.parametrize("lengths", [(10, 10), (10, 12)])
def test_run_group_saves_every_frame(lengths):
    """A vote every 3 frames over 3: the shortest video votes last at
    frame 8 and steps frame 9 alone; a 12-frame video votes at 11 too."""
    rng = np.random.default_rng(21)
    clips = [video(rng, lengths[0]), video(rng, lengths[1], third_at=3)]
    args = types.SimpleNamespace(detection_every=3, num_voting_frames=3,
                                 save_all=False)
    cfg = side(True, **CFG).config()
    net = nets()[0]
    timer = bdrv.StepTimer(torch.device("cpu"))
    got = states(clips)
    bdrv.run_group(net, cfg, got, args, "vipseg", timer)
    ref = states(clips)
    for vs in ref:
        bdrv.run_sequential_tail(vs, args, "vipseg", 0,
                                 args.num_voting_frames - 1, timer)
    for vs, n in zip(got + ref, lengths + lengths):
        assert sorted(vs.saver.order) == list(range(n)), vs.saver.order
    check_frames([[vs.saver.frames[t] for t in range(n)]
                  for vs, n in zip(ref, lengths)],
                 [[vs.saver.frames[t] for t in range(n)]
                  for vs, n in zip(got, lengths)], "run_group")
