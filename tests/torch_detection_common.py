"""Shared set-up of the detection-fusion tests
(tests/test_torch_detection*.py): the two packages' models on the same
seeded weights, their cores with equal seeded id generators, the online
and semi-online state machines of evaluation/eval_with_detections.py,
written once for either package's core, and the budgets that hold one
package's frames to the other's.

The clip (deva_tpu_torch/detection_clips.py:small_clip, shared with
chip_smoke.py and tests/test_torch_cuda.py) follows
tests/test_detection_parity.py: 8x-upsampled smooth random frames (24
tokens at stride 16) with VIPSeg-style segments_info.
"""
import numpy as np
import pytest

from deva_tpu.config import InferenceConfig as JaxInferenceConfig
from deva_tpu.config import ModelConfig as JaxModelConfig
from deva_tpu.inference.core import InferenceCore as JaxInferenceCore
from deva_tpu.inference.frame_utils import FrameInfo as JaxFrameInfo
from deva_tpu.inference.object_info import ObjectInfo as JaxObjectInfo
from deva_tpu.models.convert import convert_torch_statedict
from deva_tpu.models.network import DEVANetwork as JaxDEVANetwork

from deva_tpu_torch.config import InferenceConfig
# object_table, perfect_forward and small_clip (as synthetic_detections)
# are the tests' too
from deva_tpu_torch.detection_clips import (  # noqa: F401
    SMALL_H, SMALL_W, aligned_proj, check_detection_frame, host,
    incorporate_seen, object_table, paint_flips, perfect_forward,
    segment_infos)
from deva_tpu_torch.detection_clips import \
    small_clip as synthetic_detections  # noqa: F401
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.inference.frame_utils import FrameInfo
from deva_tpu_torch.inference.object_info import ObjectInfo
from deva_tpu_torch.models.network import DEVANetwork, init_weights

H, W = SMALL_H, SMALL_W


def config(**over):
    """tests/test_detection_parity.py's configuration."""
    cfg = dict(mem_every=2, top_k=8, enable_long_term=False,
               enable_long_term_count_usage=False, max_mid_term_frames=4,
               min_mid_term_frames=2, num_prototypes=16,
               max_long_term_elements=96, max_missed_detection_count=2)
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def models():
    net = init_weights(DEVANetwork(), seed=0).eval()
    variables = convert_torch_statedict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    return net, JaxDEVANetwork(JaxModelConfig()), variables


def cores(models, cfg, id_seed=5):
    """(port core, deva_tpu core) with equal seeded id generators."""
    net, jmodel, variables = models
    ours = InferenceCore(net, InferenceConfig(**cfg))
    ref = JaxInferenceCore(jmodel, variables, JaxInferenceConfig(**cfg))
    for core in (ours, ref):
        core.object_manager._rng = np.random.default_rng(id_seed)
    return ours, ref


def is_port(core) -> bool:
    return isinstance(core, InferenceCore)


def seg_infos(core, dicts):
    """ObjectInfos of the core's package, isthing from the raw flag (as
    tests/test_detection_parity.py:_seg_infos sets it)."""
    return segment_infos(dicts, ObjectInfo if is_port(core)
                         else JaxObjectInfo)


def softmax(logits) -> np.ndarray:
    x = host(logits)
    e = np.exp(x - x.max(0))
    return e / e.sum(0)


def incorporate(core, image, mask, segments, forwards=None,
                perfect=False):
    """core.incorporate_detection -> probabilities (softmax of the logits).
    forwards: a list that gets the forward prediction the core made for
    match_and_merge (its probabilities [1 + n, H, W], unpadded), or None
    where it made none. perfect: pass detection_clips.perfect_forward as
    forward_mask= (the core then makes no forward prediction)."""
    kwargs = {"forward_mask": perfect_forward(core, mask)} if perfect \
        else {}
    logits, forward = incorporate_seen(core, image, mask, segments,
                                       **kwargs)
    if forwards is not None:
        forwards.append(forward)
    return softmax(logits)


def run_online(core, frames, masks, infos, every, forwards=None,
               perfect=False):
    """eval_with_detections.py's online setting: incorporate every `every`
    frames, step otherwise. -> per-frame probabilities (softmax of the
    logits on detection frames); `forwards` and `perfect` as in
    incorporate, one entry of `forwards` per frame (None on a propagation
    frame)."""
    out = []
    for ti, img in enumerate(frames):
        if ti % every == 0:
            out.append(incorporate(core, img, masks[ti],
                                   seg_infos(core, infos[ti]), forwards,
                                   perfect))
        else:
            out.append(host(core.step(img, end=ti == len(frames) - 1)))
            if forwards is not None:
                forwards.append(None)
    return out


def run_semionline(core, frames, masks, infos, num_voting=3, every=3,
                   perfect_alignment=False, forwards=None):
    """eval_with_detections.py's semi-online setting: buffer until the
    voting frame, vote (keyframe 'first'), incorporate the consensus into
    the first buffered frame, step the rest. perfect_alignment: vote with
    detection_clips.aligned_proj instead of the core's spatial_alignment.
    -> ({ti: probabilities}, [(consensus mask, selected ids) per vote]);
    forwards, if given, gets {ti: forward prediction} of the detection
    frames."""
    frame_info = FrameInfo if is_port(core) else JaxFrameInfo
    probs, votes = {}, []
    next_voting = num_voting - 1
    n = len(frames)
    for ti, img in enumerate(frames):
        if ti + num_voting > next_voting:
            info = {"frame": f"{ti:05d}.jpg", "shape": (H, W), "save": True}
            core.add_to_temporary_buffer(frame_info(
                img, masks[ti], seg_infos(core, infos[ti]), ti, info))
            if ti == next_voting:
                _, mask, selected = core.vote_in_temporary_buffer(
                    keyframe_selection="first",
                    precomputed_proj=aligned_proj(core.frame_buffer)
                    if perfect_alignment else None)
                votes.append((np.asarray(mask), [o.id for o in selected]))
                first = core.frame_buffer[0]
                seen = []
                probs[first.ti] = incorporate(core, first.image, mask,
                                              selected, seen)
                if forwards is not None:
                    forwards[first.ti] = seen[0]
                next_voting += every
                if next_voting >= n:
                    next_voting = n + num_voting
                for fi in core.frame_buffer[1:]:
                    probs[fi.ti] = host(core.step(fi.image,
                                                  end=fi.ti == n - 1))
                core.clear_buffer()
        else:
            probs[ti] = host(core.step(img, end=ti == n - 1))
    return probs, votes


def beyond(r, o, atol) -> np.ndarray:
    """[H, W]: pixels where any channel differs beyond atol."""
    return (np.abs(o - r) > atol).any(axis=0)


def compare_prob(r, o, ti, atol=3e-3, pixel_budget=0.0002):
    """tests/test_detection_parity.py:_compare_prob's budget: detection
    frames give hard (0/1) merged masks, so one boundary flip upstream is a
    |diff| = 1 pixel; at most `pixel_budget` of the pixels may differ beyond
    atol, or in their argmax where deva_tpu's top two channels are more
    than atol apart. (With random weights the forward prediction rarely
    matches a detection, so a detected box becomes a second object over
    the first: the two tie to ~1e-5, and an argmax between them is decided
    by f32 summation order.)"""
    assert r.shape == o.shape, (ti, r.shape, o.shape)
    frac = beyond(r, o, atol).mean()
    assert frac <= pixel_budget, \
        f"frame {ti}: {frac:.2%} pixels differ beyond {atol}"
    top2 = np.sort(r, axis=0)[-2:]
    margin = top2[-1] - top2[0]  # 0 with the background alone
    flips = ((o.argmax(0) != r.argmax(0)) & (margin > atol)).mean()
    assert flips <= pixel_budget, f"frame {ti}: {flips:.2%} argmax flips"


# a detection frame's share of pixels that may differ because the two
# forward predictions paint another id there (compare_detection)
MAX_FLIP_SHARE = 0.02


def compare_detection(r, o, ti, forward_r, forward_o, atol=3e-3,
                      max_flip_share=MAX_FLIP_SHARE):
    """A detection frame. match_and_merge paints each pixel from the argmax
    of the core's forward prediction, and with random weights that
    prediction is near flat (its top two channels lie within atol on half
    the frame or more), so the two packages' painted ids may differ where
    their forward predictions, each within compare_prob's budget of the
    other, pick another argmax. Every pixel beyond atol must lie where the
    two forward argmaxes differ, and those pixels may cover at most
    max_flip_share of the frame (on these clips they cover up to 1.06%).
    -> the share they cover."""
    if forward_r is not None or forward_o is not None:
        compare_prob(forward_r, forward_o, f"{ti} (forward)", atol)
    return check_detection_frame(r, o, paint_flips(forward_r, forward_o),
                                 atol, max_flip_share, f"frame {ti}")[1]
