"""deva_tpu_torch's detection fusion against deva_tpu's, on the CPU:
InferenceCore.spatial_alignment, incorporate_detection in the online
setting, and find_consensus_with_established_association. The semi-online
vote is in tests/test_torch_detection_vote.py, the purge in
tests/test_torch_detection_purge.py.

The oracle is deva_tpu's InferenceCore on the same seeded weights (carried
across by deva_tpu's converter) and the same 64x96 synthetic clip
(tests/torch_detection_common.py). Tolerances, stated per test:
- alignment probabilities within 1e-3 (one encode, attention and decode;
  the two sum f32 in other orders);
- propagation frames within tests/test_detection_parity.py's budget: atol
  3e-3, and at most 0.02% of the pixels beyond it or with another argmax
  (torch_detection_common.compare_prob);
- detection frames: the forward predictions, whose argmax match_and_merge
  paints from, within the budget above, and a pixel beyond atol only where
  their argmaxes differ, on at most 2% of the frame (compare_detection);
- consensus masks, selected ids and object tables equal (the id
  generators are seeded alike).
"""
import numpy as np
import pytest
import torch

from deva_tpu.inference.consensus import \
    find_consensus_with_established_association as jax_established

from deva_tpu_torch.inference.consensus import \
    find_consensus_with_established_association
from deva_tpu_torch.ops.pad import pad_amounts

from torch_detection_common import (H, W, compare_detection,  # noqa: F401
                                    compare_prob, config, cores, models,
                                    object_table, run_online,
                                    synthetic_detections)

torch.set_num_threads(2)


def _padded(img):
    lw, uw, lh, uh = pad_amounts(*img.shape[:2], 16)
    return np.pad(img, ((lh, uh), (lw, uw), (0, 0)))


@pytest.mark.parametrize("method,top_k,ref_top_k", [
    ("exact", 8, 8),
    # 24 tokens, fewer than top_k: the port selects all of them, which is
    # deva_tpu's exact top-k at k = 24 (its lax.top_k raises for k > n)
    ("exact", 30, 24),
    ("approx", 4, 4),
])
def test_spatial_alignment_parity(models, method, top_k, ref_top_k):
    frames, masks, infos = synthetic_detections(np.random.default_rng(1), 3,
                                                appear=0)
    ours, _ = cores(models, config(top_k=top_k, topk_method=method))
    _, ref = cores(models, config(top_k=ref_top_k, topk_method=method))
    src, tar = _padded(frames[0]), _padded(frames[2])
    one_hot = np.stack([masks[0] == d["id"] for d in infos[0]]
                       ).astype(np.float32)  # 4 segments: o_pad 4
    o = ours.spatial_alignment(0, src, one_hot, 2, tar)
    r = np.asarray(ref.spatial_alignment(0, src, one_hot, 2, tar))
    assert o.shape == r.shape == (5, H, W) and o.dtype == np.float32
    np.testing.assert_allclose(o, r, atol=1e-3)
    np.testing.assert_allclose(o.sum(0), 1.0, atol=1e-5)
    # three segments pad to o_pad 3: the selector zeroes no slot
    o3 = ours.spatial_alignment(0, src, one_hot[:3], 2, tar)
    r3 = np.asarray(ref.spatial_alignment(0, src, one_hot[:3], 2, tar))
    np.testing.assert_allclose(o3, r3, atol=1e-3)


def test_online_incorporate_parity(models):
    """Online: incorporate every 3 frames over 7 frames, step otherwise.
    Segment 3 appears at frame 3 (a second memory bucket, so the frames
    after it take the composed path)."""
    frames, masks, infos = synthetic_detections(np.random.default_rng(3), 7)
    ours, ref = cores(models, config())
    o_fw, r_fw = [], []
    o = run_online(ours, frames, masks, infos, every=3, forwards=o_fw)
    r = run_online(ref, frames, masks, infos, every=3, forwards=r_fw)
    for ti, (rp, op) in enumerate(zip(r, o)):
        if ti % 3 == 0:
            compare_detection(rp, op, ti, r_fw[ti], o_fw[ti])
        else:
            compare_prob(rp, op, ti)
    assert object_table(ours) == object_table(ref)
    assert [b.obj_ids for b in ours.memory.buckets.values()] == \
        [b.obj_ids for b in ref.memory.buckets.values()]


def test_established_association_parity(models):
    """find_consensus_with_established_association (the referring and
    saliency drivers' soft consensus): three frames of soft masks of two
    objects, with and without scores; the consensus within 1e-3."""
    frames, masks, _ = synthetic_detections(np.random.default_rng(9), 3)
    soft = [np.stack([(m == 1), (m == 2)]).astype(np.float32) * 0.9
            for m in masks]
    for scores in (None, [0.2, 0.9, 0.5]):
        ours, ref = cores(models, config())
        ko, o = find_consensus_with_established_association(
            [0, 1, 2], frames, soft, ours, scores=scores)
        kr, r = jax_established([0, 1, 2], frames, soft, ref, scores=scores)
        assert ko == kr
        assert o.shape == (2, H, W)
        np.testing.assert_allclose(o, np.asarray(r), atol=1e-3)


def test_spatial_alignment_hands_the_kernels_what_they_take(models,
                                                            monkeypatch):
    """The kernels take contiguous f32 (or bf16) tensors and reject others
    on the card, where the plain twins here take any layout: the tensors
    spatial_alignment passes to sim_topk and topk_readout must be
    contiguous, and each is called once."""
    from deva_tpu_torch.ops import attention_kernels as ak
    calls = []

    def checked(name, fn):
        def run(*args):
            for a in args:
                for t in (a if isinstance(a, tuple) else (a,)):
                    if isinstance(t, torch.Tensor):
                        assert t.is_contiguous(), (name, tuple(t.shape))
            calls.append(name)
            return fn(*args)
        return run

    for name in ("sim_topk", "topk_readout"):
        monkeypatch.setattr(ak, name, checked(name, getattr(ak, name)))
    frames, masks, infos = synthetic_detections(np.random.default_rng(1), 3)
    ours, _ = cores(models, config())
    one_hot = np.stack([masks[0] == d["id"] for d in infos[0]]
                       ).astype(np.float32)
    ours.spatial_alignment(0, _padded(frames[0]), one_hot, 2,
                           _padded(frames[2]))
    assert calls == ["sim_topk", "topk_readout"], calls
