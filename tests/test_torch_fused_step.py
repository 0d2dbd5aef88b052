"""deva_tpu_torch's fused step and block stepping (inference/fused_step.py,
InferenceCore.step / step_chunk), on the CPU.

1. tests/test_step_chunk.py ported: step_chunk equals per-frame step, with
   and without long-term memory, with and without the pre-encoded block
   body, at that file's budgets.
2. The approx slice against deva_tpu: InferenceConfig(topk_method='approx',
   use_pallas_attention=True) on both sides, so deva_tpu's FusedStepper runs
   attend_pallas_approx{,_multi} (patched here, in the test only, to
   interpret mode) and the port runs attend_approx{,_multi}'s plain twins.
   The 128x192 frames and the ring depth make the concatenated
   [long-term ; working] ring exceed 512 tokens, so groups of 4 occur.
   Probabilities within 5e-3 (f32 sums in another order, amplified by the
   random-init recurrence, as in tests/test_torch_inference.py).
3. A port-only drift check of approx against exact on the golden clip, with
   the budgets of tests/test_topk_drift.py.
Weights: a seeded port model, carried to deva_tpu by its own converter.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deva_tpu.config import InferenceConfig as JaxInferenceConfig
from deva_tpu.config import ModelConfig as JaxModelConfig
from deva_tpu.inference.core import InferenceCore as JaxInferenceCore
from deva_tpu.models.convert import convert_torch_statedict
from deva_tpu.models.network import DEVANetwork as JaxDEVANetwork
from deva_tpu.ops import pallas_attention as pa

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference import memory as tmem
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.models.network import DEVANetwork, init_weights
from deva_tpu_torch.ops import approx_kernels as apx
from deva_tpu_torch.ops import attention_kernels as ak
from deva_tpu_torch.ops import memory_attention as ma
from deva_tpu_torch.ops.pad import pad_divide_by

torch.set_num_threads(2)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures")


@pytest.fixture(scope="module")
def net():
    return init_weights(DEVANetwork(), seed=0).eval()


def _video(rng, t, h=64, w=96):
    """Smooth random frames and a two-object first mask
    (tests/test_step_chunk.py:_video, at any size)."""
    base = rng.standard_normal((h // 8, w // 8, 3)).astype(np.float32)
    frames = [np.kron(base + 0.1 * rng.standard_normal(base.shape),
                      np.ones((8, 8, 1))).astype(np.float32)
              for _ in range(t)]
    mask0 = np.zeros((h, w), np.int64)
    mask0[h // 8:h * 7 // 16, w // 10:w * 5 // 12] = 1
    mask0[h * 9 // 16:h * 15 // 16, w * 25 // 48:w * 15 // 16] = 2
    return frames, mask0


@pytest.mark.parametrize("preencode", [False, True])
@pytest.mark.parametrize("long_term", [False, True])
def test_chunk_equals_per_frame(net, long_term, preencode):
    """tests/test_step_chunk.py on the port. Without pre-encoding the block
    body runs step()'s own operations, so every frame must match to 1e-4;
    the pre-encoded body batches the convolutions, whose float noise the
    random-init shrinkage amplifies, so it gets that file's pixel budget."""
    cfg = InferenceConfig(mem_every=2, top_k=8, enable_long_term=long_term,
                          enable_long_term_count_usage=long_term,
                          max_mid_term_frames=4, min_mid_term_frames=2,
                          num_prototypes=16, max_long_term_elements=96,
                          preencode_blocks=preencode)
    frames, mask0 = _video(np.random.default_rng(5), 11)

    core_a = InferenceCore(net, cfg)
    probs_a = [core_a.step(frames[0], mask0, [1, 2]).numpy()]
    for i, f in enumerate(frames[1:], start=1):
        probs_a.append(core_a.step(f, end=(i == len(frames) - 1)).numpy())

    core_b = InferenceCore(net, cfg)
    probs_b = [core_b.step(frames[0], mask0, [1, 2]).numpy()]
    probs_b += [p.numpy() for p in core_b.step_chunk(frames[1:], end=True)]

    assert len(probs_a) == len(probs_b)
    for ti, (a, b) in enumerate(zip(probs_a, probs_b)):
        assert a.shape == b.shape == (3, 64, 96)
        if not preencode:
            np.testing.assert_allclose(b, a, atol=1e-4, err_msg=f"frame {ti}")
        else:
            bad = (np.abs(b - a) > 5e-3).any(axis=0)
            assert bad.mean() <= 0.02, \
                f"frame {ti}: {bad.mean():.2%} pixels differ"
            diff = a.argmax(0) != b.argmax(0)
            assert diff.mean() <= 0.02, \
                f"frame {ti}: {diff.mean():.2%} argmax mismatch"

    assert core_a.curr_ti == core_b.curr_ti
    assert core_a.last_mem_ti == core_b.last_mem_ti
    (_, ba), = core_a.memory.buckets.items()
    (_, bb), = core_b.memory.buckets.items()
    assert ba.size == bb.size
    key_tol = 5e-3 if preencode else 5e-4
    np.testing.assert_allclose(bb.key[:bb.size].numpy(),
                               ba.key[:ba.size].numpy(), atol=key_tol)
    if long_term:
        np.testing.assert_allclose(bb.use_cnt.numpy(), ba.use_cnt.numpy(),
                                   rtol=5e-2, atol=5e-2)
        lta, ltb = core_a.memory.long_buckets, core_b.memory.long_buckets
        assert set(lta) == set(ltb) and lta
        for k in lta:
            assert lta[k].size == ltb[k].size
            np.testing.assert_allclose(ltb[k].key[:ltb[k].size].numpy(),
                                       lta[k].key[:lta[k].size].numpy(),
                                       atol=5e-3)


def test_step_takes_the_fused_path_only_when_eligible(net, monkeypatch):
    """Plain propagation frames take the fused step (the composed
    match_memory is never called); a second memory bucket (an object that
    appears mid-stream) sends step() back to the composed path."""
    composed = []
    real = tmem.MemoryEngine.match_memory
    monkeypatch.setattr(tmem.MemoryEngine, "match_memory",
                        lambda self, *a: composed.append(1) or
                        real(self, *a))
    frames, mask0 = _video(np.random.default_rng(6), 6)
    core = InferenceCore(net, InferenceConfig(mem_every=2, top_k=8))
    core.step(frames[0], mask0, [1, 2])
    for f in frames[1:3]:
        core.step(f)
    assert composed == []
    mask_mid = np.zeros((64, 96), np.int64)
    mask_mid[4:20, 60:88] = 3
    core.step(frames[3], mask_mid, [3])
    assert len(core.memory.buckets) == 2
    core.step(frames[4])
    assert len(composed) == 2  # the mask frame's forward and the next frame


@pytest.fixture
def pallas_interpret(monkeypatch):
    """deva_tpu's FusedStepper imports the Pallas composites at call time;
    point them at interpret mode (this test only, deva_tpu untouched)."""
    for name in ("attend_pallas_approx_multi", "attend_pallas_approx"):
        monkeypatch.setattr(pa, name, functools.partial(getattr(pa, name),
                                                        interpret=True))


def _compare(ref_probs, our_probs, atol):
    for ti, (r, o) in enumerate(zip(ref_probs, our_probs)):
        assert r.shape == o.shape, (ti, r.shape, o.shape)
        np.testing.assert_allclose(o, r, atol=atol, err_msg=f"frame {ti}")
        diff = o.argmax(0) != r.argmax(0)
        top2 = np.sort(r, axis=0)[-2:]
        assert not (diff & (top2[1] - top2[0] > 5 * atol)).any(), \
            f"argmax frame {ti}: confident mismatch"


def test_approx_slice_matches_deva_tpu(net, pallas_interpret, monkeypatch):
    h, w = 128, 192  # 96 tokens a frame
    cfg = dict(mem_every=1, top_k=30, enable_long_term=True,
               enable_long_term_count_usage=True, max_mid_term_frames=7,
               min_mid_term_frames=2, num_prototypes=16,
               max_long_term_elements=96, topk_method="approx",
               use_pallas_attention=True)
    frames, mask0 = _video(np.random.default_rng(21), 10, h, w)
    variables = convert_torch_statedict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    ref = JaxInferenceCore(JaxDEVANetwork(JaxModelConfig()), variables,
                           JaxInferenceConfig(**cfg))
    ref_probs = [np.asarray(ref.step(jnp.asarray(f), *((mask0, [1, 2])
                                                       if ti == 0 else ())))
                 for ti, f in enumerate(frames)]

    groups = []
    real_segmax = apx.segmax
    monkeypatch.setattr(apx, "segmax", lambda ops, geom: groups.append(
        (geom.n, geom.group)) or real_segmax(ops, geom))
    ours = InferenceCore(net, InferenceConfig(**cfg))
    our_probs = [ours.step(frames[0], mask0, [1, 2]).numpy()]
    our_probs += [ours.step(f).numpy() for f in frames[1:]]
    _compare(ref_probs, our_probs, atol=5e-3)

    lt = ours.memory.long_buckets[0]
    work = ours.memory.buckets[0]
    assert lt.size > 0 and lt.size == ref.memory.long_buckets[0].size
    assert work.size == ref.memory.buckets[0].size
    assert len(groups) == len(frames) - 1  # every propagated frame
    assert (lt.cap + work.cap, 4) in groups, groups  # [lt ; work], groups 4

    # step_chunk runs step()'s operations: the same probabilities
    chunked = InferenceCore(net, InferenceConfig(**cfg))
    probs_c = [chunked.step(frames[0], mask0, [1, 2]).numpy()]
    probs_c += [p.numpy() for p in chunked.step_chunk(frames[1:])]
    for ti, (a, c) in enumerate(zip(our_probs, probs_c)):
        np.testing.assert_allclose(c, a, atol=1e-5, err_msg=f"frame {ti}")
    assert chunked.memory.long_buckets[0].size == lt.size


def _golden_clip():
    fx = np.load(os.path.join(FIXDIR, "golden_vos.npz"))
    return fx["inputs"].astype(np.float32), fx["mask0"].astype(np.int64)


def _run_clip(net, inputs, mask0, method):
    """tests/test_topk_drift.py:_run_clip on the port."""
    core = InferenceCore(net, InferenceConfig(
        mem_every=1, top_k=30, enable_long_term=False, topk_method=method))
    probs = [core.step(inputs[ti], *((mask0, [1, 2]) if ti == 0 else ()))
             .numpy() for ti in range(inputs.shape[0])]
    return core, probs


def test_approx_drift_against_exact(net):
    """tests/test_topk_drift.py's budgets on the port: end to end, the 99.9th
    percentile of |approx - exact| <= 2e-3, the max <= 2e-2 and no argmax
    flip where exact's margin is above 0.05; at ring level, on the rings the
    clip built, readout drift <= 2e-3 (dense threshold form) and 5e-3
    (group-max threshold) of the readout's scale, usage conserved."""
    inputs, mask0 = _golden_clip()
    core, probs_exact = _run_clip(net, inputs, mask0, "exact")
    _, probs_approx = _run_clip(net, inputs, mask0, "approx")
    for ti, (pe, pa_) in enumerate(zip(probs_exact, probs_approx)):
        diff = np.abs(pa_ - pe)
        assert np.quantile(diff, 0.999) <= 2e-3, (ti, np.quantile(diff,
                                                                  0.999))
        assert diff.max() <= 2e-2, (ti, diff.max())
        srt = np.sort(pe, axis=0)
        flips = pa_.argmax(0) != pe.argmax(0)
        assert not (flips & (srt[-1] - srt[-2] > 0.05)).any(), ti

    (_, b), = core.memory.buckets.items()
    img, _ = pad_divide_by(torch.from_numpy(inputs[-1]).permute(2, 0, 1),
                           16, -2, -1)
    with torch.no_grad():
        _, feat = net.encode_image(img[None])
        key, _, sel = net.transform_key(feat)
    qk = key[0].flatten(1).T.contiguous()
    qe = sel[0].flatten(1).T.contiguous()
    valid = tmem.valid_mask(b.cap, b.size, "cpu")
    args = (b.key, b.shrinkage, b.value, qk, qe, 30, valid, True)
    exact, u_exact = ak.attend_topk(*args)
    dense, u_dense = ma.attend(b.key, b.shrinkage, b.value.transpose(0, 1),
                               qk, qe, 30, valid, True, method="approx")
    fused, u_fused = apx.attend_approx(*args)
    assert apx.Geometry.of(b.cap, apx.default_n_tile(
        b.value.shape[1] * b.value.shape[2], 4)).group == 4
    scale = exact.abs().max().item()
    for name, got, tol in [("dense", dense, 2e-3), ("fused", fused, 5e-3)]:
        drift = (got - exact).abs().max().item()
        assert drift <= tol * scale, (name, drift, scale)
    for name, got in [("dense", u_dense), ("fused", u_fused)]:
        assert np.isclose(got.sum().item(), u_exact.sum().item(),
                          rtol=1e-3), name
        assert (got - u_exact).abs().max().item() <= \
            0.02 * max(u_exact.max().item(), 1.0), name
