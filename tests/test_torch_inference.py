"""deva_tpu_torch's InferenceCore against deva_tpu's, frame by frame.

The three cases of tests/test_inference_parity.py (propagation from a
first-frame mask, a mid-stream object insertion that opens a second memory
bucket, and long-term consolidation with usage counting), on its synthetic
8x-upsampled 64x96 video, at its tolerances: 2e-3 on probabilities (5e-3
with long-term memory), and no argmax flip where the margin is above five
tolerances. The weights are a seeded port model carried to deva_tpu through
deva_tpu's own converter. On the CPU the port's attention takes the plain
PyTorch route of its kernels.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deva_tpu.config import InferenceConfig as JaxInferenceConfig
from deva_tpu.config import ModelConfig as JaxModelConfig
from deva_tpu.inference.core import InferenceCore as JaxInferenceCore
from deva_tpu.models.convert import convert_torch_statedict
from deva_tpu.models.network import DEVANetwork as JaxDEVANetwork

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.models.network import DEVANetwork, init_weights

torch.set_num_threads(2)

H, W = 64, 96


def _synthetic_video(rng, t=8):
    """Smooth random frames + moving-squares masks
    (tests/test_inference_parity.py:25-38)."""
    frames = []
    base = rng.standard_normal((H // 8, W // 8, 3)).astype(np.float32)
    for _ in range(t):
        img = base + 0.1 * rng.standard_normal((H // 8, W // 8, 3))
        frames.append(np.kron(img, np.ones((8, 8, 1))).astype(np.float32))
    mask0 = np.zeros((H, W), np.int64)
    mask0[8:28, 10:40] = 1
    mask0[36:60, 50:90] = 2
    mask_mid = np.zeros((H, W), np.int64)
    mask_mid[4:20, 60:88] = 3
    return frames, mask0, mask_mid


def _config(**over):
    cfg = dict(mem_every=2, top_k=8, enable_long_term=False,
               enable_long_term_count_usage=False, max_mid_term_frames=3,
               min_mid_term_frames=1, num_prototypes=16,
               max_long_term_elements=96)
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def models():
    net = init_weights(DEVANetwork(), seed=0).eval()
    variables = convert_torch_statedict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    return net, JaxDEVANetwork(JaxModelConfig()), variables


def _run_both(models, cfg, frames, mask0, mask_mid=None, mid_frame=4):
    net, jmodel, variables = models
    ours = InferenceCore(net, InferenceConfig(**cfg))
    ref = JaxInferenceCore(jmodel, variables, JaxInferenceConfig(**cfg))
    our_probs, ref_probs = [], []
    for ti, img in enumerate(frames):
        args = ()
        if ti == 0:
            args = (mask0, [1, 2])
        elif mask_mid is not None and ti == mid_frame:
            args = (mask_mid, [3])
        ref_probs.append(np.asarray(ref.step(jnp.asarray(img), *args)))
        our_probs.append(ours.step(img, *args).numpy())
    return ours, ref_probs, our_probs


def _compare(ref_probs, our_probs, atol):
    for ti, (r, o) in enumerate(zip(ref_probs, our_probs)):
        assert r.shape == o.shape, (ti, r.shape, o.shape)
        np.testing.assert_allclose(o, r, atol=atol, err_msg=f"frame {ti}")
        diff = o.argmax(0) != r.argmax(0)
        top2 = np.sort(r, axis=0)[-2:]
        bad = diff & (top2[1] - top2[0] > 5 * atol)
        assert not bad.any(), (
            f"argmax frame {ti}: {int(bad.sum())} confident mismatches")


def test_vos_propagation_parity(models):
    frames, mask0, _ = _synthetic_video(np.random.default_rng(7), t=6)
    _, ref_probs, our_probs = _run_both(models, _config(), frames, mask0)
    _compare(ref_probs, our_probs, atol=2e-3)


def test_vos_midstream_object_insertion(models):
    frames, mask0, mask_mid = _synthetic_video(np.random.default_rng(8), t=7)
    ours, ref_probs, our_probs = _run_both(models, _config(), frames, mask0,
                                           mask_mid=mask_mid, mid_frame=3)
    assert len(ours.memory.buckets) == 2
    assert our_probs[-1].shape[0] == 4  # background + 3 objects
    _compare(ref_probs, our_probs, atol=2e-3)


def test_vos_long_term_consolidation_parity(models):
    frames, mask0, _ = _synthetic_video(np.random.default_rng(9), t=10)
    cfg = _config(enable_long_term=True, enable_long_term_count_usage=True,
                  mem_every=1, max_mid_term_frames=4, min_mid_term_frames=2)
    ours, ref_probs, our_probs = _run_both(models, cfg, frames, mask0)
    lt = ours.memory.long_buckets[0]
    assert lt.size > 0 and lt.use_cnt is not None
    _compare(ref_probs, our_probs, atol=5e-3)


def test_memory_engine_eviction_and_purge_parity():
    """The memory engines alone, fed the same tokens: a second bucket
    mid-stream, repeated consolidation until long-term eviction runs
    (LT_max=12, P=4), and purge_except. Readouts within 1e-4 (f32 sums in
    another order), ring sizes and object lists equal."""
    from deva_tpu.inference.memory import MemoryEngine as JaxMemoryEngine

    from deva_tpu_torch.inference.memory import MemoryEngine

    hw, ck, cv, o_cap = 8, 16, 8, 4
    cfg = dict(top_k=6, enable_long_term=True,
               enable_long_term_count_usage=True, max_mid_term_frames=3,
               min_mid_term_frames=1, num_prototypes=4,
               max_long_term_elements=12)
    ref = JaxMemoryEngine(JaxInferenceConfig(**cfg), cv, ck, cv, o_cap)
    ours = MemoryEngine(InferenceConfig(**cfg), cv, ck, cv, o_cap,
                        device="cpu")
    evicted = []  # tokens each long-term eviction removed
    evict = ours._evict_obsolete

    def spy(bid, max_size):
        before = ours.long_buckets[bid].size
        evict(bid, max_size)
        evicted.append(before - ours.long_buckets[bid].size)

    ours._evict_obsolete = spy
    rng = np.random.default_rng(12)
    objects = [1, 2]
    for ti in range(16):
        if ti == 5:
            objects = [1, 2, 3]
        if ti == 11:
            objects = [1, 3]
            ref.purge_except(objects)
            ours.purge_except(objects)
        rows = {o: i for i, o in enumerate(objects)}
        if ti > 0:
            qk = rng.standard_normal((hw, ck)).astype(np.float32)
            qe = rng.uniform(0, 1, (hw, ck)).astype(np.float32)
            r = np.asarray(ref.match_memory(jnp.asarray(qk), jnp.asarray(qe),
                                            rows))
            o = ours.match_memory(torch.from_numpy(qk), torch.from_numpy(qe),
                                  rows).numpy()
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4,
                                       err_msg=f"frame {ti}")
        frame = dict(
            key=rng.standard_normal((hw, ck)).astype(np.float32),
            shrinkage=rng.uniform(1, 2, (hw,)).astype(np.float32),
            value=rng.standard_normal((o_cap, hw, cv)).astype(np.float32),
            selection=rng.uniform(0, 1, (hw, ck)).astype(np.float32))
        ref.add_memory(obj_ids=objects,
                       **{k: jnp.asarray(v) for k, v in frame.items()})
        ours.add_memory(obj_ids=objects,
                        **{k: torch.from_numpy(v) for k, v in frame.items()})
        for store in ("buckets", "long_buckets"):
            r_store, o_store = getattr(ref, store), getattr(ours, store)
            assert r_store.keys() == o_store.keys()
            for b in r_store:
                assert r_store[b].size == o_store[b].size, (ti, store, b)
                assert r_store[b].obj_ids == o_store[b].obj_ids
    assert any(n > 0 for n in evicted), "no eviction removed a token"
    assert [b.obj_ids for b in ours.buckets.values()] == [[1], [3]]
