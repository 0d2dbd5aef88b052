"""Shared set-up of tests/test_torch_batched*.py: deva_tpu_torch's
BatchedPropagator (inference/batched.py) against deva_tpu's, on the CPU, with
the cases of tests/test_batched.py.

Both sides take the same weights (a seeded port model carried to deva_tpu by
its converter) and the same frames; deva_tpu runs with
use_pallas_attention=True, so its vmapped step reaches attend_pallas or
attend_pallas_approx{,_multi} (patched to interpret mode by the
`pallas_interpret` fixture, in the tests only), and the port runs its
kernels' plain twins with the video axis. Probabilities are held within 5e-3
with no confident argmax flip (the _compare of
tests/test_torch_fused_step.py: f32 sums in another order, amplified by the
random-init recurrence); ring sizes, long-term sizes and the memory schedule
must be equal.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deva_tpu.config import InferenceConfig as JaxInferenceConfig
from deva_tpu.config import ModelConfig as JaxModelConfig
from deva_tpu.inference.batched import BatchedPropagator as JaxPropagator
from deva_tpu.models.convert import convert_torch_statedict
from deva_tpu.models.network import DEVANetwork as JaxDEVANetwork
from deva_tpu.ops import pallas_attention as pa

from deva_tpu_torch.config import InferenceConfig, ModelConfig
from deva_tpu_torch.inference.batched import BatchedPropagator
from deva_tpu_torch.models.network import DEVANetwork, init_weights

H, W = 64, 96
OBJECTS = [[1], [1, 2]]
# tests/test_batched.py's long-term configuration: 24 tokens a frame,
# consolidation every 2 writes after warm-up, eviction at 16 long-term
# tokens
LT_CFG = dict(mem_every=1, top_k=8, enable_long_term=True,
              enable_long_term_count_usage=True, max_mid_term_frames=4,
              min_mid_term_frames=2, num_prototypes=8,
              max_long_term_elements=24)


@functools.lru_cache(maxsize=None)
def nets(dtype: str = "float32"):
    """(port model, deva_tpu model, deva_tpu variables) with one set of
    weights, in the compute dtype `dtype`."""
    net = init_weights(DEVANetwork(ModelConfig(dtype=dtype)), seed=0)
    variables = convert_torch_statedict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    return net.eval(), JaxDEVANetwork(JaxModelConfig(dtype=dtype)), variables


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    """deva_tpu's FusedStepper imports the Pallas composites at call time;
    point them at interpret mode (the test only, deva_tpu untouched)."""
    for name in ("attend_pallas", "attend_pallas_approx_multi",
                 "attend_pallas_approx"):
        monkeypatch.setattr(pa, name, functools.partial(getattr(pa, name),
                                                        interpret=True))


def video(rng, t, n_obj):
    """tests/test_batched.py:_video."""
    base = rng.standard_normal((H // 8, W // 8, 3)).astype(np.float32)
    frames = [np.kron(base + 0.1 * rng.standard_normal((H // 8, W // 8, 3)),
                      np.ones((8, 8, 1))).astype(np.float32)
              for _ in range(t)]
    mask0 = np.zeros((H, W), np.int64)
    mask0[8:28, 10:40] = 1
    if n_obj > 1:
        mask0[36:60, 50:90] = 2
    return frames, mask0


def videos(seed, t):
    """One video per entry of OBJECTS, t frames each."""
    rng = np.random.default_rng(seed)
    return [video(rng, t, len(objs)) for objs in OBJECTS]


def pair(vids, dtype="float32", **cfg):
    """Both propagators, initialised on the videos' first frames."""
    net, jnet, variables = nets(dtype)
    ours = BatchedPropagator(net, InferenceConfig(**cfg))
    ref = JaxPropagator(jnet, variables,
                        JaxInferenceConfig(use_pallas_attention=True, **cfg))
    for bp in (ours, ref):
        bp.initialize([v[0][0] for v in vids], [v[1] for v in vids], OBJECTS)
    return ours, ref


def compare(ref, ours, atol, label):
    """tests/test_torch_fused_step.py:_compare on one frame [C, H, W]."""
    ref = np.asarray(ref, np.float32)
    ours = np.asarray(ours, np.float32)
    assert ref.shape == ours.shape, (label, ref.shape, ours.shape)
    np.testing.assert_allclose(ours, ref, atol=atol, err_msg=label)
    diff = ours.argmax(0) != ref.argmax(0)
    top2 = np.sort(ref, axis=0)[-2:]
    assert not (diff & (top2[1] - top2[0] > 5 * atol)).any(), \
        f"{label}: confident argmax mismatch"


def step_both(ours, ref, frames, atol=5e-3, label=""):
    """One step_all on both sides, each video held by compare()."""
    p_ours = ours.step_all(frames).numpy()
    p_ref = np.asarray(ref.step_all([jnp.asarray(f) for f in frames]))
    for vi in range(len(frames)):
        compare(p_ref[vi], p_ours[vi], atol, f"{label} video {vi}")
    return p_ours


def same_schedule(ours, ref):
    np.testing.assert_array_equal(ours.sizes, ref.sizes)
    np.testing.assert_array_equal(ours.lt_sizes, ref.lt_sizes)
    assert ours._last_mem_ti() == ref._last_mem_ti()
    assert ours.frame_idx == ref.frame_idx


torch.set_num_threads(2)
