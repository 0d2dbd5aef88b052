"""deva_tpu_torch's InferenceCore in bf16 against deva_tpu's, over the
golden clip (tests/fixtures/golden_vos.npz: 4 frames of 240x427, two
objects), with tests/test_amp.py's whole-clip budget per frame: mean
|dprob| < 0.03, argmax flips at confident pixels (reference margin > 0.25)
under 2%, and none where the reference margin exceeds 0.6.

Here deva_tpu's serving configuration, bf16 compute with bf16 rings and
approx top-k, the same in both packages and with the same weights (a
seeded port model carried to deva_tpu by its converter). Measured on the
CPU: per-frame mean |dprob| 0.0029-0.0037, max 0.104, no confident flip
(largest flipped margin 0.026). tests/test_torch_amp_mixed.py runs the two
mixed configurations with the same runner.
"""
from os import path

import numpy as np
import torch

import jax.numpy as jnp

from deva_tpu.config import InferenceConfig as JaxInferenceConfig
from deva_tpu.config import ModelConfig as JaxModelConfig
from deva_tpu.inference.core import InferenceCore as JaxInferenceCore
from deva_tpu.models.convert import convert_torch_statedict
from deva_tpu.models.network import DEVANetwork as JaxDEVANetwork

from deva_tpu_torch.config import InferenceConfig, ModelConfig
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.models.network import DEVANetwork, init_weights

torch.set_num_threads(2)

FIXTURE = path.join(path.dirname(path.abspath(__file__)), "fixtures",
                    "golden_vos.npz")


def run_clip(dtype: str, ring_dtype: str, method: str):
    """Both packages over the golden clip in one configuration, held to
    the budget frame by frame. Returns the port's InferenceCore."""
    fx = np.load(FIXTURE)
    inputs, mask0 = fx["inputs"].astype(np.float32), \
        fx["mask0"].astype(np.int64)
    labels = [int(v) for v in np.unique(mask0) if v != 0]
    net = init_weights(DEVANetwork(ModelConfig(dtype=dtype)), seed=0).eval()
    variables = convert_torch_statedict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    cfg = dict(mem_every=1, top_k=30, enable_long_term=False,
               ring_dtype=ring_dtype, topk_method=method)
    ours = InferenceCore(net, InferenceConfig(**cfg))
    ref = JaxInferenceCore(JaxDEVANetwork(JaxModelConfig(dtype=dtype)),
                           variables, JaxInferenceConfig(**cfg))
    for ti in range(inputs.shape[0]):
        args = (mask0, labels) if ti == 0 else ()
        pr = np.asarray(ref.step(jnp.asarray(inputs[ti]), *args), np.float32)
        po = ours.step(inputs[ti], *args)
        assert po.dtype == torch.float32
        po = po.numpy()
        assert po.shape == pr.shape
        mean = np.abs(po - pr).mean()
        assert mean < 0.03, (ti, mean)
        flips = po.argmax(0) != pr.argmax(0)
        srt = np.sort(pr, axis=0)
        margin = srt[-1] - srt[-2]
        assert (flips & (margin > 0.25)).mean() < 0.02, ti
        assert not (flips & (margin > 0.6)).any(), ti
    rings = next(iter(ours.memory.buckets.values()))
    assert rings.key.dtype == rings.value.dtype == getattr(torch, ring_dtype)
    return ours


def test_clip_serving_configuration_against_deva_tpu():
    run_clip("bfloat16", "bfloat16", "approx")
