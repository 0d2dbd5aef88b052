"""The model pieces that only training uses, against deva_tpu: the dense
read_memory and segment(need_aux=True) (the aux head), forward values on
the same weights and inputs; and TrainConfig's fields and defaults.

Tolerance 1e-5 of each output's largest magnitude (1e-5 absolute on
probabilities): f32 convolutions and products sum in another order in XLA
and ATen, a few ulps of the output scale.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deva_tpu.config import TrainConfig as JaxTrainConfig
from deva_tpu.models.network import DEVANetwork as JaxDEVANetwork

from deva_tpu_torch.config import TrainConfig

from torch_train_common import H, MAX_OBJ, W, tiny_nets

torch.set_num_threads(2)

B = 2
h, w = H // 16, W // 16


@pytest.fixture(scope="module")
def nets():
    return tiny_nets(seed=3)


def _nchw(x):
    """NHWC (or [B, O, h, w, C]) numpy -> channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _close(ours, ref, name, rel=1e-5):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * scale,
                               err_msg=name)


def test_read_memory_matches(nets):
    jmodel, variables, net = nets
    rng = np.random.default_rng(0)
    n = 3 * h * w
    qk = rng.standard_normal((B, h, w, 16)).astype(np.float32)
    qe = rng.uniform(0, 1, (B, h, w, 16)).astype(np.float32)
    mk = rng.standard_normal((B, n, 16)).astype(np.float32)
    ms = rng.uniform(1, 3, (B, n)).astype(np.float32)
    mv = rng.standard_normal((B, MAX_OBJ, n, 32)).astype(np.float32)
    ref = jmodel.apply(variables, *map(jnp.asarray, (qk, qe, mk, ms, mv)),
                       method=JaxDEVANetwork.read_memory)
    with torch.no_grad():
        out = net.read_memory(_nchw(qk), _nchw(qe), torch.from_numpy(mk),
                              torch.from_numpy(ms), torch.from_numpy(mv))
    assert out.shape == (B, MAX_OBJ, 32, h, w) and out.dtype == torch.float32
    _close(np.moveaxis(out.numpy(), 2, -1), ref, "read_memory")


@pytest.mark.parametrize("padded", [False, True])
def test_segment_aux_matches(nets, padded):
    """segment(need_aux=True): the main and aux logits and probabilities
    and the new sensory state; the aux head reads the sensory state before
    the decoder updates it. `padded` gives the second sample one real
    object (selector 0 on slot 2)."""
    jmodel, variables, net = nets
    rng = np.random.default_rng(1)
    image = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    ms, _ = jmodel.apply(variables, jnp.asarray(image),
                         method=JaxDEVANetwork.encode_image)
    ms = [np.asarray(x) for x in ms]
    readout = rng.standard_normal((B, MAX_OBJ, h, w, 32)).astype(np.float32)
    sensory = rng.standard_normal((B, MAX_OBJ, h, w, 32)).astype(np.float32)
    last = rng.uniform(0, 1, (B, MAX_OBJ, H, W)).astype(np.float32)
    selector = np.ones((B, MAX_OBJ), np.float32)
    if padded:
        selector[1, 1] = 0
    ref = jmodel.apply(variables, tuple(map(jnp.asarray, ms)),
                       jnp.asarray(readout), jnp.asarray(sensory),
                       jnp.asarray(last), jnp.asarray(selector),
                       need_aux=True, method=JaxDEVANetwork.segment)
    with torch.no_grad():
        out = net.segment(tuple(map(_nchw, ms)),
                          torch.from_numpy(np.moveaxis(readout, -1, 2).copy()),
                          torch.from_numpy(np.moveaxis(sensory, -1, 2).copy()),
                          torch.from_numpy(last), torch.from_numpy(selector),
                          need_aux=True)
    assert len(out) == 5
    _close(np.moveaxis(out[0].numpy(), 2, -1), ref[0], "sensory")
    for i, name in ((1, "logits"), (3, "aux_logits")):
        assert out[i].shape == (B, MAX_OBJ + 1, H, W)
        _close(out[i].numpy(), ref[i], name)
    for i, name in ((2, "prob"), (4, "aux_prob")):
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]),
                                   rtol=0, atol=1e-5, err_msg=name)
    # without need_aux, the same first three outputs
    with torch.no_grad():
        plain = net.segment(tuple(map(_nchw, ms)),
                            torch.from_numpy(
                                np.moveaxis(readout, -1, 2).copy()),
                            torch.from_numpy(
                                np.moveaxis(sensory, -1, 2).copy()),
                            torch.from_numpy(last),
                            torch.from_numpy(selector))
    for a, b in zip(plain, out[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_config_matches():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JaxTrainConfig())
