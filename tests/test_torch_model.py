"""deva_tpu_torch's DEVANetwork against deva_tpu's, with the same weights.

Two parts:
- the weight bridge both ways: flax init -> variables_to_state_dict -> the
  port's load_state_dict(strict=True); and the port's state_dict() ->
  deva_tpu's convert_torch_statedict -> verify_converted -> the same tree;
- each of the four inference modes (encode_image, transform_key,
  encode_mask, segment) against DEVANetwork.apply at 64x96 on the same
  seeded inputs. deva_tpu is NHWC, the port NCHW; the tests transpose.

Tolerance: 1e-4 of each output's largest magnitude (f32 convolutions sum in
another order in XLA and in ATen; the errors stay at a few ulps of the
output scale), and 1e-4 absolute on probabilities.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deva_tpu.config import ModelConfig as JaxModelConfig
from deva_tpu.models.convert import convert_torch_statedict, verify_converted
from deva_tpu.models.network import DEVANetwork as JaxDEVANetwork

from deva_tpu_torch.models.convert import variables_to_state_dict
from deva_tpu_torch.models.network import DEVANetwork, init_weights

torch.set_num_threads(2)

B, O, H, W = 1, 2, 64, 96
h, w = H // 16, W // 16


@pytest.fixture(scope="module")
def nets():
    jmodel = JaxDEVANetwork(JaxModelConfig())
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 1, 32, 32)),
                            jnp.zeros((1, 1, 2, 2, 512)))
    net = DEVANetwork().eval()
    net.load_state_dict(variables_to_state_dict(variables), strict=True)
    return jmodel, variables, net


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


def _close(ours, ref, name, rel=1e-4):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * scale,
                               err_msg=name)


def test_flax_variables_load_strict_and_round_trip(nets):
    _, variables, net = nets
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back = convert_torch_statedict(sd)
    verify_converted(back)
    flat_in = dict(_leaves(variables))
    flat_back = dict(_leaves(back))
    assert flat_in.keys() == flat_back.keys()
    for k in flat_in:
        np.testing.assert_array_equal(np.asarray(flat_in[k]), flat_back[k],
                                      err_msg=k)


def test_port_state_dict_round_trip():
    """port state_dict -> deva_tpu variables -> port state_dict, and the
    flat-keyed (.npz) form of the variables converts the same way."""
    net = init_weights(DEVANetwork(), seed=1)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    variables = convert_torch_statedict(sd)
    verify_converted(variables)
    for form in (variables, {"/".join(k): v for k, v in _leaves(variables)}):
        back = variables_to_state_dict(form)
        assert back.keys() == sd.keys()
        for k in sd:
            np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_encode_image_and_transform_key(nets):
    jmodel, variables, net = nets
    img = np.random.default_rng(0).standard_normal(
        (B, H, W, 3)).astype(np.float32)
    (f16, f8, f4), feat = jmodel.apply(variables, jnp.asarray(img),
                                       method=JaxDEVANetwork.encode_image)
    with torch.no_grad():
        (tf16, tf8, tf4), tfeat = net.encode_image(_nchw(img))
    for name, r, o in [("f16", f16, tf16), ("f8", f8, tf8), ("f4", f4, tf4),
                       ("key_feat", feat, tfeat)]:
        _close(_nhwc(o), r, name)

    k, s, e = jmodel.apply(variables, feat,
                           method=JaxDEVANetwork.transform_key)
    with torch.no_grad():
        tk, ts, te = net.transform_key(_nchw(np.asarray(feat)))
    for name, r, o in [("key", k, tk), ("shrinkage", s, ts),
                       ("selection", e, te)]:
        _close(_nhwc(o), r, name)


@pytest.mark.parametrize("deep_update", [True, False])
def test_encode_mask(nets, deep_update):
    jmodel, variables, net = nets
    rng = np.random.default_rng(1)
    img = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    f16 = rng.standard_normal((B, h, w, 512)).astype(np.float32)
    sensory = rng.standard_normal((B, O, h, w, 512)).astype(np.float32)
    masks = rng.uniform(0, 1, (B, O, H, W)).astype(np.float32)
    value, new_s = jmodel.apply(variables, jnp.asarray(img),
                                jnp.asarray(f16), jnp.asarray(sensory),
                                jnp.asarray(masks), deep_update=deep_update,
                                method=JaxDEVANetwork.encode_mask)
    with torch.no_grad():
        tvalue, tnew_s = net.encode_mask(
            _nchw(img), _nchw(f16), _nchw(sensory), torch.from_numpy(masks),
            deep_update=deep_update)
    _close(_nhwc(tvalue), value, "value")
    _close(_nhwc(tnew_s), new_s, "sensory")


@pytest.mark.parametrize("update_sensory", [True, False])
def test_segment(nets, update_sensory):
    jmodel, variables, net = nets
    rng = np.random.default_rng(2)
    ms = (rng.standard_normal((B, h, w, 512)).astype(np.float32),
          rng.standard_normal((B, 2 * h, 2 * w, 512)).astype(np.float32),
          rng.standard_normal((B, 4 * h, 4 * w, 256)).astype(np.float32))
    readout = rng.standard_normal((B, O, h, w, 512)).astype(np.float32)
    sensory = rng.standard_normal((B, O, h, w, 512)).astype(np.float32)
    last_mask = rng.uniform(0, 1, (B, O, H, W)).astype(np.float32)
    selector = np.array([[1.0, 0.0]], np.float32)  # second slot padded
    new_s, logits, prob = jmodel.apply(
        variables, tuple(jnp.asarray(m) for m in ms), jnp.asarray(readout),
        jnp.asarray(sensory), jnp.asarray(last_mask),
        selector=jnp.asarray(selector), update_sensory=update_sensory,
        method=JaxDEVANetwork.segment)
    with torch.no_grad():
        tnew_s, tlogits, tprob = net.segment(
            tuple(_nchw(m) for m in ms), _nchw(readout), _nchw(sensory),
            torch.from_numpy(last_mask), selector=torch.from_numpy(selector),
            update_sensory=update_sensory)
    assert tprob.shape == (B, O + 1, H, W)
    _close(_nhwc(tnew_s), new_s, "sensory")
    _close(tlogits.numpy(), logits, "logits")
    np.testing.assert_allclose(tprob.numpy(), np.asarray(prob), atol=1e-4,
                               rtol=0)
