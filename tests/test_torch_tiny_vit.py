"""deva_tpu_torch's TinyViT (the MobileSAM / Light-HQ-SAM image encoder)
against deva_tpu's flax TinyViT, on the same seeded weights.

A seeded port encoder at MobileSAM's widths (64/128/160/320, heads
2/4/5/10, windows 7/7/14/7), depths cut to (1, 1, 2, 1), becomes its
deva_tpu twin through deva_tpu's own converter
(convert_tiny_vit_statedict), as tests/test_tiny_vit.py converts the
reference's. Inputs from a numpy seed. Sizes: 1024 (SAM's, every stage's
grid padded to whole windows: 128 -> 133, 64 -> 70) and 320 (40 -> 42,
20 -> 28: a window of 14 over a 20 grid is mostly padding).

Tolerance: 1e-4 absolute on the neck's output (max |value| ~4) and on the
early 160-channel features. The two differ by f32 summation order alone
(cuDNN/oneDNN against XLA convolutions, matmul order); measured ~3e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deva_tpu.ext.tiny_vit import TinyViT as JaxTinyViT
from deva_tpu.ext.tiny_vit import convert_tiny_vit_statedict

from deva_tpu_torch.ext.convert import tiny_vit_state_dict
from deva_tpu_torch.ext.sam_decoder import init_sam_weights
from deva_tpu_torch.ext.tiny_vit import TinyViT, attention_bias_idxs

torch.set_num_threads(2)

DEPTHS = (1, 1, 2, 1)
ATOL = 1e-4


@pytest.fixture(scope="module")
def encoders():
    net = init_sam_weights(TinyViT(depths=DEPTHS), seed=3).eval()
    variables = convert_tiny_vit_statedict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    apply = jax.jit(lambda v, x: JaxTinyViT(depths=DEPTHS).apply(
        v, x, return_interm=True))
    return net, variables, apply


@pytest.mark.parametrize("size", [1024, 320])
def test_tiny_vit_matches_deva_tpu(encoders, size):
    net, variables, apply = encoders
    x = np.random.default_rng(size).standard_normal(
        (1, size, size, 3)).astype(np.float32)
    want, want_interm = apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
        got2, interm = net(torch.from_numpy(np.moveaxis(x, -1, 1).copy()),
                           return_interm=True)
    assert got.shape == (1, 256, size // 16, size // 16)
    assert interm.shape == (1, 160, size // 16, size // 16)
    assert torch.equal(got, got2)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(interm.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_interm), rtol=0, atol=ATOL)


def test_tiny_vit_state_dict_round_trip():
    """port state dict -> deva_tpu variables (deva_tpu's converter) -> port
    state dict (ext/convert.py): the same keys and the same tensors, bit
    for bit, at MobileSAM's full depths; and the keys are MobileSAM's."""
    net = init_sam_weights(TinyViT(), seed=4)
    sd = net.state_dict()
    back = tiny_vit_state_dict(convert_tiny_vit_statedict(
        {k: v.numpy() for k, v in sd.items()}))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    for key in ("patch_embed.seq.0.c.weight", "patch_embed.seq.2.bn.bias",
                "layers.0.blocks.1.conv2.c.weight",
                "layers.0.downsample.conv3.bn.running_var",
                "layers.2.blocks.5.attn.attention_biases",
                "layers.2.blocks.5.attn.qkv.weight",
                "layers.3.blocks.1.local_conv.c.weight",
                "layers.3.blocks.1.mlp.fc2.bias", "neck.0.weight",
                "neck.3.bias"):
        assert key in sd, key
    assert "layers.3.downsample.conv1.c.weight" not in sd


def test_attention_bias_table_matches_deva_tpu():
    from deva_tpu.ext.tiny_vit import _attention_bias_idxs
    for res in ((7, 7), (14, 14)):
        idxs, n = attention_bias_idxs(res)
        want, n_want = _attention_bias_idxs(res)
        assert n == n_want and np.array_equal(idxs.numpy(), want)
