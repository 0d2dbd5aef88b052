"""The reference (perfbench/reference/, a frozen copy of the port's plain
path) against the port's plain path at a tiny size on the CPU, where the
port runs the same plain twins: the network's modes and a single-stream
sequence with memory writes and long-term consolidation agree."""
import numpy as np
import pytest
import torch

from harness import frames, weights


def _pair(dtype="float32"):
    from deva_tpu_torch.config import ModelConfig as PortModelConfig
    from deva_tpu_torch.models.network import DEVANetwork as PortNet
    from reference.config import ModelConfig as RefModelConfig
    from reference.models.network import DEVANetwork as RefNet
    kw = {"pix_feat_dim": 512, "key_dim": 64, "value_dim": 512,
          "dtype": dtype}
    sd = weights.make_state_dict(kw, 3, "cpu")
    return (weights.load_into(PortNet, PortModelConfig(**kw), sd, "cpu"),
            weights.load_into(RefNet, RefModelConfig(**kw), sd, "cpu"))


@torch.no_grad()
def test_network_modes_agree():
    port, ref = _pair()
    g = torch.Generator().manual_seed(0)
    img = torch.randn(2, 3, 64, 112, generator=g)
    (pf, pk), (rf, rk) = port.encode_image(img), ref.encode_image(img)
    torch.testing.assert_close(pk, rk, rtol=0, atol=0)
    for a, b in zip(port.transform_key(pk), ref.transform_key(rk)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["exact", "approx"])
@torch.no_grad()
def test_single_stream_sequence_agrees(method):
    """20 frames at 48x80 with long-term memory brought forward (min/max
    mid-term 2/3 frames, 16 prototypes): memory writes and consolidations
    run in both."""
    from deva_tpu_torch.config import InferenceConfig as PortCfg
    from deva_tpu_torch.inference.core import InferenceCore as PortCore
    from reference.config import InferenceConfig as RefCfg
    from reference.inference.core import InferenceCore as RefCore
    port, ref = _pair()
    kw = dict(mem_every=2, min_mid_term_frames=2, max_mid_term_frames=3,
              num_prototypes=16, topk_method=method)
    bank, labels = frames.make_bank(1, 20, 48, 80, 2, 9, "cpu")
    pc, rc = PortCore(port, PortCfg(**kw)), RefCore(ref, RefCfg(**kw))
    mask = frames.first_mask(labels[0, 0], 2)
    for t in range(20):
        args = (mask, [1, 2]) if t == 0 else ()
        a = pc.step(bank[0, t].numpy(), *args)
        b = rc.step(bank[0, t].numpy(), *args)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    lt = rc.memory.long_buckets
    assert lt and next(iter(lt.values())).size > 0, "no consolidation ran"
