"""deva_tpu_torch's Light-HQ-SAM (MobileSAM(hq=True)) against deva_tpu's
JaxMobileSAM(hq=True), and the port's checkpoint loading, on seeded
weights.

Light-HQ-SAM: TinyViT's early 160-channel features go into the HQ
decoder; the weights are a seeded port network saved as a released
Light-HQ-SAM file is ({"model": state dict} with TinyViT's classifier
head, which the SAM encoder never runs), loaded by
MobileSAM.from_checkpoint and deva_tpu's from_torch_checkpoint. The
comparison and its tolerances are tests/test_torch_mobile_sam.py's
(_check_boxes) at 240x320: logits within 1e-2, hard masks equal except
where deva_tpu's logit lies within 1e-2 of 0.
"""
import numpy as np
import torch

from deva_tpu.ext.jax_sam import JaxMobileSAM

from deva_tpu_torch.ext.mobile_sam import MobileSAM
from deva_tpu_torch.ext.sam_decoder import init_sam_weights

from test_torch_mobile_sam import KW, _check_boxes

torch.set_num_threads(2)


def test_light_hq_sam_matches(tmp_path):
    net = init_sam_weights(MobileSAM(device="cpu", hq=True).net, seed=12)
    sd = dict(net.state_dict())
    sd["image_encoder.norm_head.weight"] = torch.ones(320)
    sd["image_encoder.head.weight"] = torch.zeros(1000, 320)
    path = str(tmp_path / "sam_hq_vit_tiny.pth")
    torch.save({"model": sd}, path)
    ours = MobileSAM.from_checkpoint(path, hq=True, device="cpu", **KW)
    ref = JaxMobileSAM.from_torch_checkpoint(path, hq=True, **KW)
    _check_boxes(ours, ref, 240, 320)


def test_from_checkpoint_npz(tmp_path):
    """A deva_tpu .npz (scripts/convert_sam_checkpoint.py's slash-joined
    variable tree) loads into the port bit for bit."""
    import jax
    sd = MobileSAM(device="cpu", seed=13).net.state_dict()
    path = str(tmp_path / "mobile_sam.pt")
    torch.save(sd, path)
    ref = JaxMobileSAM.from_torch_checkpoint(path)
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(ref.variables)}
    npz = str(tmp_path / "mobile_sam.npz")
    np.savez(npz, **flat)
    ours = MobileSAM.from_checkpoint(npz, device="cpu")
    for k, v in ours.net.state_dict().items():
        assert torch.equal(v, sd[k]), k
