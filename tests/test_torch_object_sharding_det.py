"""deva_tpu_torch's object-sharded InferenceCore on a detection clip
(tests/torch_parallel_common.py:det_clip, online, detections every 2
frames): an insertion, growth of the padded object count, a purge, and the
purge frame's new object whose kept row lies beyond the sensory's, which
deva_tpu's gather clamps to the last row of the whole object axis (C-2): on
2 and 4 ranks that row lives on the last rank, and slot 1, which takes it,
on another. Then the same core's spatial_alignment (three objects, padded
to four and sharded).

The clip takes perfect forward predictions, so its host decisions read no
device output: the object tables must equal deva_tpu's
InferenceCore(obj_mesh=...) ('model' axis of the rank count, so the same
padded object counts), every frame within 5e-3 of it and the sensory
after the purge frame within 1e-3; on 2 ranks, whose padding the
unsharded core shares, every frame within 1e-4 of the port's unsharded
core and the sensory within 1e-3 (a clamp within one rank's slice would
give slot 1 another object's state). Every rank returns the same
probabilities, bit for bit.
"""
import numpy as np
import pytest

import torch_parallel_common as C

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.inference.object_info import ObjectInfo


@pytest.fixture(scope="module")
def nets():
    net = C.tiny_net()
    return net, C.jax_net(net)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """det_clip on 2 and on 4 ranks; every rank's probabilities and
    alignment checked equal, bit for bit -> rank 0's results."""
    tmp = tmp_path_factory.mktemp("det")
    out = {}
    for world in (2, 4):
        ranks = C.spawn(world, "det", tmp, "exact")
        for r in ranks[1:]:
            for a, b in zip(ranks[0]["probs"], r["probs"]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ranks[0]["align"], r["align"])
        out[world] = ranks[0]
    return out


def _jax_core(nets, obj_mesh=None):
    from deva_tpu.config import InferenceConfig as JaxInferenceConfig
    from deva_tpu.inference.core import InferenceCore as JaxInferenceCore
    jmodel, variables = nets[1]
    return JaxInferenceCore(jmodel, variables,
                            JaxInferenceConfig(topk_method="exact",
                                               **C.DET_CFG),
                            obj_mesh=obj_mesh)


@pytest.mark.parametrize("world", [2, 4])
def test_detection_under_sharding(nets, runs, world):
    from deva_tpu.inference.object_info import ObjectInfo as JaxObjectInfo
    from deva_tpu.parallel.mesh import make_mesh
    got = runs[world]

    # the clip made what it is for: growth, a purge, a kept row clamped
    tables = got["tables"]
    assert len(tables[C.PURGE_FRAME - 2]) == 4
    assert [t[0] for t in tables[C.PURGE_FRAME]] == [1, 5]
    assert got["o_cap"] == 4

    jcore = _jax_core(nets, make_mesh(8 // world, world))
    ref, ref_sensory, ref_tables = C.run_det(
        jcore, JaxObjectInfo, lambda c: np.asarray(c.memory.sensory))
    assert tables == ref_tables
    for ti, (a, b) in enumerate(zip(ref, got["probs"])):
        np.testing.assert_allclose(b, a, atol=5e-3, err_msg=f"frame {ti}")
    # deva_tpu's sensory is [O, h, w, C]
    np.testing.assert_allclose(got["sensory"].numpy(),
                               ref_sensory.transpose(0, 3, 1, 2), atol=1e-3)

    if world == 2:
        core = InferenceCore(nets[0], InferenceConfig(**C.DET_CFG),
                             device="cpu")
        out, sensory, tables = C.run_det(core, ObjectInfo,
                                         lambda c: c.memory.sensory.clone())
        assert tables == got["tables"]
        for ti, (a, b) in enumerate(zip(out, got["probs"])):
            np.testing.assert_allclose(b, a, atol=1e-4,
                                       err_msg=f"frame {ti}")
        np.testing.assert_allclose(got["sensory"].numpy(), sensory.numpy(),
                                   atol=1e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_alignment_under_sharding(nets, runs, world):
    """InferenceCore.spatial_alignment with its three objects padded to 4
    and sharded: within 1e-5 of the port's unsharded alignment (3 slots:
    the extra padded slot and the sums' order move the softmax by ~1e-7)
    and within 3e-3 of deva_tpu's (tests/torch_detection_common.py's
    compare_prob budget)."""
    src_image, src_mask, tar_image = C.align_inputs()
    core = InferenceCore(nets[0], InferenceConfig(**C.DET_CFG), device="cpu")
    ours = core.spatial_alignment(100, src_image, src_mask, 101, tar_image)
    ref = np.asarray(_jax_core(nets).spatial_alignment(
        100, src_image, src_mask, 101, tar_image))
    got = runs[world]["align"]
    assert got.shape == ours.shape == (1 + len(C.ALIGN_IDS), C.H, C.W)
    np.testing.assert_allclose(got, ours, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=3e-3)
