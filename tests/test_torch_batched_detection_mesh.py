"""Video sharding of the batched detection propagator: deva_tpu_torch's
BatchedDetectionPropagator with a 2-rank 'data' mesh (each gloo rank
attaches and steps the core of its one of the two multi-bucket videos)
against deva_tpu's mesh=make_mesh(2, 1) run on the virtual CPU
devices, deva_tpu's unsharded run and the port's unsharded run, with
long-term memory engaged. Mirrors tests/test_batched_detection.py:512
(test_multibucket_mesh_equals_unsharded).

Tolerances: against deva_tpu, that test's scheme (the first block within
1e-3; later blocks at most 2% of the pixels beyond 5e-3 and at most 2%
argmax flips); against the port's unsharded group every block within
1e-4. The ring and long-term sizes and the stacked shapes the group agrees
on must equal the unsharded group's.
"""
import numpy as np
import pytest

import torch_parallel_common as C
from test_torch_batched_mesh import _gathered, _hold

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.batched_detection import \
    BatchedDetectionPropagator
from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.inference.object_info import ObjectInfo


@pytest.fixture(scope="module")
def nets():
    net = C.tiny_net()
    return net, C.jax_net(net)


def test_batched_detection_mesh(nets, tmp_path):
    from deva_tpu.config import InferenceConfig as JaxInferenceConfig
    from deva_tpu.inference.batched_detection import \
        BatchedDetectionPropagator as JaxProp
    from deva_tpu.inference.core import InferenceCore as JaxCore
    from deva_tpu.inference.object_info import ObjectInfo as JaxObjectInfo
    from deva_tpu.parallel.mesh import make_mesh
    started = C.start(2, "bdet", tmp_path, "exact")
    vids = C.bdet_videos()
    net, (jmodel, variables) = nets
    jcfg = JaxInferenceConfig(topk_method="exact", **C.BDET_CFG)
    refs = {}
    for mesh in (make_mesh(2, 1), None):
        jcores = [JaxCore(jmodel, variables, jcfg) for _ in vids]
        bp = JaxProp(jmodel, variables, jcfg, mesh=mesh)
        refs[mesh is not None] = C.run_bdet(bp, jcores, vids, JaxObjectInfo)

    ranks = C.finish(started)
    got = _gathered(ranks)
    cfg = InferenceConfig(**C.BDET_CFG)
    cores = [InferenceCore(net, cfg, device="cpu") for _ in vids]
    ours = BatchedDetectionPropagator(net, cfg)
    ref, sizes, lt_sizes = C.run_bdet(ours, cores, vids, ObjectInfo)
    for ti, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(b, a, atol=1e-4, err_msg=f"block {ti}")
    assert (lt_sizes.max(1) > 0).all(), \
        "the run must engage long-term memory"
    np.testing.assert_array_equal(
        np.concatenate([r["sizes"] for r in ranks]), sizes)
    np.testing.assert_array_equal(
        np.concatenate([r["lt_sizes"] for r in ranks]), lt_sizes)
    for r in ranks:
        assert (r["o_cap"], r["n_slots"]) == (ours.o_cap, ours.n_slots)
    for sharded, (out, jsizes, jlt) in refs.items():
        _hold(out, got, f"deva_tpu mesh={sharded}")
        np.testing.assert_array_equal(jsizes, sizes)
        np.testing.assert_array_equal(jlt, lt_sizes)
