"""Video sharding of the batched propagator: deva_tpu_torch's
BatchedPropagator with a 2-rank 'data' mesh (each gloo rank stacks and
steps its own two of the four videos) against deva_tpu's
mesh=make_mesh(4, 1) run on the virtual CPU devices, deva_tpu's unsharded
run and the port's unsharded run, with long-term memory engaged. Mirrors
tests/test_batched.py:185 (test_batched_mesh_equals_unsharded); the
detection propagator's twin is tests/test_torch_batched_detection_mesh.py.

Tolerances: against deva_tpu, the scheme of those tests (the first frame
within 1e-3; later frames at most 2% of the pixels beyond 5e-3 and at most
2% argmax flips: other partitions and sum orders, amplified by the
random-weight recurrence); against the port's unsharded group every frame
within 1e-4 (the same kernels' twins, on half the videos at a time). The
ring sizes, long-term sizes and the capacities the group agrees on must be
equal to the unsharded group's.
"""
import numpy as np
import pytest

import torch_parallel_common as C

from deva_tpu_torch.config import InferenceConfig
from deva_tpu_torch.inference.batched import BatchedPropagator


@pytest.fixture(scope="module")
def nets():
    net = C.tiny_net()
    return net, C.jax_net(net)


def _hold(ref, got, label):
    for ti, (a, b) in enumerate(zip(ref, got)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (label, ti, a.shape, b.shape)
        if ti == 0:
            np.testing.assert_allclose(b, a, atol=1e-3,
                                       err_msg=f"{label} frame {ti}")
            continue
        c = a.ndim - 3  # the channel axis
        bad = (np.abs(b - a) > 5e-3).any(axis=c)
        assert bad.mean() <= 0.02, f"{label} frame {ti}: {bad.mean():.2%}"
        flips = a.argmax(c) != b.argmax(c)
        assert flips.mean() <= 0.02, f"{label} frame {ti}: {flips.mean():.2%}"


def _gathered(ranks, key="probs"):
    """The ranks' per-frame outputs, videos concatenated in rank order."""
    return [np.concatenate([r[key][i] for r in ranks])
            for i in range(len(ranks[0][key]))]


def test_batched_mesh(nets, tmp_path):
    from deva_tpu.config import InferenceConfig as JaxInferenceConfig
    from deva_tpu.inference.batched import BatchedPropagator as JaxProp
    from deva_tpu.parallel.mesh import make_mesh
    started = C.start(2, "batched", tmp_path, "exact")
    vids = C.batch_videos()
    net, (jmodel, variables) = nets
    jcfg = JaxInferenceConfig(topk_method="exact", **C.BATCH_CFG)
    refs = {}
    for mesh in (make_mesh(4, 1), None):
        bp = JaxProp(jmodel, variables, jcfg, mesh=mesh)
        refs[mesh is not None] = (C.run_batched(bp, vids, C.BATCH_OBJECTS),
                                  bp)

    ranks = C.finish(started)
    got = _gathered(ranks)
    ours = BatchedPropagator(net, InferenceConfig(**C.BATCH_CFG))
    ref = C.run_batched(ours, vids, C.BATCH_OBJECTS)
    for ti, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(b, a, atol=1e-4, err_msg=f"frame {ti}")
    assert (ours.lt_sizes > 0).all(), "the run must engage long-term memory"
    np.testing.assert_array_equal(
        np.concatenate([r["sizes"] for r in ranks]), ours.sizes)
    np.testing.assert_array_equal(
        np.concatenate([r["lt_sizes"] for r in ranks]), ours.lt_sizes)
    for r in ranks:
        assert (r["o_cap"], r["cap"], r["lcap"]) == \
            (ours.o_cap, ours.key.shape[1], ours.lt_key.shape[1])
    for sharded, (out, bp) in refs.items():
        _hold(out, got, f"deva_tpu mesh={sharded}")
        np.testing.assert_array_equal(bp.sizes, ours.sizes)
        np.testing.assert_array_equal(bp.lt_sizes, ours.lt_sizes)
