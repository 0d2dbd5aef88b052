"""deva_tpu_torch's object-sharded InferenceCore (obj_mesh=, the four
objects over 2 or 4 gloo ranks) against deva_tpu's unsharded core and its
InferenceCore(obj_mesh=make_mesh(2, 4)) on the virtual CPU devices,
mirroring tests/test_object_sharding.py: step with long-term memory, and
step_chunk. (The detection clip under sharding is
tests/test_torch_object_sharding_det.py.)

Tolerances (tests/test_object_sharding.py's scheme): the first three
frames within 2e-4; later frames, where the random-weight recurrence
amplifies summation-order noise, at most 2% of the pixels beyond 5e-3 and
at most 2% argmax flips. Every rank returns the same probabilities, bit
for bit, and the ring bookkeeping equals deva_tpu's.
"""
import numpy as np
import pytest

import torch_parallel_common as C



@pytest.fixture(scope="module")
def nets():
    net = C.tiny_net()
    return net, C.jax_net(net)


def _jax_core(nets, cfg: dict, obj_mesh=None):
    from deva_tpu.config import InferenceConfig as JaxInferenceConfig
    from deva_tpu.inference.core import InferenceCore as JaxInferenceCore
    _, (jmodel, variables) = nets
    return JaxInferenceCore(jmodel, variables,
                            JaxInferenceConfig(topk_method="exact", **cfg),
                            obj_mesh=obj_mesh)


def _hold(ref, got, label):
    for ti, (a, b) in enumerate(zip(ref, got)):
        assert a.shape == b.shape, (label, ti, a.shape, b.shape)
        if ti <= 2:
            np.testing.assert_allclose(b, a, atol=2e-4,
                                       err_msg=f"{label} frame {ti}")
        else:
            bad = (np.abs(b - a) > 5e-3).any(axis=0)
            assert bad.mean() <= 0.02, f"{label} frame {ti}: {bad.mean():.2%}"
            flips = a.argmax(0) != b.argmax(0)
            assert flips.mean() <= 0.02, \
                f"{label} frame {ti}: argmax {flips.mean():.2%}"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both modes on 2 and on 4 ranks; every rank's probabilities are
    checked equal, bit for bit -> rank 0's results."""
    tmp = tmp_path_factory.mktemp("core")
    out = {}
    for world in (2, 4):
        res = C.spawn(world, "core", tmp, "exact")
        for mode in ("step", "chunk"):
            for r in res[1:]:
                for a, b in zip(res[0][mode]["probs"], r[mode]["probs"]):
                    np.testing.assert_array_equal(a, b)
        out[world] = res[0]
    return out


@pytest.fixture(scope="module")
def reference(nets):
    """mode, sharded -> deva_tpu's run of that mode, unsharded or with
    make_mesh(2, 4) (the 'model' axis 4, tests/test_object_sharding.py's
    mesh): (its probabilities, its core), each run once."""
    from deva_tpu.parallel.mesh import make_mesh
    runs = {}

    def get(mode: str, sharded: bool):
        if (mode, sharded) not in runs:
            chunk = mode == "chunk"
            core = _jax_core(nets, C.CHUNK_CFG if chunk else C.CORE_CFG,
                             make_mesh(2, 4) if sharded else None)
            frames, mask0 = C.core_video(*C.CORE_VIDEOS[mode])
            runs[mode, sharded] = (C.run_core(core, frames, mask0, chunk),
                                   core)
        return runs[mode, sharded]
    return get


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["step", "chunk"])
def test_object_sharded_core(reference, ranks, world, mode):
    """The port on `world` ranks against deva_tpu's unsharded core, with
    the same ring bookkeeping; each rank holds its share of the four object
    slots."""
    got = ranks[world][mode]
    assert got["sensory_slots"] == 4 // world
    assert got["value_cols"] == 4 // world
    ref, ref_core = reference(mode, False)
    _hold(ref, got["probs"], "deva_tpu unsharded")
    assert got["curr_ti"] == ref_core.curr_ti
    assert got["last_mem_ti"] == ref_core.last_mem_ti
    (_, b), = ref_core.memory.buckets.items()
    assert got["size"] == b.size
    assert got["lt_size"] == [lt.size for lt in
                              ref_core.memory.long_buckets.values()]
    if mode == "step":
        assert got["lt_size"], "the run must engage long-term memory"


@pytest.mark.parametrize("world", [2, 4])
def test_object_sharded_chunk_matches_sharded_deva_tpu(reference, ranks,
                                                       world):
    """step_chunk on `world` ranks against deva_tpu's object-sharded core
    (InferenceCore(obj_mesh=make_mesh(2, 4)))."""
    ref, _ = reference("chunk", True)
    _hold(ref, ranks[world]["chunk"]["probs"], "deva_tpu sharded")
