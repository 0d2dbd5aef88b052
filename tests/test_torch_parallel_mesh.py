"""deva_tpu_torch/parallel/mesh.py and the object-axis collectives of
parallel/object_sharding.py on 2 and 4 gloo ranks: the ('data', 'model')
meshes, shard_batch, replicate, the host all-reduce, the slot moves of
ObjectShards (take, gather, gather_prob, regather, broadcast0), and the
background product and softmax over every rank's objects, with
ops/aggregate.py:aggregate_logits and models/network.py:_aggregate on a
group, against their whole-tensor forms and deva_tpu's aggregate_logits.

Tolerances: the moves are exact (bit for bit); the product and softmax,
whose sums and products run in another order, within 1e-6 of the
whole-tensor forms; aggregate_logits within 1e-5 of deva_tpu's (f32 logits
of the same clamped probabilities).
"""
import numpy as np
import pytest
import torch

import torch_parallel_common as C

from deva_tpu_torch.models.network import _aggregate
from deva_tpu_torch.ops.aggregate import aggregate_logits
from deva_tpu_torch.parallel.mesh import init_from_env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    return {w: C.spawn(w, "mesh", tmp) for w in (2, 4)}


def test_one_process_joins_no_group(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    device, rank, world = init_from_env("cpu")
    assert (device, rank, world) == (torch.device("cpu"), 0, 1)
    assert not dist.is_initialized()


@pytest.mark.parametrize("world", [2, 4])
def test_meshes(runs, world):
    for rank, r in enumerate(runs[world]):
        for dims in ((1, world), (world, 1), (2, world // 2)):
            got = r[dims]
            assert got["names"] == ("data", "model")
            assert got["multi"]
            assert got["sizes"] == dims
            assert got["index"] == (rank // dims[1], rank % dims[1])


@pytest.mark.parametrize("world", [2, 4])
def test_shard_replicate_reduce(runs, world):
    ref = C.tiny_net(seed=0).state_dict()
    for rank, r in enumerate(runs[world]):
        rows = slice(2 * rank, 2 * rank + 2)
        np.testing.assert_array_equal(
            r["shard"]["x"], torch.arange(2 * world * 3).reshape(-1, 3)[rows])
        assert r["shard"]["videos"] == [f"v{i}" for i in
                                        range(2 * world)][rows]
        for k, v in ref.items():
            assert torch.equal(r["weights"][k], v), k
        assert torch.equal(r["tree"][0], torch.zeros(2))
        assert r["max"] == [world - 1, 0]
        assert r["sum"] == [world * (world + 1) // 2]


@pytest.mark.parametrize("world", [2, 4])
def test_slot_moves(runs, world):
    x, _, _ = (torch.from_numpy(a) for a in C.slot_inputs())
    per = C.SLOTS // world
    want = torch.stack([x[j] if j >= 0 else torch.zeros_like(x[0])
                        for j in C.REGATHER_SRC])
    for rank, r in enumerate(runs[world]):
        mine = slice(rank * per, (rank + 1) * per)
        assert torch.equal(r["take"], x[mine])
        assert torch.equal(r["gather"], x)
        assert torch.equal(r["regather"], want[mine])
        # the background (slot 0 of each rank's part) is rank 0's
        assert torch.equal(r["gather_prob"],
                           torch.cat([torch.zeros(1, 3, 5), x]))
        assert torch.equal(r["broadcast0"], torch.zeros(3))


@pytest.mark.parametrize("world", [2, 4])
def test_object_collectives(runs, world):
    import jax.numpy as jnp
    from deva_tpu.ops.aggregate import aggregate_logits as jax_aggregate
    _, prob, logits = (torch.from_numpy(a) for a in C.slot_inputs())
    per = C.SLOTS // world
    product = torch.prod(1 - prob, 0, keepdim=True)
    softmax = torch.softmax(logits, 0)
    whole = aggregate_logits(prob, 0)
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jax_aggregate(jnp.asarray(prob.numpy()),
                                                axis=0)), atol=1e-5)
    sel = (torch.arange(C.SLOTS) < C.SLOTS - 1).float()[None]
    lg, pr = _aggregate(logits[None, 1:], sel, 4)
    for rank, r in enumerate(runs[world]):
        objs = slice(1 + rank * per, 1 + (rank + 1) * per)
        keep = [0] + list(range(objs.start, objs.stop))
        np.testing.assert_allclose(r["product"], product, atol=1e-6)
        np.testing.assert_allclose(r["softmax"], softmax[keep], atol=1e-6)
        np.testing.assert_allclose(r["aggregate"], whole[keep], atol=1e-5)
        got_lg, got_pr = r["_aggregate"]
        np.testing.assert_allclose(got_lg, lg[:, keep], atol=1e-5)
        np.testing.assert_allclose(got_pr, pr[:, keep], atol=1e-6)
