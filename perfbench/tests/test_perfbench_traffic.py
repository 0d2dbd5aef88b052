"""The inputs a run draws from its seed: the same seed gives the same
inputs, another seed other inputs, and every seed the same amount of work."""
import itertools

import pytest
import torch

from deva_tpu_torch.config import InferenceConfig
from harness import frames, weights
from harness.manifest import load_json
from harness.batched_vos import passes

from conftest import BENCH

SEEDS = (7, 2 ** 31 + 11)  # the driver's seeds pass 32 signed bits
PAD = InferenceConfig().pad_objects


def _mix():
    return load_json(f"{BENCH}/traffic/davis-b4.json")


def _passes(traffic, seed, n=3):
    return list(itertools.islice(passes(traffic, seed, PAD), n))


def _work(groups):
    return sorted((g.names, g.lengths, g.objects) for g in groups)


@pytest.mark.parametrize("seed", SEEDS)
def test_passes_repeat_per_seed_and_keep_the_work(seed):
    mix = _mix()
    a, b = _passes(mix, seed), _passes(mix, seed)
    assert a == b
    for groups in a:  # every pass runs the same groups, in another order
        assert _work(groups) == _work(a[0])
        assert sum(map(sum, (g.lengths for g in groups))) == \
            sum(v[1] for v in mix["videos"])
        for g in groups:  # one object bucket a group, as the driver groups
            assert len({PAD(n) for n in g.objects}) == 1
            assert 1 <= len(g.names) <= mix["batch"]
            assert len(g.bank) == len(g.names)


def test_groups_follow_the_driver():
    """Buckets in ascending order, each in the listing's order, `batch` at
    a time: DAVIS 2017 val's 30 videos make 9 groups."""
    groups = sorted(_passes(_mix(), SEEDS[0], 1)[0],
                    key=lambda g: (PAD(g.objects[0]), g.names))
    assert [len(g.names) for g in groups] == [4, 4, 4, 1, 4, 3, 4, 4, 2]
    assert groups[0].names == ["blackswan", "breakdance", "camel",
                               "car-roundabout"]
    assert groups[-1].names == ["gold-fish", "lab-coat"]
    assert {PAD(n) for n in groups[-1].objects} == {8}


def test_passes_differ_across_seeds():
    mix = _mix()
    a, b = _passes(mix, SEEDS[0]), _passes(mix, SEEDS[1])
    assert [g.names for g in a[0]] != [g.names for g in b[0]]
    assert _work(a[0]) == _work(b[0])


def test_frame_bank_repeats_per_seed_and_differs_across_seeds():
    make = lambda seed: frames.make_bank(2, 3, 40, 56, 3, seed, "cpu")
    (b1, l1), (b2, l2), (b3, _) = make(SEEDS[0]), make(SEEDS[0]), \
        make(SEEDS[1])
    assert torch.equal(b1, b2) and torch.equal(l1, l2)
    assert not torch.equal(b1, b3)
    assert b1.shape == (2, 3, 40, 56, 3) and b1.dtype == torch.float32
    # the first object is never hidden: it has pixels in the first frame
    for v in range(2):
        mask = frames.first_mask(l1[v, 0], 2)
        assert (mask == 1).any()
        assert set(mask.reshape(-1).tolist()) <= {0, 1, 2}


def test_weights_repeat_per_seed_and_differ_across_seeds():
    kw = {"pix_feat_dim": 512, "key_dim": 64, "value_dim": 512,
          "dtype": "float32"}
    a = weights.make_state_dict(kw, SEEDS[1], "cpu")
    b = weights.make_state_dict(kw, SEEDS[1], "cpu")
    c = weights.make_state_dict(kw, SEEDS[0], "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    key = "pixel_encoder.conv1.weight"
    assert not torch.equal(a[key], c[key])
    # orthonormal rows of the key projection, identity BatchNorm statistics
    w = a["key_proj.key_proj.weight"].flatten(1)
    torch.testing.assert_close(w @ w.T, torch.eye(w.shape[0]), atol=1e-4,
                               rtol=0)
    assert torch.equal(a["pixel_encoder.bn1.running_var"],
                       torch.ones(64))
    # the port's model takes them whole
    from deva_tpu_torch.config import ModelConfig
    from deva_tpu_torch.models.network import DEVANetwork
    net = weights.load_into(DEVANetwork, ModelConfig(), a, "cpu")
    assert torch.equal(net.state_dict()[key], a[key])
