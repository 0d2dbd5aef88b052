"""The host side of deva_tpu_torch's sim_topk kernel, on the CPU: the split
plan of the token axis, the f32 divisor of msv = ms / sqrt(Ck), the
wrapper's copy of the kernel's limits, and the wrapper's argument checks
(which run before the kernel library is built). The kernel itself runs only
on a card (tests/test_torch_cuda.py)."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deva_tpu_torch.ops import attention_kernels as ak

SOURCE = Path(ak.__file__).resolve().parents[1] / "csrc" / "sim_topk.cu"


@pytest.mark.parametrize("q", [1, 63, 64, 65, 1620, 8100])
@pytest.mark.parametrize("sms", [132, 1])
def test_plan_covers_the_ring_in_whole_tiles(q, sms):
    """For every ring size from 1 token to 16712: the splits cover N, none
    is empty, each is a whole number of token tiles, and there are at most
    MAX_SPLITS of them (what deva_sim_topk checks before it launches)."""
    for n in range(1, 16713):
        splits, split_len = ak._sim_topk_plan(q, n, 30, sms)
        assert 1 <= splits <= ak.MAX_SPLITS, (n, splits)
        assert split_len > 0 and split_len % ak.NT == 0, (n, split_len)
        assert splits * split_len >= n > (splits - 1) * split_len, \
            (n, splits, split_len)
        assert split_len >= ak.MIN_SPLIT_TILES * ak.NT, (n, split_len)


def test_plan_at_the_480p_rings():
    """At Q=1620 on 132 SMs the plan keeps about 2.25 blocks per SM, and at
    the first ring (1620 tokens) splits of 3 tiles (the H100 sweep's best)."""
    assert ak._sim_topk_plan(1620, 1620, 30, 132) == (9, 192)
    for n in (3240, 6480, 8100, 16712):
        splits, _ = ak._sim_topk_plan(1620, n, 30, 132)
        assert 26 * splits in range(264, 340), (n, splits)


@pytest.mark.parametrize("ck", [16, 32, 48, 64])
def test_msv_divisor_matches_the_plain_division(ck):
    """ms / d in IEEE f32, d the divisor handed to the kernel, is bitwise
    what the plain path's `ms / math.sqrt(ck)` gives on the CPU."""
    d = ak.msv_divisor(ck)
    assert float(np.float32(d)) == d  # exactly an f32
    rng = np.random.default_rng(ck)
    ms = np.concatenate([rng.uniform(1, 4, 50_000),
                         np.exp(rng.uniform(-80, 80, 50_000)),
                         [1.0, 2.0, 3.0, 4.0, 1e-38, 3e38]]).astype(np.float32)
    want = (torch.from_numpy(ms) / math.sqrt(ck)).numpy()
    got = ms / np.float32(d)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_wrapper_limits_mirror_the_kernel_source():
    src = SOURCE.read_text()
    found = tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)
                      .group(1))
                  for name in ("QT", "NT", "CK_MAX", "K_MAX", "MAX_SPLITS"))
    assert found == (ak.QT, ak.NT, ak.CK_MAX, ak.K_MAX, ak.MAX_SPLITS)


@pytest.mark.parametrize("ck,top_k,n,error", [
    (65, 8, 300, ValueError),   # key dim above the kernel bound
    (64, 65, 300, ValueError),  # k above the kernel bound
    (64, 0, 300, ValueError),
    (64, 30, 0, ValueError),    # an empty ring (fewer tokens than k
                                # select min(k, n): test_torch_attention)
])
def test_wrapper_rejects_before_building(ck, top_k, n, error):
    qk = torch.zeros((10, ck))
    mk = torch.zeros((n, ck))
    with pytest.raises(error):
        ak._sim_topk_cuda(qk, None, mk, None, None, top_k)
