"""deva_tpu_torch.ops.attention_kernels (the port's exact top-k attention,
plain PyTorch route on the CPU) against deva_tpu's Pallas kernels in
interpret mode, on the same seeded inputs.

The cases and tolerances are those of tests/test_pallas_attention.py:
`test_sim_topk_exact_vs_dense`, `test_sim_topk_ties_resolve_to_lowest_index`,
`test_topk_readout_matches_dense`, `test_attend_pallas_matches_xla` and
`test_attend_pallas_fewer_valid_than_k`. The CUDA kernels themselves are held
against these plain functions on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deva_tpu.ops import pallas_attention as pa

from deva_tpu_torch.ops import attention_kernels as ak

torch.set_num_threads(2)


def _inputs(seed, n, q, ck, n_valid=None, o=None, cv=None):
    rng = np.random.default_rng(seed)
    out = dict(mk=rng.standard_normal((n, ck)).astype(np.float32),
               ms=rng.uniform(1, 4, (n,)).astype(np.float32),
               qk=rng.standard_normal((q, ck)).astype(np.float32),
               qe=rng.uniform(0, 1, (q, ck)).astype(np.float32),
               valid=None if n_valid is None else np.arange(n) < n_valid)
    if o is not None:
        out["values"] = rng.standard_normal((n, o, cv)).astype(np.float32)
    return out


def _both(x):
    """-> (jax array, torch tensor) of a numpy array, or (None, None)."""
    if x is None:
        return None, None
    return jnp.asarray(x), torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n,q,k", [(700, 130, 12), (2000, 300, 30),
                                   (150, 40, 30)])
def test_sim_topk_matches_pallas(n, q, k):
    d = _inputs(2, n, q, 64, n_valid=n - n // 8)
    (jqk, tqk), (jqe, tqe), (jmk, tmk), (jms, tms), (jv, tv) = map(
        _both, (d["qk"], d["qe"], d["mk"], d["ms"], d["valid"]))
    ref_v, ref_i = pa.sim_topk(jqk, jqe, jmk, jms, jv, k, interpret=True)
    gv, gi = ak.sim_topk(tqk, tqe, tmk, tms, tv, k)
    assert gv.shape == gi.shape == (q, k) and gi.dtype == torch.int32
    np.testing.assert_allclose(gv.numpy(), np.asarray(ref_v), rtol=1e-5,
                               atol=1e-5)
    mism = gi.numpy() != np.asarray(ref_i)
    assert mism.mean() < 1e-3, f"{mism.sum()} index mismatches"


def test_sim_topk_ties_resolve_to_lowest_index():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((10, 16)).astype(np.float32)
    mk = np.tile(base, (30, 1))  # 300 tokens, 30x duplicated
    qk = rng.standard_normal((16, 16)).astype(np.float32)
    ref_v, ref_i = pa.sim_topk(jnp.asarray(qk), None, jnp.asarray(mk), None,
                               None, 4, interpret=True)
    gv, gi = ak.sim_topk(torch.from_numpy(qk), None, torch.from_numpy(mk),
                         None, None, 4)
    np.testing.assert_allclose(gv.numpy(), np.asarray(ref_v), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("n,q,o", [(512, 256, 2), (1024, 512, 4)])
def test_topk_readout_matches_pallas(n, q, o):
    rng = np.random.default_rng(0)
    k, cv = 16, 64
    idx = rng.integers(0, n, (q, k)).astype(np.int32)
    w = rng.uniform(0, 1, (q, k)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    values = rng.standard_normal((n, o * cv)).astype(np.float32)
    ref = pa.topk_readout(jnp.asarray(idx), jnp.asarray(w),
                          jnp.asarray(values), q_tile=128, n_tile=256,
                          interpret=True)
    out = ak.topk_readout(torch.from_numpy(idx), torch.from_numpy(w),
                          torch.from_numpy(values))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_attend_topk_matches_attend_pallas():
    d = _inputs(1, 700, 300, 64, n_valid=600, o=3, cv=32)
    (jmk, tmk), (jms, tms), (jval, tval), (jqk, tqk), (jqe, tqe), \
        (jv, tv) = map(_both, (d["mk"], d["ms"], d["values"], d["qk"],
                               d["qe"], d["valid"]))
    ref, ref_usage = pa.attend_pallas(jmk, jms, jval, jqk, jqe, top_k=12,
                                      valid=jv, return_usage=True,
                                      interpret=True)
    out, usage = ak.attend_topk(tmk, tms, tval, tqk, tqe, 12, valid=tv,
                                return_usage=True)
    assert out.shape == (3, 300, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(usage.numpy(), np.asarray(ref_usage),
                               rtol=1e-4, atol=1e-5)


def test_attend_topk_fewer_valid_than_k():
    """Rows with fewer valid tokens than k degrade to a softmax over the
    valid ones, and every selected index stays inside the ring."""
    d = _inputs(4, 256, 64, 32, n_valid=5, o=2, cv=16)
    d["ms"] = np.random.default_rng(4).uniform(1, 2, (256,)).astype(
        np.float32)
    (jmk, tmk), (jms, tms), (jval, tval), (jqk, tqk), (jqe, tqe), \
        (jv, tv) = map(_both, (d["mk"], d["ms"], d["values"], d["qk"],
                               d["qe"], d["valid"]))
    ref = pa.attend_pallas(jmk, jms, jval, jqk, jqe, top_k=12, valid=jv,
                           interpret=True)
    out, usage = ak.attend_topk(tmk, tms, tval, tqk, tqe, 12, valid=tv,
                                return_usage=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    _, gi = ak.sim_topk(tqk, tqe, tmk, tms, tv, 12)
    assert int(gi.max()) < 256
    assert np.all(usage.numpy()[5:] == 0)
    np.testing.assert_allclose(usage.numpy().sum(), 64, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 24, 29])
def test_attend_topk_ring_smaller_than_k(n):
    """A ring of fewer tokens than top_k=30 (a 64x96 frame gives 24): both
    sides keep all n tokens (deva_tpu's Pallas route pads the ring and
    softmaxes over the real tokens), out within 1e-4 and usage within 1e-5;
    sim_topk returns [Q, n]."""
    d = _inputs(8, n, 16, 64, o=2, cv=8)
    (jmk, tmk), (jms, tms), (jval, tval), (jqk, tqk), (jqe, tqe) = map(
        _both, (d["mk"], d["ms"], d["values"], d["qk"], d["qe"]))
    ref, ref_usage = pa.attend_pallas(jmk, jms, jval, jqk, jqe, top_k=30,
                                      return_usage=True, interpret=True)
    out, usage = ak.attend_topk(tmk, tms, tval, tqk, tqe, 30,
                                return_usage=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(usage.numpy(), np.asarray(ref_usage),
                               rtol=1e-5, atol=1e-5)
    gv, gi = ak.sim_topk(tqk, tqe, tmk, tms, None, 30)
    assert gv.shape == gi.shape == (16, n)
    assert sorted(gi[0].tolist()) == list(range(n))
    with pytest.raises(ValueError):
        ak.sim_topk(tqk, tqe, tmk[:0], tms[:0], None, 30)  # an empty ring


def test_plain_twins_are_the_cpu_route():
    """On CPU tensors each wrapper is its plain twin, and launches nothing."""
    d = _inputs(7, 300, 50, 64, n_valid=280, o=2, cv=8)
    t = {k: (torch.from_numpy(np.array(v)) if v is not None else None)
         for k, v in d.items()}
    ak.reset_launch_counts()
    a = ak.attend_topk(t["mk"], t["ms"], t["values"], t["qk"], t["qe"], 10,
                       valid=t["valid"], return_usage=True)
    b = ak.attend_topk_plain(t["mk"], t["ms"], t["values"], t["qk"], t["qe"],
                             10, valid=t["valid"], return_usage=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    from deva_tpu_torch.ops import approx_kernels as apx
    apx.attend_approx(t["mk"], t["ms"], t["values"], t["qk"], t["qe"], 10,
                      valid=t["valid"], return_usage=True)
    assert ak.LAUNCHES == {"sim_topk": 0, "topk_readout": 0, "segmax": 0,
                           "denom_readout": 0}
