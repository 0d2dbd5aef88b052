"""deva_tpu_torch.ops against deva_tpu.ops on the same seeded inputs (CPU).

The cases are those of tests/test_ops.py (which needs the upstream reference
and skips without it), held here against deva_tpu itself. Layouts: deva_tpu
resizes NHWC, the port NCHW; the tests transpose. Tolerances are stated per
test: ops that compute the same f32 arithmetic are held to 1e-6, matmul-based
ones (summation order differs between XLA and ATen) to 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deva_tpu import ops as jops
from deva_tpu.ops import memory_attention as jma

from deva_tpu_torch import ops as tops
from deva_tpu_torch.ops import memory_attention as tma

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("h,w", [(480, 854), (477, 853), (16, 16), (1, 1)])
def test_pad_divide_by_matches(h, w):
    x = np.random.default_rng(0).standard_normal((h, w, 3)).astype(np.float32)
    ours, pad = tops.pad_divide_by(_t(x), 16, 0, 1)
    ref, ref_pad = jops.pad_divide_by(jnp.asarray(x), 16, 0, 1)
    assert pad == ref_pad
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tops.unpad(ours, pad, 0, 1).numpy(), x)
    if (h, w) == (480, 854):
        assert pad == (5, 5, 0, 0) and ours.shape == (480, 864, 3)


@pytest.mark.parametrize("factor", [2, 4, 16])
def test_downsample_area_matches(factor):
    x = np.random.default_rng(1).standard_normal(
        (2, 32, 64, 5)).astype(np.float32)
    ref = np.asarray(jops.downsample_area(jnp.asarray(x), factor))
    ours = tops.downsample_area(_t(x.transpose(0, 3, 1, 2)), factor)
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("factor", [2, 4, 16])
def test_upsample_bilinear_matches(factor):
    x = np.random.default_rng(2).standard_normal(
        (2, 9, 13, 3)).astype(np.float32)
    ref = np.asarray(jops.upsample_bilinear(jnp.asarray(x), factor))
    ours = tops.upsample_bilinear(_t(x.transpose(0, 3, 1, 2)), factor)
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=1e-5, atol=1e-5)


def test_aggregate_matches():
    prob = np.random.default_rng(3).uniform(
        0, 1, size=(4, 17, 23)).astype(np.float32)
    prob[0, 0, :3] = [0.0, 1.0, 1e-9]  # exercise the clamp
    ref = np.asarray(jops.aggregate_logits(jnp.asarray(prob), axis=0))
    ours = tops.aggregate_logits(_t(prob), axis=0).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def _attention_inputs(seed=0, n=300, q=77, ck=64, cv=32, o=3):
    rng = np.random.default_rng(seed)
    mk = rng.standard_normal((n, ck)).astype(np.float32)
    ms = rng.uniform(1.0, 5.0, size=(n,)).astype(np.float32)
    qk = rng.standard_normal((q, ck)).astype(np.float32)
    qe = rng.uniform(0, 1, size=(q, ck)).astype(np.float32)
    v = rng.standard_normal((o, n, cv)).astype(np.float32)
    return mk, ms, qk, qe, v


@pytest.mark.parametrize("with_sel", [True, False])
@pytest.mark.parametrize("with_shrink", [True, False])
def test_similarity_matches(with_sel, with_shrink):
    mk, ms, qk, qe, _ = _attention_inputs()
    ms_, qe_ = (ms if with_shrink else None), (qe if with_sel else None)
    ref = np.asarray(jma.get_similarity(
        jnp.asarray(mk), None if ms_ is None else jnp.asarray(ms_),
        jnp.asarray(qk), None if qe_ is None else jnp.asarray(qe_)))
    ours = tma.get_similarity(_t(mk), None if ms_ is None else _t(ms_),
                              _t(qk), None if qe_ is None else _t(qe_))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_valid", [300, 200, 10])
def test_topk_softmax_and_readout_match(n_valid):
    """Exact top-k softmax, usage and readout; n_valid=10 < top_k leaves
    -inf slots (a softmax over the valid ones)."""
    mk, ms, qk, qe, v = _attention_inputs()
    valid = np.arange(300) < n_valid
    jsim = jma.get_similarity(jnp.asarray(mk), jnp.asarray(ms),
                              jnp.asarray(qk), jnp.asarray(qe))
    ref_aff, ref_usage = jma.topk_softmax(jsim, 30, jnp.asarray(valid),
                                          return_usage=True, method="exact")
    # the same similarity on both sides isolates the top-k and softmax
    aff, usage = tma.topk_softmax(_t(np.asarray(jsim)), 30, _t(valid),
                                  return_usage=True)
    np.testing.assert_allclose(aff.numpy(), np.asarray(ref_aff),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(usage.numpy(), np.asarray(ref_usage),
                               rtol=1e-5, atol=1e-6)
    assert np.all(aff.numpy()[:, n_valid:] == 0)

    ref_out = np.asarray(jma.readout(ref_aff, jnp.asarray(v)))
    out = tma.readout(aff, _t(v))
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-5, atol=1e-5)

    ref_att = np.asarray(jma.attend(
        jnp.asarray(mk), jnp.asarray(ms), jnp.asarray(v), jnp.asarray(qk),
        jnp.asarray(qe), top_k=30, valid=jnp.asarray(valid), method="exact"))
    att = tma.attend(_t(mk), _t(ms), _t(v), _t(qk), _t(qe), 30,
                     valid=_t(valid))
    np.testing.assert_allclose(att.numpy(), ref_att, rtol=1e-4, atol=1e-5)


def test_topk_ties_resolve_to_lowest_index():
    """Equal similarities must select the lowest indices, like lax.top_k."""
    sim = np.zeros((4, 50), np.float32)
    sim[:, 7] = sim[:, 30] = sim[:, 41] = 1.0
    aff = tma.topk_softmax(_t(sim), 5).numpy()
    ref = np.asarray(jma.topk_softmax(jnp.asarray(sim), 5, method="exact"))
    np.testing.assert_array_equal(aff > 0, ref > 0)
    assert set(np.nonzero(aff[0])[0]) == {0, 1, 7, 30, 41}


def test_masked_fixed_shape_equals_dynamic_prefix():
    """A fixed-capacity ring with a validity mask must reproduce the
    dynamic-shape result on the valid prefix (the ring-buffer invariant)."""
    mk, ms, qk, qe, v = _attention_inputs(seed=4, n=200)
    rng = np.random.default_rng(5)
    pad = lambda a, axis: np.concatenate(
        [a, rng.standard_normal((*a.shape[:axis], 312, *a.shape[axis + 1:])
                                ).astype(np.float32)], axis)
    valid = np.arange(512) < 200
    ref = tma.attend(_t(mk), _t(ms), _t(v), _t(qk), _t(qe), 30)
    out, usage = tma.attend(_t(pad(mk, 0)), _t(pad(ms, 0)), _t(pad(v, 1)),
                            _t(qk), _t(qe), 30, valid=_t(valid),
                            return_usage=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert np.all(usage.numpy()[200:] == 0)


def test_full_softmax_matches():
    mk, ms, qk, qe, _ = _attention_inputs(seed=6)
    jsim = jma.get_similarity(jnp.asarray(mk), jnp.asarray(ms),
                              jnp.asarray(qk), jnp.asarray(qe))
    valid = np.arange(300) < 250
    ref = np.asarray(jma.full_softmax(jsim, jnp.asarray(valid)))
    ours = tma.full_softmax(_t(np.asarray(jsim)), _t(valid)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("method", ["approx", "exact", "auto"])
def test_topk_method_runs_and_unknown_method_raises(method):
    """Every top-k method of deva_tpu runs, in topk_softmax and through the
    config; an unknown one raises in both."""
    from deva_tpu_torch.config import InferenceConfig
    sim = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 40)).astype(np.float32))
    aff = tma.topk_softmax(sim, 5, method=method)
    assert torch.allclose(aff.sum(-1), torch.ones(3))
    assert int((aff > 0).sum(-1).min()) >= 5
    want = "approx" if method == "approx" else "exact"
    assert InferenceConfig(topk_method=method).resolve_topk_method() == want
    with pytest.raises(ValueError, match="unknown"):
        tma.topk_softmax(sim, 5, method="fastest")
    with pytest.raises(ValueError, match="unknown"):
        InferenceConfig(topk_method="fastest").resolve_topk_method()
