"""deva_tpu_torch's threshold-approx attention (ops/approx_kernels.py, the
plain PyTorch route on the CPU) against deva_tpu's Pallas kernels in
interpret mode and its dense XLA form, on the same seeded inputs.

The six `test_attend_pallas_approx_*` cases of tests/test_pallas_attention.py
(all but the vmap one, which the port has no counterpart of) are mirrored
here, each also run through deva_tpu's kernel, plus the group partition and
the dense topk_softmax(method='approx'). Tolerances: 1e-5 on the group
maxima and 1e-4 on readout and usage (f32 sums in another order; on random
data no entry lies within rounding of a threshold). The CUDA kernels
themselves are held against these plain functions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deva_tpu.ops import memory_attention as jma
from deva_tpu.ops import pallas_attention as pa

from deva_tpu_torch.ops import approx_kernels as apx
from deva_tpu_torch.ops import memory_attention as tma

torch.set_num_threads(2)


def _inputs(seed, n, q, o, ck, cv, n_valid=None):
    """tests/test_pallas_attention.py:_rand_attend_inputs, as numpy."""
    rng = np.random.default_rng(seed)
    d = dict(mk=rng.standard_normal((n, ck)), ms=rng.uniform(1, 4, (n,)),
             qk=rng.standard_normal((q, ck)), qe=rng.uniform(0, 1, (q, ck)),
             values=np.transpose(rng.standard_normal((o, n, cv)), (1, 0, 2)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["valid"] = None if n_valid is None else np.arange(n) < n_valid
    return d


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _both_approx(d, k, n_tile=None, with_ms=True, with_qe=True):
    """(deva_tpu attend_pallas_approx, port attend_approx), both with
    usage."""
    ms = d["ms"] if with_ms else None
    qe = d["qe"] if with_qe else None
    ref, ref_u = pa.attend_pallas_approx(
        _j(d["mk"]), _j(ms), _j(d["values"]), _j(d["qk"]), _j(qe), k,
        valid=_j(d["valid"]), return_usage=True, n_tile=n_tile,
        interpret=True)
    out, usage = apx.attend_approx(
        _t(d["mk"]), _t(ms), _t(d["values"]), _t(d["qk"]), _t(qe), k,
        valid=_t(d["valid"]), return_usage=True, n_tile=n_tile)
    return (np.asarray(ref), np.asarray(ref_u)), (out.numpy(), usage.numpy())


def _exact(d, k, with_ms=True, with_qe=True):
    """deva_tpu's exact XLA attention, [O, Q, Cv] and usage."""
    v_om = jnp.transpose(jnp.asarray(d["values"]), (1, 0, 2))
    out, usage = jma.attend(
        _j(d["mk"]), _j(d["ms"] if with_ms else None), v_om, _j(d["qk"]),
        _j(d["qe"] if with_qe else None), top_k=k, valid=_j(d["valid"]),
        return_usage=True, method="exact")
    return np.asarray(out), np.asarray(usage)


@pytest.mark.parametrize("n,n_tile,want", [
    (16712, 512, (512, 2, 128, 4, 33)),    # 480p, two objects, f32
    (16712, 1024, (1024, 2, 256, 4, 17)),  # one object
    (100, 512, (128, 0, 128, 1, 1)),       # n <= 128: groups of one
    (200, 512, (256, 1, 128, 2, 1)),
    (300, 1024, (384, 0, 384, 1, 1)),
    (700, 1024, (768, 1, 384, 2, 1)),
])
def test_group_partition(n, n_tile, want):
    """Geometry follows _prep2 / _segmax_pass, and the plain segmax folds
    exactly those groups: group g of tile t is {g, g+W, ...} of the tile."""
    g = apx.Geometry.of(n, n_tile)
    assert (g.n_tile, g.folds, g.width, g.group, g.tiles) == want
    assert g.nseg == g.tiles * g.width
    # a similarity that is its own token index reveals the partition
    q = 3
    ops = apx.Operands(qcat=torch.zeros((q, 4)), mcat=torch.zeros((n, 4)),
                       bsq=None, msq=-torch.arange(n, dtype=torch.float32),
                       msv=torch.ones(n), valid=None)
    seg = apx.segmax_plain(ops, g)
    t, w = np.divmod(np.arange(g.nseg), g.width)
    members = t[:, None] * g.n_tile + np.arange(g.group)[None, :] * g.width \
        + w[:, None]
    members = np.where(members < n, members, -1)
    expect = np.where(members.max(1) >= 0, members.max(1), -np.inf)
    np.testing.assert_array_equal(seg[0].numpy(), expect)


@pytest.mark.parametrize("with_qe", [True, False])
@pytest.mark.parametrize("n,q,n_valid", [(2048, 300, 1800), (700, 130, 600),
                                         (100, 40, None)])
def test_segmax_matches_pallas(n, q, n_valid, with_qe):
    d = _inputs(20, n, q, 2, 64, 8, n_valid=n_valid)
    qe = d["qe"] if with_qe else None
    ops_j, has_qe, q_tile, n_tile, qp, np_, kc = pa._prep2(
        _j(d["qk"]), _j(qe), _j(d["mk"]), _j(d["ms"]), _j(d["valid"]), 256,
        512)
    grid = (qp // q_tile, np_ // n_tile)
    ref = np.asarray(pa._segmax_pass(ops_j, grid, q_tile, n_tile, kc, qp,
                                     np_, has_qe, True))[:q]
    geom = apx.Geometry.of(n, 512)
    ops = apx.prep2(_t(d["qk"]), _t(qe), _t(d["mk"]), _t(d["ms"]),
                    _t(d["valid"]))
    seg = apx.segmax(ops, geom).numpy()
    assert seg.shape == ref.shape == (q, geom.nseg)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(seg), fin)
    np.testing.assert_allclose(seg[fin], ref[fin], rtol=1e-5, atol=1e-5)


def test_attend_approx_exact_when_single_tile():
    """N <= 128: groups of one, so the threshold is the exact k-th and the
    result equals exact top-k attention."""
    d = _inputs(10, 120, 70, 2, 32, 16, n_valid=100)
    (ref, ref_u), (out, usage) = _both_approx(d, 12)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(usage, ref_u, rtol=1e-5, atol=1e-6)
    ex, ex_u = _exact(d, 12)
    np.testing.assert_allclose(out, ex, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(usage, ex_u, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,q,o,k", [(2048, 300, 3, 30), (700, 130, 2, 12)])
def test_attend_approx_superset_guarantee(n, q, o, k):
    """Equal to deva_tpu's kernel; and the support contains the exact top-k:
    every exact top-k token has a similarity >= the threshold."""
    d = _inputs(11, n, q, o, 64, 32, n_valid=n - n // 7)
    (ref, ref_u), (out, usage) = _both_approx(d, k)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(usage, ref_u, rtol=1e-4, atol=1e-4)

    ops = apx.prep2(_t(d["qk"]), _t(d["qe"]), _t(d["mk"]), _t(d["ms"]),
                    _t(d["valid"]))
    geom = apx.Geometry.of(n, apx.default_n_tile(o * 32, 4))
    assert geom.group > 1
    _, th = apx.threshold(apx.segmax(ops, geom), k)
    sim = apx.similarity2_plain(ops)
    top = torch.topk(sim, k, dim=-1).values
    assert bool((top >= th).all()), "support misses an exact top-k entry"
    support = (sim >= th).sum(-1)
    # at most k groups reach th (no ties in random data)
    assert int(support.min()) >= k
    assert int(support.max()) <= geom.group * k


def test_attend_approx_usage_conserved():
    d = _inputs(12, 600, 333, 2, 32, 16, n_valid=500)
    (ref, ref_u), (out, usage) = _both_approx(d, 8)
    assert np.isclose(usage.sum(), 333, rtol=1e-4), usage.sum()
    assert (usage[500:] == 0).all(), "invalid tokens must get zero usage"
    np.testing.assert_allclose(usage, ref_u, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_attend_approx_fewer_valid_than_k():
    """th = -inf: every valid token counts, as in the exact path."""
    d = _inputs(13, 256, 64, 2, 32, 16, n_valid=5)
    (ref, _), (out, usage) = _both_approx(d, 12)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    ex, ex_u = _exact(d, 12)
    np.testing.assert_allclose(out, ex, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(usage, ex_u, rtol=1e-4, atol=1e-5)


def test_attend_approx_no_valid_token_gives_zeros():
    """A row with no valid token: zeros (the denominator is clamped), where
    the exact path gives NaN."""
    d = _inputs(17, 256, 16, 1, 32, 8, n_valid=0)
    (ref, ref_u), (out, usage) = _both_approx(d, 8)
    assert not np.isnan(out).any() and (out == 0).all()
    np.testing.assert_array_equal(out, ref)
    assert (usage == 0).all() and (ref_u == 0).all()


def test_attend_approx_no_qe():
    d = _inputs(14, 120, 40, 1, 16, 8)
    (ref, _), (out, _) = _both_approx(d, 10, with_ms=False, with_qe=False)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    ex, _ = _exact(d, 10, with_ms=False, with_qe=False)
    np.testing.assert_allclose(out, ex, rtol=1e-5, atol=1e-5)


def test_attend_approx_multi_ring_equals_concat():
    """Two rings equal their concatenation, with per-ring usage, and match
    deva_tpu's multi-ring kernel."""
    rng = np.random.default_rng(16)
    ck, cv, o, k = 32, 16, 2, 8
    n1, n2, q = 512, 768, 200
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    mk1, mk2, ms1, ms2 = f(n1, ck), f(n2, ck), u(1, 3, n1), u(1, 3, n2)
    v1, v2 = f(n1, o, cv), f(n2, o, cv)
    valid1, valid2 = np.arange(n1) < 300, np.arange(n2) < 700
    qk, qe = f(q, ck), u(0, 1, q, ck)

    ref, (ru1, ru2) = pa.attend_pallas_approx_multi(
        [tuple(map(_j, (mk1, ms1, v1, valid1))),
         tuple(map(_j, (mk2, ms2, v2, valid2)))], _j(qk), _j(qe), k,
        return_usage=True, n_tile=512, interpret=True)
    out_m, (u1, u2) = apx.attend_approx_multi(
        [tuple(map(_t, (mk1, ms1, v1, valid1))),
         tuple(map(_t, (mk2, ms2, v2, valid2)))], _t(qk), _t(qe), k,
        return_usage=True, n_tile=512)
    out_c, u_c = apx.attend_approx(
        _t(np.concatenate([mk1, mk2])), _t(np.concatenate([ms1, ms2])),
        _t(np.concatenate([v1, v2])), _t(qk), _t(qe), k,
        valid=_t(np.concatenate([valid1, valid2])), return_usage=True,
        n_tile=512)
    np.testing.assert_allclose(out_m.numpy(), out_c.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(u1.numpy(), u_c.numpy()[:n1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(u2.numpy(), u_c.numpy()[n1:], rtol=1e-5,
                               atol=1e-6)
    assert np.isclose(u1.sum().item() + u2.sum().item(), q, rtol=1e-4)
    np.testing.assert_allclose(out_m.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(u1.numpy(), np.asarray(ru1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(u2.numpy(), np.asarray(ru2), rtol=1e-4,
                               atol=1e-4)


def test_attend_approx_multi_plain_is_the_cpu_route():
    """On the CPU the dispatching composite and its plain twin are one
    computation."""
    d = _inputs(18, 900, 60, 2, 64, 16, n_valid=800)
    rings = [(_t(d["mk"][:300]), _t(d["ms"][:300]), _t(d["values"][:300]),
              None),
             (_t(d["mk"][300:]), _t(d["ms"][300:]), _t(d["values"][300:]),
              _t(d["valid"][300:]))]
    a, ua = apx.attend_approx_multi(rings, _t(d["qk"]), _t(d["qe"]), 16,
                                    return_usage=True)
    b, ub = apx.attend_approx_multi_plain(rings, _t(d["qk"]), _t(d["qe"]),
                                          16, return_usage=True)
    assert torch.equal(a, b) and all(torch.equal(x, y)
                                     for x, y in zip(ua, ub))


@pytest.mark.parametrize("n,n_valid", [(600, 500), (100, None), (400, 20)])
def test_dense_approx_topk_softmax_matches(n, n_valid):
    """topk_softmax(method='approx'), the composed path's dense threshold
    form, against deva_tpu's (approx_max_k is exact on the CPU). n=100 with
    k=30 is below 4k: the exact branch."""
    d = _inputs(19, n, 50, 1, 64, 8, n_valid=n_valid)
    jsim = jma.get_similarity(_j(d["mk"]), _j(d["ms"]), _j(d["qk"]),
                              _j(d["qe"]))
    ref, ref_u = jma.topk_softmax(jsim, 30, _j(d["valid"]),
                                  return_usage=True, method="approx")
    aff, usage = tma.topk_softmax(_t(np.asarray(jsim)), 30, _t(d["valid"]),
                                  return_usage=True, method="approx")
    np.testing.assert_allclose(aff.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(usage.numpy(), np.asarray(ref_u), rtol=1e-5,
                               atol=1e-6)


def test_match_memory_approx_matches_deva_tpu():
    """The composed path with topk_method='approx' (the dense threshold
    form, deva_tpu's memory.py:_bucket_attend{,_with_long}): two memory
    buckets and long-term consolidation, fed the same tokens."""
    from deva_tpu.config import InferenceConfig as JaxInferenceConfig
    from deva_tpu.inference.memory import MemoryEngine as JaxMemoryEngine

    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.memory import MemoryEngine

    hw, ck, cv, o_cap = 40, 16, 8, 4
    cfg = dict(top_k=6, enable_long_term=True,
               enable_long_term_count_usage=True, max_mid_term_frames=3,
               min_mid_term_frames=1, num_prototypes=8,
               max_long_term_elements=64, topk_method="approx")
    ref = JaxMemoryEngine(JaxInferenceConfig(**cfg), cv, ck, cv, o_cap)
    ours = MemoryEngine(InferenceConfig(**cfg), cv, ck, cv, o_cap,
                        device="cpu")
    rng = np.random.default_rng(22)
    objects = [1, 2]
    for ti in range(8):
        if ti == 3:
            objects = [1, 2, 3]
        rows = {o: i for i, o in enumerate(objects)}
        if ti > 0:
            qk = rng.standard_normal((hw, ck)).astype(np.float32)
            qe = rng.uniform(0, 1, (hw, ck)).astype(np.float32)
            r = np.asarray(ref.match_memory(jnp.asarray(qk), jnp.asarray(qe),
                                            rows))
            o = ours.match_memory(torch.from_numpy(qk), torch.from_numpy(qe),
                                  rows).numpy()
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4,
                                       err_msg=f"frame {ti}")
        frame = dict(
            key=rng.standard_normal((hw, ck)).astype(np.float32),
            shrinkage=rng.uniform(1, 2, (hw,)).astype(np.float32),
            value=rng.standard_normal((o_cap, hw, cv)).astype(np.float32),
            selection=rng.uniform(0, 1, (hw, ck)).astype(np.float32))
        ref.add_memory(obj_ids=objects,
                       **{k: jnp.asarray(v) for k, v in frame.items()})
        ours.add_memory(obj_ids=objects,
                        **{k: torch.from_numpy(v) for k, v in frame.items()})
    assert len(ours.buckets) == 2 and ours.long_buckets
    for b in ours.buckets:
        np.testing.assert_allclose(
            ours.buckets[b].use_cnt.numpy(),
            np.asarray(ref.buckets[b].use_cnt), rtol=1e-4, atol=1e-4)


def test_gap_threshold_keeps_the_support_clear_of_rounding():
    """approx_kernels.gap_threshold, which the card checks of denom_readout
    use: at or below th, no similarity within eps of it where a gap exists
    (so a rounding of eps cannot move an entry across), th itself in a row
    with no gap."""
    rng = np.random.default_rng(23)
    sim = torch.from_numpy(rng.standard_normal((40, 300)).astype(np.float32))
    sim[-1] = torch.arange(300, dtype=torch.float32) * 1e-4  # no wide gap
    th = torch.topk(sim, 30, dim=-1).values[:, -1:]
    eps = 1e-3
    g = apx.gap_threshold(sim, th, eps)
    assert bool((g <= th).all())  # the support only grows
    near = ((sim - g).abs() <= eps).any(-1)
    assert not bool(near[:-1].any())
    assert g[-1].item() == th[-1].item()
