"""The video axis of deva_tpu_torch's attention functions (ops/
attention_kernels.py, ops/approx_kernels.py), on the CPU: B videos at once,
each with its own rings, as the batched propagator calls them.

1. Each function batched equals the stack of its per-video calls: indices
   equal, floats within 1e-6 (the twins run batched matrix products, which
   may sum in another order than the 2-D ones).
2. The batched composites equal jax.vmap of deva_tpu's attend_pallas and
   attend_pallas_approx_multi in interpret mode (the counterpart of
   deva_tpu's vmapped step), at the tolerances tests/test_torch_attention.py,
   tests/test_torch_approx.py and tests/test_torch_amp.py use for the
   single-video forms.
Cases: B=3 videos with different validity, one of them with an all-invalid
long-term segment, on f32 and on bf16 rings. The CUDA kernels' video axis is
held to per-video launches on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deva_tpu.ops import pallas_attention as pa

from deva_tpu_torch.ops import approx_kernels as apx
from deva_tpu_torch.ops import attention_kernels as ak

torch.set_num_threads(2)

B, Q, CK, O, CV, K = 3, 60, 32, 2, 16, 8
N_LT, N_WORK = 128, 640
N = N_LT + N_WORK
# valid tokens per video: [long-term ; working]; video 1's long-term
# segment is all invalid, as when eviction left one video without tokens
LT_VALID, WORK_VALID = (100, 0, 128), (500, 640, 320)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _rings(seed, ring):
    """Seeded numpy inputs, the rings rounded to `ring` ('f32' or 'bf16')."""
    rng = np.random.default_rng(seed)
    rnd = (lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)) \
        if ring == "bf16" else (lambda a: a)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    valid = np.stack([np.concatenate([np.arange(N_LT) < a,
                                      np.arange(N_WORK) < b])
                      for a, b in zip(LT_VALID, WORK_VALID)])
    return dict(mk=rnd(f(B, N, CK)), ms=rnd(u(1, 4, B, N)),
                values=rnd(f(B, N, O, CV)), qk=f(B, Q, CK),
                qe=u(0, 1, B, Q, CK), valid=valid)


def _torch(d, ring):
    """The inputs as tensors: rings in the ring dtype, queries f32."""
    dt = DTYPES[ring]
    return (torch.from_numpy(d["mk"]).to(dt), torch.from_numpy(d["ms"]).to(dt),
            torch.from_numpy(d["values"]).to(dt), torch.from_numpy(d["qk"]),
            torch.from_numpy(d["qe"]), torch.from_numpy(d["valid"]))


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _stack(fn, *args):
    """fn on each video's slice of args (tuples are sliced elementwise),
    results stacked per output."""
    def video(a, v):
        if isinstance(a, tuple):
            return tuple(video(x, v) for x in a)
        return a[v] if isinstance(a, torch.Tensor) else a
    outs = [fn(*(video(a, v) for a in args)) for v in range(B)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack([o[i] for o in outs])
                 for i in range(len(outs[0])))


@pytest.mark.parametrize("ring", ["f32", "bf16"])
def test_sim_topk_batched_is_the_stack_of_videos(ring):
    mk, ms, _, qk, qe, valid = _torch(_rings(1, ring), ring)
    gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, K)
    assert gv.shape == gi.shape == (B, Q, K) and gi.dtype == torch.int32
    rv, ri = _stack(lambda *a: ak.sim_topk(*a, K), qk, qe, mk, ms, valid)
    assert torch.equal(gi, ri)
    _close(gv, rv)
    # the video with an all-invalid long-term segment selects working
    # tokens only; every index is in range
    assert int(gi[1].min()) >= N_LT and int(gi.max()) < N


@pytest.mark.parametrize("ring", ["f32", "bf16"])
@pytest.mark.parametrize("segments", [1, 2])
def test_topk_readout_batched_is_the_stack_of_videos(ring, segments):
    mk, ms, values, qk, qe, valid = _torch(_rings(2, ring), ring)
    gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, K)
    w = torch.softmax(gv, dim=-1)
    v2 = values.reshape(B, N, O * CV)
    ring_arg = v2 if segments == 1 else (v2[:, :N_LT], v2[:, N_LT:])
    out = ak.topk_readout(gi, w, ring_arg)
    assert out.shape == (B, Q, O * CV)
    _close(out, _stack(ak.topk_readout, gi, w, ring_arg))
    if segments == 2:  # read in place: bitwise the one-segment call
        assert torch.equal(out, ak.topk_readout(gi, w, v2))


@pytest.mark.parametrize("ring", ["f32", "bf16"])
@pytest.mark.parametrize("segments", [1, 2])
def test_attend_topk_batched_is_the_stack_of_videos(ring, segments):
    mk, ms, values, qk, qe, valid = _torch(_rings(3, ring), ring)
    v_arg = values if segments == 1 else (values[:, :N_LT], values[:, N_LT:])
    out, usage = ak.attend_topk(mk, ms, v_arg, qk, qe, K, valid,
                                return_usage=True)
    assert out.shape == (B, O, Q, CV) and usage.shape == (B, N)
    ref_out, ref_usage = _stack(
        lambda m, s, v, q, e, ok: ak.attend_topk(m, s, v, q, e, K, ok,
                                                 return_usage=True),
        mk, ms, v_arg, qk, qe, valid)
    _close(out, ref_out)
    _close(usage, ref_usage)
    # each video's usage is its own: Q weights summed over its valid tokens
    _close(usage.sum(-1), torch.full((B,), float(Q)), 1e-4)
    assert float(usage[1, :N_LT].abs().sum()) == 0.0


def _ops(ring, seed=4):
    mk, ms, values, qk, qe, valid = _torch(_rings(seed, ring), ring)
    return apx.prep2(qk, qe, mk, ms, valid), values.reshape(B, N, O * CV)


@pytest.mark.parametrize("ring", ["f32", "bf16"])
def test_segmax_and_denom_readout_batched_are_the_stack_of_videos(ring):
    ops, v2 = _ops(ring)
    geom = apx.Geometry.of(N, 512)
    assert geom.group == 4  # groups of 4 tokens occur
    seg = apx.segmax(ops, geom)
    assert seg.shape == (B, Q, geom.nseg)
    per_video = lambda v: ops._replace(**{
        f: getattr(ops, f)[v] for f in ops._fields
        if getattr(ops, f) is not None})
    ref_seg = torch.stack([apx.segmax(per_video(v), geom) for v in range(B)])
    fin = torch.isfinite(ref_seg)
    assert torch.equal(torch.isfinite(seg), fin)
    _close(seg[fin], ref_seg[fin])

    out, usage, rmax, th = apx.denom_readout(ops, geom, seg, v2, K)
    assert out.shape == (B, Q, O * CV) and usage.shape == (B, N)
    assert rmax.shape == th.shape == (B, Q, 1)
    for v in range(B):
        o_v, u_v, r_v, t_v = apx.denom_readout(per_video(v), geom, seg[v],
                                               v2[v], K)
        _close(out[v], o_v)
        _close(usage[v], u_v)
        assert torch.equal(rmax[v], r_v) and torch.equal(th[v], t_v)
    # no weight lands on video 1's all-invalid long-term segment
    assert float(usage[1, :N_LT].abs().sum()) == 0.0


@pytest.mark.parametrize("ring", ["f32", "bf16"])
def test_attend_approx_multi_batched_is_the_stack_of_videos(ring):
    mk, ms, values, qk, qe, valid = _torch(_rings(5, ring), ring)
    rings = [(mk[:, :N_LT], ms[:, :N_LT], values[:, :N_LT], valid[:, :N_LT]),
             (mk[:, N_LT:], ms[:, N_LT:], values[:, N_LT:], valid[:, N_LT:])]
    out, (u_lt, u_work) = apx.attend_approx_multi(rings, qk, qe, K,
                                                  return_usage=True,
                                                  n_tile=512)
    assert out.shape == (B, O, Q, CV)
    assert u_lt.shape == (B, N_LT) and u_work.shape == (B, N_WORK)
    for v in range(B):
        o_v, (ul_v, uw_v) = apx.attend_approx_multi(
            [tuple(t[v] for t in r) for r in rings], qk[v], qe[v], K,
            return_usage=True, n_tile=512)
        _close(out[v], o_v)
        _close(u_lt[v], ul_v)
        _close(u_work[v], uw_v)
    assert float(u_lt[1].abs().sum()) == 0.0


def _jax(d, ring):
    jdt = jnp.bfloat16 if ring == "bf16" else jnp.float32
    return (jnp.asarray(d["mk"], jdt), jnp.asarray(d["ms"], jdt),
            jnp.asarray(d["values"], jdt), jnp.asarray(d["qk"]),
            jnp.asarray(d["qe"]), jnp.asarray(d["valid"]))


@pytest.mark.parametrize("ring", ["f32", "bf16"])
def test_attend_topk_batched_matches_vmap_attend_pallas(ring):
    """Against jax.vmap of attend_pallas (interpret mode): out within 1e-4
    and usage within 1e-5 on f32 rings (tests/test_torch_attention.py);
    out within 1e-5 on bf16 rings, where both round the weights to bf16
    before the product (tests/test_torch_amp.py)."""
    d = _rings(6, ring)
    ref, ref_u = jax.vmap(lambda mk, ms, v, qk, qe, valid: pa.attend_pallas(
        mk, ms, v, qk, qe, K, valid, return_usage=True, interpret=True))(
        *_jax(d, ring))
    mk, ms, values, qk, qe, valid = _torch(d, ring)
    out, usage = ak.attend_topk(mk, ms, (values[:, :N_LT], values[:, N_LT:]),
                                qk, qe, K, valid, return_usage=True)
    tol = 1e-4 if ring == "f32" else 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(usage.numpy(), np.asarray(ref_u), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("ring", ["f32", "bf16"])
def test_attend_approx_multi_batched_matches_vmap_pallas(ring):
    """Against jax.vmap of attend_pallas_approx_multi over [long-term ;
    working] (interpret mode, exact threshold there): f32 out and usage
    within 1e-4 (tests/test_torch_approx.py); bf16 out within 1e-5 on 99%
    and within one bf16 ulp of the weights (2^-7 * sum aff |V|) everywhere,
    usage within 1e-4 (tests/test_torch_amp.py)."""
    d = _rings(7, ring)
    jm, js, jv, jqk, jqe, jvalid = _jax(d, ring)
    cut = lambda a, lo, hi: a[:, lo:hi]

    def ref_fn(m, s, v, qk, qe, valid):
        return pa.attend_pallas_approx_multi(
            [(m[:N_LT], s[:N_LT], v[:N_LT], valid[:N_LT]),
             (m[N_LT:], s[N_LT:], v[N_LT:], valid[N_LT:])], qk, qe, K,
            return_usage=True, n_tile=512, interpret=True)

    ref, (ref_lt, ref_work) = jax.vmap(ref_fn)(jm, js, jv, jqk, jqe, jvalid)
    mk, ms, values, qk, qe, valid = _torch(d, ring)
    rings = [tuple(cut(t, 0, N_LT) for t in (mk, ms, values, valid)),
             tuple(cut(t, N_LT, N) for t in (mk, ms, values, valid))]
    out, (u_lt, u_work) = apx.attend_approx_multi(rings, qk, qe, K,
                                                  return_usage=True,
                                                  n_tile=512)
    ref = np.asarray(ref)
    for u, r in ((u_lt, ref_lt), (u_work, ref_work)):
        np.testing.assert_allclose(u.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4 if ring == "f32" else 1e-5)
    if ring == "f32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
        return
    diff = np.abs(out.numpy() - ref)
    assert (diff <= 1e-5 + 1e-5 * np.abs(ref)).mean() >= 0.99
    ops = apx.prep2(qk, qe, mk, ms, valid)
    geom = apx.Geometry.of(N, 512)
    rmax, th = apx.threshold(apx.segmax_plain(ops, geom), K)
    aff = apx._support_weights(apx.similarity2_plain(ops), rmax, th)
    bound = 2.0 ** -7 * torch.einsum("bqn,bnoc->boqc", aff,
                                     values.float().abs()) + 1e-5
    assert bool((torch.from_numpy(diff) <= bound).all())


def test_plan_counts_the_video_tiles():
    """sim_topk's split plan counts B times the query tiles, so a batch
    needs fewer splits of the token axis (the result does not depend on
    the plan: the kernel is bitwise under every split plan)."""
    one = ak._sim_topk_plan(1620, 16712, 30, 132)
    four = ak._sim_topk_plan(1620, 16712, 30, 132, videos=4)
    assert ak._sim_topk_plan(1620, 16712, 30, 132, videos=1) == one
    assert four[0] < one[0]
    for splits, split_len in (one, four):
        assert splits * split_len >= 16712 > (splits - 1) * split_len


def test_wrappers_reject_mismatched_video_axes():
    """The CUDA wrappers check every operand's video axis before they build
    anything (so these run on the CPU)."""
    q, n, ck = 4, 40, 8
    qk = torch.zeros((2, q, ck))
    with pytest.raises(ValueError):
        ak._sim_topk_cuda(qk, None, torch.zeros((3, n, ck)), None, None, 4)
    with pytest.raises(ValueError):
        ak._sim_topk_cuda(qk, None, torch.zeros((n, ck)), None, None, 4)
    idx = torch.zeros((2, q, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ak._topk_readout_cuda(idx, torch.zeros((2, q, 3)),
                              torch.zeros((3, n, 16)))
    ops = apx.prep2(qk, qk.abs(), torch.zeros((2, n, ck)), None, None)
    geom = apx.Geometry.of(n, 512)
    with pytest.raises(ValueError):
        apx._segmax_cuda(ops._replace(msv=torch.zeros((n,))), geom)
    seg = apx.segmax_plain(ops, geom)
    with pytest.raises(ValueError):
        apx._denom_readout_cuda(ops, geom, seg[0], torch.zeros((2, n, 16)),
                                4)
