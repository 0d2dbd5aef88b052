"""deva_tpu_torch/parallel/sharded_attention.py: the memory-axis sharded
attention on 2 and 4 gloo ranks against deva_tpu's attend_mem_sharded on a
4-device slice of the virtual CPU devices that conftest.py forces, and
against deva_tpu's unsharded attend. The cases mirror
tests/test_sharded_attention.py: pad_tokens, exact against unsharded (with
usage), ms and qe dropped, and the approx drift bounded.

Tolerances: outputs within 1e-5 (absolute and relative) of deva_tpu's
sharded and unsharded ones, usage within 1e-4 relative and 1e-5 absolute,
as tests/test_sharded_attention.py holds deva_tpu's to its unsharded form
(sums in another order: the all_reduce, the readout kernel's twin); every
rank holds the same output, and the invalid and padding tokens never take
usage. The approx method keeps its drift from the exact readout within
2e-3 of the largest output, the budget of the unsharded approx path.
"""
import jax
import numpy as np
import pytest
import torch

import torch_parallel_common as C

from deva_tpu_torch.parallel.sharded_attention import pad_tokens


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("att")
    return {w: C.spawn(w, "attention", tmp) for w in (2, 4)}


def _deva_tpu(run: str, sharded: bool, method=None):
    """deva_tpu's output (and usage) for one of C.ATT_RUNS (its inputs, and
    its method unless `method` is given): its attend_mem_sharded over 4 of
    the virtual devices, or its unsharded attend."""
    import jax.numpy as jnp
    from deva_tpu.ops import memory_attention as ma
    from deva_tpu.parallel import sharded_attention as jsa
    from deva_tpu.parallel.mesh import make_mesh
    run_method, drop, seed = C.ATT_RUNS[run]
    method = method or run_method
    n = jsa.pad_tokens(C.ATT_N, 4) if sharded else C.ATT_N
    mk, ms, v, qk, qe, valid = (jnp.asarray(a) for a in
                                C.att_inputs(seed, n))
    ms = None if drop == "ms" else ms
    qe = None if drop == "qe" else qe
    usage = drop is None
    if sharded:
        res = jsa.attend_mem_sharded(
            mk, ms, v, qk, qe, C.ATT_K, valid,
            make_mesh(4, 1, devices=jax.devices()[:4]), method=method,
            return_usage=usage)
    else:
        res = ma.attend(mk, ms, v, qk, qe, top_k=C.ATT_K, valid=valid,
                        method=method, return_usage=usage)
    out, u = res if usage else (res, None)
    return np.asarray(out), None if u is None else np.asarray(u)[:C.ATT_N]


def _port(ranks, run):
    """The ranks' output (checked equal on every rank) and the whole usage
    (the shards in order, padding cut)."""
    outs = [r[run][0].numpy() for r in ranks]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    u = ranks[0][run][1]
    usage = None if u is None else \
        torch.cat([r[run][1] for r in ranks]).numpy()
    return outs[0], usage


def test_pad_tokens():
    from deva_tpu.parallel.sharded_attention import pad_tokens as jpad
    for n, d in ((1000, 8), (1001, 8), (8, 8), (1001, 2), (16712, 2)):
        assert pad_tokens(n, d) == jpad(n, d)
    assert pad_tokens(1001, 4) == 1004


@pytest.mark.parametrize("world", [2, 4])
def test_exact_matches_deva_tpu(runs, world):
    out, usage = _port(runs[world], "exact")
    for sharded in (True, False):
        ref, u_ref = _deva_tpu("exact", sharded)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(usage[:C.ATT_N], u_ref, rtol=1e-4,
                                   atol=1e-5)
    # every affinity row sums to 1; invalid and padding tokens never chosen
    assert np.isclose(usage.sum(), C.ATT_Q, rtol=1e-5)
    assert np.all(usage[C.ATT_VALID:] == 0.0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("drop", ["ms", "qe"])
def test_optional_args(runs, world, drop):
    out, _ = _port(runs[world], "no_" + drop)
    for sharded in (True, False):
        ref, _ = _deva_tpu("no_" + drop, sharded)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_approx_drift_bounded(runs, world):
    """The approx method takes the exact route of the port (deva_tpu's
    approx_max_k is exact off the TPU): it equals deva_tpu's sharded approx
    output, and drifts from the exact readout within the unsharded approx
    path's budget."""
    out, _ = _port(runs[world], "approx")
    ref, _ = _deva_tpu("approx", True)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    exact, _ = _deva_tpu("approx", False, method="exact")
    scale = np.abs(exact).max()
    assert np.abs(out - exact).max() <= 2e-3 * scale
