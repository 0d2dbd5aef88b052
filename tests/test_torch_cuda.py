"""The CUDA kernels of deva_tpu_torch against their plain PyTorch twins, on
the card. Every test here needs a CUDA device and skips without one; on a
machine with a card run them with

    python -m pytest tests/test_torch_cuda.py -q

The file imports nothing of JAX, so it also runs where JAX is not installed.
Tolerances: similarity values and group maxima 1e-5 and < 0.1% index
mismatches (the bounds of tests/test_pallas_attention.py: the kernel sums in
another order than the matmul of the plain version, so near-ties may swap);
readout and usage 1e-4 (f32 sums in another order). The approx readout is
compared at a threshold that no similarity lies near, so both sides keep the
same support. On bf16 rings each kernel is held to its f32 launch on the
widened ring with the relation its design gives: bitwise for sim_topk,
topk_readout (with the weights rounded to bf16) and segmax; for
denom_readout, rmax and th bitwise, usage within f32 atomics noise, and the
output within the bf16 rounding of its normalised weights.
"""
import numpy as np
import pytest
import torch

from deva_tpu_torch import detection_clips as dc
from deva_tpu_torch.ops import approx_kernels as apx
from deva_tpu_torch.ops import attention_kernels as ak

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # true f32 matmuls and convolutions, as chip_smoke.py and the drivers
    # run them (the card-vs-CPU tests of the slice need them)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _inputs(dev, seed, n, q, ck=64, n_valid=None, with_qe=True,
            with_ms=True):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    mk = t(rng.standard_normal((n, ck)))
    ms = t(rng.uniform(1, 4, (n,))) if with_ms else None
    qk = t(rng.standard_normal((q, ck)))
    qe = t(rng.uniform(0, 1, (q, ck))) if with_qe else None
    valid = None if n_valid is None else \
        torch.arange(n, device=dev) < n_valid
    return qk, qe, mk, ms, valid


@pytest.mark.parametrize("n,q,k", [(700, 130, 12), (2000, 300, 30),
                                   (150, 40, 30), (16712, 1620, 30)])
def test_sim_topk_kernel_matches_plain(dev, n, q, k):
    qk, qe, mk, ms, valid = _inputs(dev, 2, n, q, n_valid=n - n // 8)
    ref_v, ref_i = ak.sim_topk_plain(qk, qe, mk, ms, valid, k)
    gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, k)
    torch.cuda.synchronize()
    torch.testing.assert_close(gv, ref_v, rtol=1e-5, atol=1e-5)
    mism = (gi != ref_i).float().mean().item()
    assert mism < 1e-3, f"index mismatch share {mism}"


def test_sim_topk_kernel_ties_resolve_to_lowest_index(dev):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((10, 16)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (300, 1))).to(dev)  # 3000 tokens
    qk = torch.from_numpy(
        rng.standard_normal((70, 16)).astype(np.float32)).to(dev)
    ref_v, ref_i = ak.sim_topk_plain(qk, None, mk, None, None, 20)
    gv, gi = ak.sim_topk(qk, None, mk, None, None, 20)
    torch.testing.assert_close(gv, ref_v, rtol=1e-6, atol=1e-6)
    assert torch.equal(gi, ref_i)


def test_sim_topk_kernel_fewer_valid_than_k(dev):
    qk, qe, mk, ms, valid = _inputs(dev, 4, 256, 64, ck=32, n_valid=5)
    ref_v, ref_i = ak.sim_topk_plain(qk, qe, mk, ms, valid, 12)
    gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, 12)
    torch.testing.assert_close(gv, ref_v, rtol=1e-5, atol=1e-5)
    assert torch.isinf(gv[:, 5:]).all()
    assert torch.equal(gi, ref_i)  # -inf slots: lowest invalid indices
    assert int(gi.max()) < 256


def _readout_inputs(dev, seed, q, n, c, k):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(
        rng.integers(0, n, (q, k)).astype(np.int32)).to(dev)
    w = rng.uniform(0, 1, (q, k)).astype(np.float32)
    w = torch.from_numpy(w / w.sum(-1, keepdims=True)).to(dev)
    values = torch.from_numpy(
        rng.standard_normal((n, c)).astype(np.float32)).to(dev)
    return idx, w, values


@pytest.mark.parametrize("q,n,c,k", [(256, 512, 128, 16), (1620, 16712,
                                                           1024, 30),
                                     (33, 100, 30, 7), (1620, 16712, 1536, 30),
                                     (100, 700, 1030, 64), (17, 3, 4, 1)])
def test_topk_readout_kernel_matches_plain(dev, q, n, c, k):
    idx, w, values = _readout_inputs(dev, 0, q, n, c, k)
    out = ak.topk_readout(idx, w, values)
    torch.testing.assert_close(out, ak.topk_readout_plain(idx, w, values),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c", [1024, 1536, 30, 1030])
def test_topk_readout_two_segments_bitwise_one(dev, c):
    """The ring as two segments, split at 0, 512 (the long-term ring), 513
    (for C=30, segment B starts off a 16-byte boundary), N - 1 and N, and
    split at 512 with segment B copied to a base 4 bytes past alignment
    (the scalar path at any C), is bitwise the single-segment call on the
    concatenated ring."""
    idx, w, values = _readout_inputs(dev, 24, 1620, 3000, c, 30)
    one = ak.topk_readout(idx, w, values)
    shifted = torch.empty(2488 * c + 1, device=dev)[1:].view(2488, c)
    shifted.copy_(values[512:])
    assert shifted.data_ptr() % 16 != 0
    for seg_a, seg_b in [(values[:at], values[at:])
                         for at in (0, 512, 513, 2999, 3000)] + \
            [(values[:512], shifted)]:
        two = ak.topk_readout(idx, w, (seg_a, seg_b))
        torch.cuda.synchronize()
        assert torch.equal(_bits(one), _bits(two)), (c, seg_a.shape[0])
    torch.testing.assert_close(one, ak.topk_readout_plain(idx, w, values),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["all_distinct", "all_shared", "duplicates",
                                  "out_of_range"])
def test_topk_readout_kernel_tiles(dev, case):
    """Tiles whose k*16 rows are all distinct (past the shared rows: the
    overflow reads from global memory), all the same k rows, repeated within
    a query, and indices outside the ring (they contribute nothing)."""
    q, k, n, c = 100, 30, 4000, 1024
    idx, w, values = _readout_inputs(dev, 25, q, n, c, k)
    if case == "all_distinct":
        idx = torch.randperm(n, device=dev)[:q * k].reshape(q, k).int()
    elif case == "all_shared":
        idx = idx[:1].expand(q, k).contiguous()
    elif case == "duplicates":
        idx[:, k // 2:] = idx[:, :k - k // 2].clone()
        idx[3] = idx[3, 0]
    else:
        idx[::3, ::4] = -1
        idx[1, :3] = torch.tensor([n, n + 9, -5], dtype=torch.int32)
    out = ak.topk_readout(idx, w, (values[:512], values[512:]))
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ak.topk_readout_plain(idx, w, values),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [1, 24, 29])
def test_sim_topk_ring_smaller_than_k(dev, n):
    """A ring of fewer tokens than top_k=30 selects all n, as the twin."""
    qk, qe, mk, ms, _ = _inputs(dev, 26, n, 16)
    values = torch.randn((n, 2, 8), device=dev)
    gv, gi = ak.sim_topk(qk, qe, mk, ms, None, 30)
    ref_v, ref_i = ak.sim_topk_plain(qk, qe, mk, ms, None, 30)
    torch.cuda.synchronize()
    assert gv.shape == (16, n)
    torch.testing.assert_close(gv, ref_v, rtol=1e-5, atol=1e-5)
    assert torch.equal(gi, ref_i)
    out, usage = ak.attend_topk(mk, ms, values, qk, qe, 30,
                                return_usage=True)
    ref, ref_usage = ak.attend_topk_plain(mk, ms, values, qk, qe, 30,
                                          return_usage=True)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(usage, ref_usage, rtol=1e-4, atol=1e-5)


def test_attend_topk_two_rings_launches_two_kernels(dev):
    """The [long-term ; working] value rings as a pair: one sim_topk and one
    topk_readout launch; the readout bitwise the one on the concatenated
    ring, the usage within rounding (index_add_'s atomics add in any
    order)."""
    qk, qe, mk, ms, valid = _inputs(dev, 27, 1300, 300, n_valid=1100)
    values = torch.randn((1300, 2, 32), device=dev)
    pair = (values[:512].contiguous(), values[512:].contiguous())
    ak.reset_launch_counts()
    out, usage = ak.attend_topk(mk, ms, pair, qk, qe, 12, valid,
                                return_usage=True)
    assert ak.LAUNCHES == {"sim_topk": 1, "topk_readout": 1, "segmax": 0,
                           "denom_readout": 0}
    ref, ref_usage = ak.attend_topk(mk, ms, values, qk, qe, 12, valid,
                                    return_usage=True)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(ref))
    torch.testing.assert_close(usage, ref_usage, rtol=1e-5, atol=1e-6)


def test_attend_topk_kernels_match_plain(dev):
    qk, qe, mk, ms, valid = _inputs(dev, 1, 700, 300, n_valid=600)
    rng = np.random.default_rng(5)
    values = torch.from_numpy(
        rng.standard_normal((700, 3, 32)).astype(np.float32)).to(dev)
    ak.reset_launch_counts()
    out, usage = ak.attend_topk(mk, ms, values, qk, qe, 12, valid,
                                return_usage=True)
    assert ak.LAUNCHES == {"sim_topk": 1, "topk_readout": 1, "segmax": 0,
                           "denom_readout": 0}
    ref, ref_usage = ak.attend_topk_plain(mk, ms, values, qk, qe, 12, valid,
                                          return_usage=True)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(usage, ref_usage, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_qe", [True, False])
@pytest.mark.parametrize("k", [1, 30, 32, 33, 64])
def test_sim_topk_kernel_matches_plain_at_k(dev, k, with_qe):
    """k on both sides of a lane's two list entries (32) and at the bound,
    with and without a selection; Q and N are not multiples of the tiles."""
    qk, qe, mk, ms, valid = _inputs(dev, 13, 1000, 100, n_valid=900,
                                    with_qe=with_qe)
    ref_v, ref_i = ak.sim_topk_plain(qk, qe, mk, ms, valid, k)
    gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, k)
    torch.cuda.synchronize()
    torch.testing.assert_close(gv, ref_v, rtol=1e-5, atol=1e-5)
    mism = (gi != ref_i).float().mean().item()
    assert mism < 1e-3, f"index mismatch share {mism}"


@pytest.mark.parametrize("n,q,k", [(65, 1, 30), (1, 65, 1), (130, 127, 64),
                                   (4033, 70, 30)])
def test_sim_topk_kernel_ragged_shapes(dev, n, q, k):
    """A ring of one token past a tile, of one token, and rows past a query
    tile: the partial tiles take no part and every row is right."""
    qk, qe, mk, ms, valid = _inputs(dev, 14, n, q)
    ref_v, ref_i = ak.sim_topk_plain(qk, qe, mk, ms, valid, k)
    gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, k)
    torch.cuda.synchronize()
    torch.testing.assert_close(gv, ref_v, rtol=1e-5, atol=1e-5)
    mism = (gi != ref_i).float().mean().item()
    assert mism < 1e-3, f"index mismatch share {mism}"
    assert int(gi.min()) >= 0 and int(gi.max()) < n


def test_sim_topk_kernel_result_does_not_depend_on_the_plan(dev):
    """One split against the most splits, on a ring of 100 tokens copied 30
    times: every tie crosses split boundaries, and both plans give bitwise
    the same values and indices, with ties to the lowest index."""
    rng = np.random.default_rng(15)
    base = rng.standard_normal((100, 64)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (30, 1))).to(dev)  # 3000 tokens
    ms = torch.from_numpy(np.tile(rng.uniform(1, 4, 100).astype(np.float32),
                                  30)).to(dev)
    qk, qe, _, _, _ = _inputs(dev, 16, 10, 200)
    n_tiles = -(-3000 // ak.NT)
    most_len = -(-n_tiles // ak.MAX_SPLITS) * ak.NT
    plans = [(1, n_tiles * ak.NT), (-(-3000 // most_len), most_len)]
    assert plans[1][0] > 20
    (v1, i1), (v2, i2) = [ak._sim_topk_cuda(qk, qe, mk, ms, None, 45,
                                            plan=plan) for plan in plans]
    torch.cuda.synchronize()
    assert torch.equal(v1, v2) and torch.equal(i1, i2)
    assert torch.equal(i1, ak.sim_topk_plain(qk, qe, mk, ms, None, 45)[1])


def test_sim_topk_is_two_device_kernels(dev):
    """One call runs the selection and the merge kernel and no other device
    work (the preparation is inside the kernel)."""
    from torch.profiler import ProfilerActivity, profile
    qk, qe, mk, ms, valid = _inputs(dev, 17, 5000, 300, n_valid=4000)
    ak.sim_topk(qk, qe, mk, ms, valid, 30)  # build and load first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ak.sim_topk(qk, qe, mk, ms, valid, 30)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert len(names) == 2, names
    assert "sim_topk_split_kernel" in names[0], names
    assert "sim_topk_merge_kernel" in names[1], names


def test_kernels_reject_what_they_do_not_take(dev):
    qk, qe, mk, ms, valid = _inputs(dev, 6, 300, 10)
    with pytest.raises(ValueError):
        ak.sim_topk(qk, qe, mk, ms, valid, 65)  # k above the kernel bound
    with pytest.raises(ValueError):
        ak.sim_topk(qk, qe, mk.cpu(), ms, valid, 8)  # mixed devices
    with pytest.raises(TypeError):
        ak.sim_topk(qk.double(), qe, mk, ms, valid, 8)
    with pytest.raises(RuntimeError):  # a plan that does not cover N
        ak._sim_topk_cuda(qk, qe, mk, ms, valid, 8, plan=(1, ak.NT))


def test_failed_launch_is_a_kernel_error_the_barrier_reraises(dev):
    """A launch the kernel's C function refuses, and one its wrapper
    refuses (top_k above the kernel's bound, as `--top_k 100` gives), raise
    the port's KernelError, which the drivers' per-video fault barrier
    never swallows (deva_tpu's swallows every RuntimeError and
    ValueError)."""
    from deva_tpu_torch.inference.eval_args import video_fault_barrier
    from deva_tpu_torch.ops.cuda_build import KernelError
    qk, qe, mk, ms, valid = _inputs(dev, 6, 300, 10)
    with pytest.raises(KernelError, match="sim_topk kernel launch failed"):
        with video_fault_barrier("vid"):
            ak._sim_topk_cuda(qk, qe, mk, ms, valid, 8, plan=(1, ak.NT))
    with pytest.raises(KernelError, match="top_k=100 outside"):
        with video_fault_barrier("vid"):
            ak.sim_topk(qk, qe, mk, ms, valid, 100)
    torch.cuda.synchronize()  # the context is still usable


# --------------------------------------------------------------------------
# the approx pair: segmax and denom_readout
# --------------------------------------------------------------------------

def _approx_operands(dev, seed, n, q, ck=64, n_valid=None, with_qe=True):
    qk, qe, mk, ms, valid = _inputs(dev, seed, n, q, ck, n_valid, with_qe)
    return apx.prep2(qk, qe, mk, ms, valid)


@pytest.mark.parametrize("with_qe", [True, False])
@pytest.mark.parametrize("n,q,n_tile", [(700, 130, 512), (16712, 1620, 512),
                                        (16712, 300, 1024), (100, 40, 512)])
def test_segmax_kernel_matches_plain(dev, n, q, n_tile, with_qe):
    ops = _approx_operands(dev, 7, n, q, n_valid=n - n // 8,
                           with_qe=with_qe)
    geom = apx.Geometry.of(n, n_tile)
    seg = apx.segmax(ops, geom)
    ref = apx.segmax_plain(ops, geom)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(seg), torch.isfinite(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(seg[fin], ref[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,q,c,n_valid", [(2048, 300, 1024, 1800),
                                           (700, 130, 30, 600),
                                           (16712, 1620, 1536, 11000),
                                           (256, 64, 64, 5),
                                           (3000, 200, 512, 2500),
                                           (3000, 200, 3072, 2500),
                                           (1620, 100, 1030, 1620),
                                           (1620, 100, 1024, 20),
                                           (1620, 100, 1024, 0)])
def test_denom_readout_kernel_matches_plain(dev, n, q, c, n_valid):
    """Under a threshold in a gap of the similarities (gap_threshold), out
    and usage within 1e-4 of the twin, for C of 1 to 6 objects and a C that
    is not a multiple of 4, and rows with 20 and with 0 valid tokens; the
    kernel reports the th it was given and the row max bitwise."""
    ops = _approx_operands(dev, 8, n, q, n_valid=n_valid)
    geom = apx.Geometry.of(n, 512)
    values = torch.randn((n, c), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    seg = apx.segmax(ops, geom)
    rmax, th = apx.threshold(seg, 30)
    th = apx.gap_threshold(apx.similarity2_plain(ops), th)
    out, usage, rmax_k, th_k = apx.denom_readout(ops, geom, seg, values, 30,
                                                 th)
    ref, ref_usage = apx.denom_readout_plain(ops, geom, seg, rmax, th,
                                             values)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(usage, ref_usage, rtol=1e-4, atol=1e-4)
    assert torch.equal(_bits(rmax_k), _bits(rmax))
    assert torch.equal(_bits(th_k), _bits(th))
    if n_valid == 0:
        assert not bool(out.abs().gt(0).any())


@pytest.mark.parametrize("with_qe", [True, False])
@pytest.mark.parametrize("n,q,k,n_valid", [(16712, 1620, 30, 9848),
                                           (16712, 200, 40, 9848),
                                           (700, 130, 12, 600),
                                           (1620, 64, 30, 20),
                                           (1620, 64, 30, 0),
                                           (100, 33, 200, 90)])
def test_denom_readout_threshold_is_bitwise_threshold(dev, n, q, k, n_valid,
                                                      with_qe):
    """The row max and k-th largest group max the kernel selects are
    bitwise `threshold`'s (torch.topk), with short rows (th = -inf), empty
    rows (rmax clamped to 0), k above 32 (no lower bound from the lanes:
    the select runs over the whole row) and k above the number of group
    maxima."""
    ops = _approx_operands(dev, 18, n, q, n_valid=n_valid, with_qe=with_qe)
    geom = apx.Geometry.of(n, 512)
    values = torch.randn((n, 64), device=dev)
    seg = apx.segmax(ops, geom)
    _, _, rmax, th = apx.denom_readout(ops, geom, seg, values, k)
    rmax_ref, th_ref = apx.threshold(seg, k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(rmax), _bits(rmax_ref))
    assert torch.equal(_bits(th), _bits(th_ref))


def test_denom_readout_whole_row_when_candidates_overflow(dev):
    """th = -inf on a full ring: every group qualifies, the candidate list
    overflows, and the kernel compacts from the row in device memory over
    66 rounds; the result is the dense softmax readout of the twin."""
    ops = _approx_operands(dev, 23, 16712, 100)
    geom = apx.Geometry.of(16712, 512)
    values = torch.randn((16712, 1024), device=dev)
    seg = apx.segmax(ops, geom)
    th = torch.full((100, 1), float("-inf"), device=dev)
    out, usage, rmax, _ = apx.denom_readout(ops, geom, seg, values, 30, th)
    ref, ref_usage = apx.denom_readout_plain(ops, geom, seg, rmax, th,
                                             values)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(usage, ref_usage, rtol=1e-4, atol=1e-4)


def test_denom_readout_support_in_rounds(dev):
    """10 base tokens copied 300 times, k=12: a row's tied group maxima
    qualify hundreds of groups, more than one round holds, and the result
    still matches the twin, with the exact top-k inside the support."""
    rng = np.random.default_rng(19)
    base = rng.standard_normal((10, 64)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (300, 1))).to(dev)
    qk, qe, _, _, _ = _inputs(dev, 20, 10, 150)
    ops = apx.prep2(qk, qe, mk, None, None)
    geom = apx.Geometry.of(3000, 512)
    values = torch.randn((3000, 1024), device=dev)
    seg = apx.segmax(ops, geom)
    rmax, th = apx.threshold(seg, 12)
    qualifying = ((seg >= th) & (seg > float("-inf"))).sum(-1)
    assert int(qualifying.min()) > 64  # more than one round (GCAP)
    th_gap = apx.gap_threshold(apx.similarity2_plain(ops), th)
    out, usage, _, _ = apx.denom_readout(ops, geom, seg, values, 12, th_gap)
    ref, ref_usage = apx.denom_readout_plain(ops, geom, seg, rmax, th_gap,
                                             values)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(usage, ref_usage, rtol=1e-4, atol=1e-4)
    _, _, _, th_k = apx.denom_readout(ops, geom, seg, values, 12)
    _, gi = ak.sim_topk(qk, qe, mk, None, None, 12)
    assert bool((apx.sim2_at(ops, gi) >= th_k).all())


@pytest.mark.parametrize("with_qe", [True, False])
@pytest.mark.parametrize("n,n_valid", [(16712, 9848), (1300, 1100),
                                       (100, 90)])
def test_segmax_is_bitwise_the_max_of_sim2_at(dev, n, n_valid, with_qe):
    """On sampled rows every group max is bitwise the max of sim2_at (the
    chain denom_readout recomputes) over the group's members."""
    ops = _approx_operands(dev, 21, n, 1620, n_valid=n_valid,
                           with_qe=with_qe)
    geom = apx.Geometry.of(n, 512)
    seg = apx.segmax(ops, geom)
    rows = torch.arange(0, 1620, 53, device=dev)
    sub = ops._replace(qcat=ops.qcat[rows].contiguous(),
                       bsq=None if ops.bsq is None else
                       ops.bsq[rows].contiguous())
    idx = torch.arange(geom.tiles * geom.n_tile, dtype=torch.int32,
                       device=dev).expand(len(rows), -1).contiguous()
    ref = apx.sim2_at(sub, idx).reshape(len(rows), geom.tiles, geom.group,
                                        geom.width).amax(2)
    assert torch.equal(_bits(seg[rows]), _bits(ref.reshape(len(rows), -1)))


def test_attend_approx_runs_no_topk_on_the_card(dev, monkeypatch):
    """The CUDA route of attend_approx_multi takes rmax and th in the
    kernel: `threshold` is never called and no sort or top-k kernel runs."""
    from torch.profiler import ProfilerActivity, profile
    qk, qe, mk, ms, valid = _inputs(dev, 22, 1300, 300, n_valid=1100)
    values = torch.randn((1300, 2, 32), device=dev)
    rings = [(mk[:512], ms[:512], values[:512], valid[:512]),
             (mk[512:], ms[512:], values[512:], valid[512:])]
    apx.attend_approx_multi(rings, qk, qe, 12)  # build and load first
    torch.cuda.synchronize()

    def no_threshold(*args):
        raise AssertionError("threshold() on the CUDA route")

    monkeypatch.setattr(apx, "threshold", no_threshold)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        apx.attend_approx_multi(rings, qk, qe, 12, return_usage=True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert any("segmax_kernel" in x for x in names), names
    assert any("denom_readout_kernel" in x for x in names), names
    assert not any("topk" in x.lower() or "sort" in x.lower()
                   for x in names), names


def test_attend_approx_kernels_match_plain(dev):
    qk, qe, mk, ms, valid = _inputs(dev, 9, 1300, 300, n_valid=1100)
    values = torch.randn((1300, 2, 32), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    rings = [(mk[:512], ms[:512], values[:512], valid[:512]),
             (mk[512:], ms[512:], values[512:], valid[512:])]
    ak.reset_launch_counts()
    out, usage = apx.attend_approx_multi(rings, qk, qe, 12,
                                         return_usage=True)
    assert ak.LAUNCHES == {"sim_topk": 0, "topk_readout": 0, "segmax": 1,
                           "denom_readout": 1}
    ref, ref_usage = apx.attend_approx_multi_plain(rings, qk, qe, 12,
                                                   return_usage=True)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    for u, r in zip(usage, ref_usage):
        torch.testing.assert_close(u, r, rtol=1e-4, atol=1e-5)


def test_approx_support_contains_exact_top_k_with_ties(dev):
    """A ring of 50 tokens copied 60 times: every row's support holds all
    60 copies of its best token (> 4k entries) and the exact top-k."""
    rng = np.random.default_rng(10)
    base = torch.from_numpy(rng.standard_normal((50, 64)).astype(
        np.float32)).to(dev)
    mk = base.repeat(60, 1)
    qk, qe, _, _, _ = _inputs(dev, 11, 10, 200)
    ops = apx.prep2(qk, qe, mk, None, None)
    geom = apx.Geometry.of(mk.shape[0], 512)
    values = torch.randn((3000, 1, 16), device=dev)
    _, _, _, th = apx.denom_readout(ops, geom, apx.segmax(ops, geom),
                                    values.reshape(3000, 16), 12)
    _, gi = ak.sim_topk(qk, qe, mk, None, None, 12)
    assert bool((apx.sim2_at(ops, gi) >= th).all())
    out = apx.attend_approx(mk, None, values, qk, qe, 12)
    ref = apx.attend_approx_multi_plain([(mk, None, values, None)], qk, qe,
                                        12)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_approx_kernels_reject_what_they_do_not_take(dev):
    ops = _approx_operands(dev, 12, 300, 10, ck=6)  # qcat width 12: fine
    apx.segmax(ops, apx.Geometry.of(300, 512))
    bad = _approx_operands(dev, 12, 300, 10, ck=5)  # width 10: not /4
    with pytest.raises(ValueError):
        apx.segmax(bad, apx.Geometry.of(300, 512))
    with pytest.raises(ValueError):
        apx.segmax(ops._replace(mcat=ops.mcat.cpu()),
                   apx.Geometry.of(300, 512))
    with pytest.raises(TypeError):
        apx.segmax(ops._replace(qcat=ops.qcat.double()),
                   apx.Geometry.of(300, 512))


# --------------------------------------------------------------------------
# bf16 rings (InferenceConfig(ring_dtype='bfloat16')): each kernel against
# its f32 launch on the widened ring, with the relation its design gives
# --------------------------------------------------------------------------

def _bf16_ring(mk, ms):
    """A ring rounded to bf16, and the same ring widened back to f32."""
    mk16 = mk.bfloat16()
    ms16 = None if ms is None else ms.bfloat16()
    return mk16, ms16, mk16.float(), None if ms16 is None else ms16.float()


@pytest.mark.parametrize("with_qe", [True, False])
@pytest.mark.parametrize("n,q,k", [(700, 130, 12), (16712, 1620, 30),
                                   (24, 64, 30), (3000, 300, 64)])
def test_sim_topk_bf16_ring_bitwise_the_widened_ring(dev, n, q, k, with_qe):
    """sim_topk widens each bf16 key at load, exactly: values and indices
    are bitwise the f32 launch on mk.float(), ms.float(); bf16 queries are
    widened by the wrapper, bitwise the f32 launch on the widened
    queries."""
    qk, qe, mk, ms, valid = _inputs(dev, 30, n, q, n_valid=n - n // 8,
                                    with_qe=with_qe)
    mk16, ms16, mk32, ms32 = _bf16_ring(mk, ms)
    gv, gi = ak.sim_topk(qk, qe, mk16, ms16, valid, k)
    rv, ri = ak.sim_topk(qk, qe, mk32, ms32, valid, k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(gv), _bits(rv)) and torch.equal(gi, ri)
    qk16 = qk.bfloat16()
    qe16 = None if qe is None else qe.bfloat16()
    gv, gi = ak.sim_topk(qk16, qe16, mk16, ms16, valid, k)
    rv, ri = ak.sim_topk(qk16.float(), None if qe16 is None else
                         qe16.float(), mk32, ms32, valid, k)
    assert torch.equal(_bits(gv), _bits(rv)) and torch.equal(gi, ri)
    pv, pi = ak.sim_topk_plain(qk16, qe16, mk16, ms16, valid, k)
    torch.testing.assert_close(gv, pv, rtol=1e-5, atol=1e-5)
    assert (gi != pi).float().mean().item() < 1e-3


@pytest.mark.parametrize("c", [1024, 1536, 30, 1030, 1028])
def test_topk_readout_bf16_bitwise_rounded_weights(dev, c):
    """On a bf16 ring the readout is bitwise the f32 launch on the weights
    rounded to bf16 and the widened ring: one segment, and two segments
    split at 0, 512, 513, N-1 and N, and at 512 with segment B 2 bytes past
    16-byte alignment (the scalar path). C % 8 != 0 (30, 1030, 1028) takes
    the scalar path throughout; the 16-byte path carries 8 elements."""
    idx, w, values = _readout_inputs(dev, 31, 1620, 3000, c, 30)
    v16 = values.bfloat16()
    ref = ak.topk_readout(idx, w.bfloat16().float(), v16.float())
    one = ak.topk_readout(idx, w, v16)
    torch.cuda.synchronize()
    assert torch.equal(_bits(one), _bits(ref)), c
    shifted = torch.empty(2488 * c + 1, dtype=torch.bfloat16,
                          device=dev)[1:].view(2488, c)
    shifted.copy_(v16[512:])
    assert shifted.data_ptr() % 16 != 0
    for seg_a, seg_b in [(v16[:at], v16[at:])
                         for at in (0, 512, 513, 2999, 3000)] + \
            [(v16[:512], shifted)]:
        two = ak.topk_readout(idx, w, (seg_a, seg_b))
        torch.cuda.synchronize()
        assert torch.equal(_bits(one), _bits(two)), (c, seg_a.shape[0])
    torch.testing.assert_close(one, ak.topk_readout_plain(idx, w, v16),
                               rtol=1e-4, atol=1e-4)


def test_bf16_rings_reject_mixed_and_other_dtypes(dev):
    """One ring dtype per call, float32 or bfloat16: a mix, or float16,
    raises; nothing is cast to make the call work."""
    qk, qe, mk, ms, valid = _inputs(dev, 32, 300, 10)
    with pytest.raises(TypeError):
        ak.sim_topk(qk, qe, mk.bfloat16(), ms, valid, 8)
    with pytest.raises(TypeError):
        ak.sim_topk(qk, qe, mk.half(), ms.half(), valid, 8)
    idx, w, values = _readout_inputs(dev, 32, 40, 300, 64, 8)
    with pytest.raises(TypeError):
        ak.topk_readout(idx, w, (values[:100].bfloat16(), values[100:]))
    with pytest.raises(TypeError):
        ak.topk_readout(idx, w, values.half())
    ops = _approx_operands(dev, 32, 300, 40)
    geom = apx.Geometry.of(300, 512)
    seg = apx.segmax(ops, geom)
    with pytest.raises(TypeError):
        apx.denom_readout(ops, geom, seg, values.half(), 8)


@pytest.mark.parametrize("with_qe", [True, False])
@pytest.mark.parametrize("n,q,n_tile", [(16712, 1620, 1024), (700, 130, 512)])
def test_segmax_bf16_keys_bitwise_the_widened_keys(dev, n, q, n_tile,
                                                   with_qe):
    """prep2 builds mcat in f32 from the widened bf16 keys, so segmax on a
    bf16 ring is bitwise segmax on the widened ring."""
    qk, qe, mk, ms, valid = _inputs(dev, 33, n, q, n_valid=n - n // 8,
                                    with_qe=with_qe)
    mk16, ms16, mk32, ms32 = _bf16_ring(mk, ms)
    geom = apx.Geometry.of(n, n_tile)
    seg16 = apx.segmax(apx.prep2(qk, qe, mk16, ms16, valid), geom)
    seg32 = apx.segmax(apx.prep2(qk, qe, mk32, ms32, valid), geom)
    torch.cuda.synchronize()
    assert torch.equal(_bits(seg16), _bits(seg32))


@pytest.mark.parametrize("n,q,c,n_valid", [(16712, 1620, 1024, 9848),
                                           (3000, 200, 1536, 2500),
                                           (700, 130, 30, 600),
                                           (1620, 100, 1028, 1620),
                                           (1620, 100, 1024, 20),
                                           (1620, 100, 1024, 0)])
def test_denom_readout_bf16_values(dev, n, q, c, n_valid):
    """On a bf16 value ring: rmax and th bitwise, usage within f32 atomics
    noise (the order of the adds differs between launches) of the f32-ring
    launch on the widened values; the output within the bf16 rounding of
    the normalised weights of that launch:
    |out16 - out32| <= 2^-8 * sum_n aff |V| (+ f32 summation noise).
    Against the twin on the same ring: within 1e-5 on at least 99% of the
    outputs. The twin's aff comes from a similarity summed in another order,
    and a weight that lies at a bf16 rounding boundary may round the other
    way there (measured on the H100: 0.1% of the outputs at the 480p shape,
    up to 8e-4), so every output is held within one bf16 ulp of the weights,
    2^-7 * sum_n aff |V|."""
    ops = _approx_operands(dev, 34, n, q, n_valid=n_valid)
    geom = apx.Geometry.of(n, 512)
    gen = torch.Generator(device=dev).manual_seed(2)
    v16 = torch.randn((n, c), device=dev, generator=gen).bfloat16()
    v32 = v16.float()
    seg = apx.segmax(ops, geom)
    o16, u16, rmax16, th16 = apx.denom_readout(ops, geom, seg, v16, 30)
    o32, u32, rmax32, th32 = apx.denom_readout(ops, geom, seg, v32, 30)
    torch.cuda.synchronize()
    assert torch.equal(_bits(rmax16), _bits(rmax32))
    assert torch.equal(_bits(th16), _bits(th32))
    torch.testing.assert_close(u16, u32, rtol=1e-5, atol=1e-6)
    aff = apx._support_weights(apx.similarity2_plain(ops), rmax32, th32)
    slack = 2.0 ** -8 * (aff @ v32.abs()) + 1e-6
    assert bool(((o16 - o32).abs() <= slack).all())
    # the twin at a threshold in a gap, so both keep the same support
    th = apx.gap_threshold(apx.similarity2_plain(ops), th32)
    out, _, _, _ = apx.denom_readout(ops, geom, seg, v16, 30, th)
    ref, _ = apx.denom_readout_plain(ops, geom, seg, rmax32, th, v16)
    diff = (out - ref).abs()
    assert (diff <= 1e-5 + 1e-5 * ref.abs()).float().mean().item() >= 0.99
    aff = apx._support_weights(apx.similarity2_plain(ops), rmax32, th)
    assert bool((diff <= 2.0 ** -7 * (aff @ v32.abs()) + 1e-5).all())
    if n_valid == 0:
        assert not bool(o16.abs().gt(0).any())


def test_attend_bf16_rings_kernels_match_plain(dev):
    """Both composites on bf16 rings ([long-term ; working] pairs) against
    their twins on the same rings."""
    qk, qe, mk, ms, valid = _inputs(dev, 35, 1300, 300, n_valid=1100)
    mk16, ms16 = mk.bfloat16(), ms.bfloat16()
    values = torch.randn((1300, 2, 32), device=dev).bfloat16()
    out, usage = ak.attend_topk(mk16, ms16, (values[:512], values[512:]),
                                qk, qe, 12, valid, return_usage=True)
    ref, ref_usage = ak.attend_topk_plain(mk16, ms16, values, qk, qe, 12,
                                          valid, return_usage=True)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(usage, ref_usage, rtol=1e-4, atol=1e-5)
    rings = [(mk16[:512], ms16[:512], values[:512], valid[:512]),
             (mk16[512:], ms16[512:], values[512:], valid[512:])]
    out, usage = apx.attend_approx_multi(rings, qk, qe, 12,
                                         return_usage=True)
    ref, ref_usage = apx.attend_approx_multi_plain(rings, qk, qe, 12,
                                                   return_usage=True)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    for u, r in zip(usage, ref_usage):
        torch.testing.assert_close(u, r, rtol=1e-4, atol=1e-5)


def test_batchnorm_bf16_input_gives_bf16(dev):
    """flax's nn.BatchNorm(dtype=bf16): a bf16 input with f32 statistics
    normalises in f32 and returns bf16 on the card, as on the CPU."""
    bn = torch.nn.BatchNorm2d(8).to(dev).eval()
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
        x = torch.randn((2, 8, 5, 5), device=dev).bfloat16()
        y = bn(x)
        assert y.dtype == torch.bfloat16
        ref = bn.cpu()(x.cpu())
    torch.testing.assert_close(y.cpu().float(), ref.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_bf16_step_on_the_card_matches_the_cpu(dev, method):
    """bf16 compute and bf16 rings through step on the card against the
    same configuration on the CPU, 8 frames of 64x96 with long-term memory
    consolidating. The two run bf16 convolutions that sum in different
    orders (cuDNN, oneDNN), so each layer differs by a few bf16 ulps; the
    budget is about three times what the H100 gave (max 0.0126 exact,
    0.0172 approx; frame mean 0.0019)."""
    import copy
    from deva_tpu_torch.config import InferenceConfig, ModelConfig
    from deva_tpu_torch.inference.core import InferenceCore
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    rng = np.random.default_rng(36)
    base = rng.standard_normal((8, 12, 3)).astype(np.float32)
    frames = [(base + 0.1 * rng.standard_normal(base.shape)).repeat(8, 0)
              .repeat(8, 1).astype(np.float32) for _ in range(8)]
    mask = np.zeros((64, 96), np.int64)
    mask[8:28, 10:40] = 1
    mask[36:60, 50:90] = 2
    net = init_weights(DEVANetwork(ModelConfig(dtype="bfloat16")),
                       seed=0).eval()
    cfg = InferenceConfig(mem_every=2, top_k=8, max_mid_term_frames=3,
                          min_mid_term_frames=1, num_prototypes=16,
                          max_long_term_elements=96,
                          enable_long_term_count_usage=True,
                          ring_dtype="bfloat16", topk_method=method)
    cpu = InferenceCore(net, cfg)
    gpu = InferenceCore(copy.deepcopy(net).to(dev), cfg)
    diffs = []
    for ti, img in enumerate(frames):
        args = (mask, [1, 2]) if ti == 0 else ()
        p_cpu = cpu.step(img, *args)
        p_gpu = gpu.step(img, *args).cpu()
        diffs.append((p_gpu - p_cpu).abs())
    assert gpu.memory.long_buckets[0].size > 0
    worst = max(d.max().item() for d in diffs)
    mean = max(d.mean().item() for d in diffs)
    print(f"bf16 {method} card vs cpu: max {worst:.4g}, frame mean {mean:.4g}")
    assert worst < 0.05 and mean < 0.006, (worst, mean)


# --------------------------------------------------------------------------
# the video axis: one launch for B videos, each bitwise its own launch
# --------------------------------------------------------------------------

def _batched_inputs(dev, seed, b, n, q, ring, n_lt=512):
    """B videos' rings [long-term ; working] with per-video validity; the
    second video's long-term segment is all invalid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    dt = getattr(torch, ring)
    qk = randn(b, q, 64)
    qe = torch.rand((b, q, 64), generator=gen, device=dev)
    mk = randn(b, n, 64).to(dt)
    ms = (1 + 3 * torch.rand((b, n), generator=gen, device=dev)).to(dt)
    v2 = randn(b, n, 1024).to(dt)
    ar = torch.arange(n, device=dev)
    valid = torch.stack([(ar < s) | ((ar >= n_lt) & (ar < n_lt + w))
                         for s, w in zip((400, 0, 512)[:b],
                                         (n - n_lt - 100, n - n_lt, 700)[:b])])
    return qk, qe, mk, ms, v2, valid


def _each(fn, *args):
    """fn per video (row b of every tensor argument, or of each tensor of a
    tuple argument), stacked."""
    pick = lambda a, b: tuple(x[b] for x in a) if isinstance(a, tuple) \
        else (a[b] if isinstance(a, torch.Tensor) else a)
    outs = [fn(*(pick(a, b) for a in args)) for b in range(args[0].shape[0])]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))


@pytest.mark.parametrize("ring", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,q", [(2000, 300), (16712, 1620)])
def test_batched_exact_kernels_bitwise_per_video(dev, ring, n, q):
    qk, qe, mk, ms, v2, valid = _batched_inputs(dev, 40, 3, n, q, ring)
    gv, gi = ak.sim_topk(qk, qe, mk, ms, valid, 30)
    sv, si = _each(lambda *a: ak.sim_topk(*a, 30), qk, qe, mk, ms, valid)
    assert torch.equal(_bits(gv), _bits(sv)) and torch.equal(gi, si)
    assert int(gi[1].min()) >= 512  # the all-invalid long-term segment
    w = torch.softmax(gv, -1)
    pair = (v2[:, :512].contiguous(), v2[:, 512:].contiguous())
    out = ak.topk_readout(gi, w, v2)
    assert torch.equal(_bits(out), _bits(_each(ak.topk_readout, gi, w, v2)))
    assert torch.equal(_bits(ak.topk_readout(gi, w, pair)), _bits(out))
    torch.testing.assert_close(out, ak.topk_readout_plain(gi, w, v2),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ring", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,q", [(2000, 300), (16712, 1620)])
def test_batched_approx_kernels_per_video(dev, ring, n, q):
    qk, qe, mk, ms, v2, valid = _batched_inputs(dev, 41, 3, n, q, ring)
    ops = apx.prep2(qk, qe, mk, ms, valid)
    geom = apx.Geometry.of(n, apx.default_n_tile(1024, v2.element_size()))
    seg = apx.segmax(ops, geom)
    per = lambda b: ops._replace(**{f: getattr(ops, f)[b]
                                    for f in ops._fields
                                    if getattr(ops, f) is not None})
    singles = [apx.segmax(per(b), geom) for b in range(3)]
    assert torch.equal(_bits(seg), _bits(torch.stack(singles)))
    out, usage, rmax, th = apx.denom_readout(ops, geom, seg, v2, 30)
    for b in range(3):
        o, u, r, t = apx.denom_readout(per(b), geom, seg[b], v2[b], 30)
        assert torch.equal(_bits(rmax[b]), _bits(r))
        assert torch.equal(_bits(th[b]), _bits(t))
        torch.testing.assert_close(out[b], o, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(usage[b], u, rtol=1e-5, atol=1e-5)
    assert float(usage[1, :512].abs().sum()) == 0.0


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_batched_attend_is_one_launch_of_each_kernel(dev, method):
    """B videos in one call launch each kernel of the method once and
    match the batched plain twin."""
    qk, qe, mk, ms, v2, valid = _batched_inputs(dev, 42, 3, 2000, 300,
                                                "float32")
    values = v2.reshape(3, 2000, 2, 512)
    ak.reset_launch_counts()
    if method == "exact":
        pair = (values[:, :512].contiguous(), values[:, 512:].contiguous())
        out, usage = ak.attend_topk(mk, ms, pair, qk, qe, 30, valid,
                                    return_usage=True)
        ref, ref_usage = ak.attend_topk_plain(mk, ms, values, qk, qe, 30,
                                              valid, return_usage=True)
    else:
        rings = [tuple(t[:, :512].contiguous() for t in (mk, ms, values,
                                                          valid)),
                 tuple(t[:, 512:].contiguous() for t in (mk, ms, values,
                                                          valid))]
        out, usage = apx.attend_approx_multi(rings, qk, qe, 30,
                                             return_usage=True)
        ref, ref_usage = apx.attend_approx_multi_plain(rings, qk, qe, 30,
                                                       return_usage=True)
        usage, ref_usage = torch.cat(usage, -1), torch.cat(ref_usage, -1)
    torch.cuda.synchronize()
    kernels = ("sim_topk", "topk_readout") if method == "exact" else \
        ("segmax", "denom_readout")
    assert {k: v for k, v in ak.LAUNCHES.items() if v} == \
        dict.fromkeys(kernels, 1), ak.LAUNCHES
    assert out.shape == (3, 2, 300, 512)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(usage, ref_usage, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# detection fusion on the card
# --------------------------------------------------------------------------

def _detection_cores(dev, **over):
    import copy
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.core import InferenceCore
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    net = init_weights(DEVANetwork(), seed=0).eval()
    cfg = InferenceConfig(**dict(dict(mem_every=2, top_k=8,
                                      enable_long_term=False,
                                      max_missed_detection_count=2), **over))
    cpu = InferenceCore(net, cfg)
    gpu = InferenceCore(copy.deepcopy(net).to(dev), cfg)
    for core in (cpu, gpu):
        core.object_manager._rng = np.random.default_rng(5)
    return cpu, gpu


@pytest.mark.parametrize("top_k", [8, 30])
def test_spatial_alignment_on_the_card_matches_the_cpu(dev, top_k):
    """One alignment launches sim_topk and topk_readout once each (with
    top_k 30 > the 24 tokens of a 64x96 frame as well), within 5e-3 of
    the CPU."""
    frames, masks, infos = dc.small_clip(np.random.default_rng(4), 3)
    cpu, gpu = _detection_cores(dev, top_k=top_k)
    one_hot = np.stack([masks[0] == d["id"] for d in infos[0]]
                       ).astype(np.float32)
    ak.reset_launch_counts()
    p_gpu = gpu.spatial_alignment(0, frames[0], one_hot, 2, frames[2])
    torch.cuda.synchronize()
    assert {k: v for k, v in ak.LAUNCHES.items() if v} == \
        {"sim_topk": 1, "topk_readout": 1}, ak.LAUNCHES
    p_cpu = cpu.spatial_alignment(0, frames[0], one_hot, 2, frames[2])
    assert p_gpu.shape == p_cpu.shape == (len(one_hot) + 1, 64, 96)
    np.testing.assert_allclose(p_gpu, p_cpu, atol=5e-3)


@pytest.mark.parametrize("perfect", [False, True])
def test_online_incorporate_and_purge_on_the_card_match_the_cpu(dev,
                                                                perfect):
    """incorporate_detection every other frame over 8 frames (segment 4
    purged at frame 6) on the card against the CPU: equal object tables
    and buckets; propagated frames and forward predictions within 5e-3.
    The cores predict the forward mask: a detection frame may differ beyond
    5e-3 only where the two forward predictions have another argmax (the
    painted id differs there), on at most 5% of the frame (chip_smoke.py's
    DET_FLIP_SHARE, which says why). perfect: the
    forward mask is detection_clips.perfect_forward, nothing on the host
    depends on a device output, and every frame and every sensory row is
    within 5e-3."""
    frames, masks, infos = dc.small_clip(np.random.default_rng(4), 8)
    cpu, gpu = _detection_cores(dev)
    for ti, img in enumerate(frames):
        if ti % 2:
            diff = (gpu.step(img).cpu() - cpu.step(img)).abs().max().item()
            assert diff <= 5e-3, (ti, diff)
            continue
        out = []
        ak.reset_launch_counts()
        for core in (cpu, gpu):
            kw = {"forward_mask": dc.perfect_forward(core, masks[ti])} \
                if perfect else {}
            out.append(dc.incorporate_seen(core, img, masks[ti],
                                           dc.segment_infos(infos[ti]),
                                           **kw))
        (l_cpu, f_cpu), (l_gpu, f_gpu) = out
        if f_cpu is not None:
            np.testing.assert_allclose(f_gpu, f_cpu, atol=5e-3)
        dc.check_detection_frame(torch.softmax(l_cpu, 0),
                                 torch.softmax(l_gpu, 0),
                                 dc.paint_flips(f_cpu, f_gpu), 5e-3, 0.05,
                                 f"frame {ti}")
        assert dc.object_table(gpu) == dc.object_table(cpu), ti
        if ti and not perfect:  # the forward prediction ran the kernels
            assert ak.LAUNCHES["sim_topk"] > 0 and \
                ak.LAUNCHES["topk_readout"] > 0, ak.LAUNCHES
    assert 4 not in [row[0] for row in dc.object_table(gpu)]
    assert [b.obj_ids for b in gpu.memory.buckets.values()] == \
        [b.obj_ids for b in cpu.memory.buckets.values()]
    if perfect:
        diff = (gpu.memory.sensory.cpu() - cpu.memory.sensory).abs().max()
        assert diff.item() <= 5e-3, diff


# --------------------------------------------------------------------------
# batched detection fusion: (video, slot) pairs on the kernels' video axis
# --------------------------------------------------------------------------

def _pair_calls(dev, method, monkeypatch):
    """A BatchedDetectionPropagator on the card over two 64x96 videos with
    multi-bucket, long-term state (video 1 opens a third object's bucket),
    one step_all; -> {wrapper: its arguments} of that lockstep frame, and
    the number of (video, slot) pairs."""
    import copy
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.batched_detection import \
        BatchedDetectionPropagator
    from deva_tpu_torch.inference.core import InferenceCore
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    net = copy.deepcopy(init_weights(DEVANetwork(), seed=0)).to(dev).eval()
    cfg = InferenceConfig(mem_every=1, top_k=8, enable_long_term=True,
                          enable_long_term_count_usage=True,
                          max_mid_term_frames=4, min_mid_term_frames=2,
                          num_prototypes=8, topk_method=method)
    rng = np.random.default_rng(51)
    clips = [dc.small_clip(rng, 8, appear=2, show=0, vanish=0),
             dc.small_clip(rng, 8, appear=10 ** 6, show=0, vanish=0)]
    cores = []
    for vi, (frames, masks, infos) in enumerate(clips):
        core = InferenceCore(net, cfg)
        core.enabled_long_id()
        core.object_manager._rng = np.random.default_rng(5 + vi)
        for ti in (0, 2):
            core.incorporate_detection(frames[ti], masks[ti],
                                       dc.segment_infos(infos[ti]))
        for ti in (3, 4, 5):
            core.step(frames[ti])
        cores.append(core)
    bp = BatchedDetectionPropagator(net, cfg)
    bp.attach(cores)
    module, names = (ak, ("sim_topk", "topk_readout")) if method == "exact" \
        else (apx, ("segmax", "denom_readout"))
    calls = {}
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _f=fn: (
            calls.__setitem__(_n, a), _f(*a))[1])
    ak.reset_launch_counts()
    bp.step_all([c[0][6] for c in clips])
    torch.cuda.synchronize()
    assert {k: v for k, v in ak.LAUNCHES.items() if v} == \
        dict.fromkeys(names, 1), ak.LAUNCHES
    assert (bp.lt_sizes > 0).any() and bp.n_slots >= 2
    pairs = bp.key.shape[0] * bp.key.shape[1]
    bp.detach()
    return calls, pairs


def test_pair_launch_bitwise_per_pair_exact(dev, monkeypatch):
    """The exact pair's one launch for all (video, slot) pairs of a lockstep
    frame is bitwise each pair's own launch on its slices ([long-term ;
    working] keys, the two value segments read in place); sim_topk is
    within the f32 bound of its plain twin (chip_smoke.check_pair_on_path's
    bound: the path's keys are not unit-scale), topk_readout within the
    file's budget."""
    calls, pairs = _pair_calls(dev, "exact", monkeypatch)
    qk, qe, mk, ms, valid, k = calls["sim_topk"]
    gi, w, (lt_v, work_v) = calls["topk_readout"]
    assert qk.shape[0] == pairs and qk.is_contiguous()
    gv, gx = ak.sim_topk(qk, qe, mk, ms, valid, k)
    out = ak.topk_readout(gi, w, (lt_v, work_v))
    for p in range(pairs):
        sv, sx = ak.sim_topk(qk[p], qe[p], mk[p], ms[p], valid[p], k)
        assert torch.equal(_bits(gv[p]), _bits(sv)) and torch.equal(gx[p], sx)
        so = ak.topk_readout(gi[p], w[p], (lt_v[p], work_v[p]))
        assert torch.equal(_bits(out[p]), _bits(so))
    # the network's keys are large and the similarity's terms cancel, so
    # the twin is held within the f32 bound of an evaluation of the terms:
    # gamma(2 Ck + 4) times their absolute scale, per row
    pv, _ = ak.sim_topk_plain(qk, qe, mk, ms, valid, k)
    ck = mk.shape[-1]
    scale = (qe.abs() @ (mk * mk).transpose(1, 2)
             + 2 * (qk * qe).abs() @ mk.abs().transpose(1, 2)
             + (qe * qk * qk).abs().sum(-1, keepdim=True)) \
        * ms.abs()[:, None] / ck ** 0.5
    n_terms = 2 * ck + 4
    gamma = n_terms * 2.0 ** -24 / (1 - n_terms * 2.0 ** -24)
    tol = 2 * gamma * scale.masked_fill(~valid[:, None], 0).amax(
        -1, keepdim=True) + 1e-5
    both_inf = torch.isinf(gv) & (gv == pv)
    assert bool((torch.where(both_inf, 0.0, (gv - pv).abs()) <= tol).all())
    torch.testing.assert_close(out, ak.topk_readout_plain(
        gi, w, (lt_v, work_v)), rtol=1e-4, atol=1e-4)


def test_pair_launch_per_pair_approx(dev, monkeypatch):
    """The approx pair's one launch for all (video, slot) pairs: segmax
    bitwise each pair's own launch; denom_readout's rmax and th bitwise,
    its out and usage within 1e-5 (usage atomics add in another order)."""
    calls, pairs = _pair_calls(dev, "approx", monkeypatch)
    ops, geom = calls["segmax"]
    _, _, seg, v2, k = calls["denom_readout"]
    assert ops.qcat.shape[0] == pairs
    got = apx.segmax(ops, geom)
    assert torch.equal(_bits(got), _bits(seg))
    out, usage, rmax, th = apx.denom_readout(ops, geom, seg, v2, k)
    per = lambda p: ops._replace(**{f: getattr(ops, f)[p]
                                    for f in ops._fields
                                    if getattr(ops, f) is not None})
    for p in range(pairs):
        assert torch.equal(_bits(apx.segmax(per(p), geom)), _bits(seg[p]))
        o, u, r, t = apx.denom_readout(per(p), geom, seg[p], v2[p], k)
        assert torch.equal(_bits(rmax[p]), _bits(r))
        assert torch.equal(_bits(th[p]), _bits(t))
        torch.testing.assert_close(out[p], o, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(usage[p], u, rtol=1e-5, atol=1e-5)


def test_resizes_on_the_card_match_the_cpu(dev):
    """The detector layer's resizes on the card: PIL's uint8 resize bit for
    bit (integer taps in f64: exact on any device), the antialiased float
    resize within 1e-6 of the CPU's."""
    from deva_tpu_torch.ops.resize import (resize_bilinear_aa,
                                           resize_image_uint8)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, (480, 854, 3))
                           .astype(np.uint8))
    for size in ((576, 1024), (120, 213), (480, 854)):
        assert torch.equal(resize_image_uint8(img.to(dev), size).cpu(),
                           resize_image_uint8(img, size))
    logits = torch.from_numpy(rng.standard_normal((4, 256, 256))
                              .astype(np.float32))
    for size in ((1024, 1024), (480, 854), (30, 53)):
        torch.testing.assert_close(
            resize_bilinear_aa(logits.to(dev), size).cpu(),
            resize_bilinear_aa(logits, size), rtol=0, atol=1e-6)


@pytest.mark.parametrize("hq", [False, True])
def test_mobile_sam_on_the_card_matches_the_cpu(dev, hq):
    """MobileSAM / Light-HQ-SAM at full width on a 240x320 frame, the same
    seeded weights on the card and the CPU: embeddings within 5e-3
    (chip_smoke.py phase 2's f32 budget), masks_for_boxes equal but where
    the CPU's logit lies within 5e-3 of 0, and generate keeping the same
    masks with IoUs within 5e-3."""
    from deva_tpu_torch.ext.mobile_sam import MobileSAM
    kw = dict(points_per_side=4, pred_iou_thresh=float("-inf"), hq=hq)
    cpu = MobileSAM(device="cpu", seed=3, **kw)
    gpu = MobileSAM(cpu.net.state_dict(), device=dev, **kw)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (240, 320, 3)).astype(np.uint8)
    with torch.inference_mode():
        e_cpu, kw_cpu, shape, scale = cpu._embed(img)
        e_gpu, _, _, _ = gpu._embed(img)
        torch.testing.assert_close(e_gpu.cpu(), e_cpu, rtol=0, atol=5e-3)
        boxes = np.array([[40, 30, 200, 180], [10, 10, 120, 90]],
                         np.float32)
        masks, ious = cpu._decode(e_cpu, kw_cpu, boxes=torch.from_numpy(
            boxes * scale)[None])
        sel, _ = cpu._best(masks[0], ious[0])
        logits = cpu._masks_to_original(sel, *shape, 240, 320)
    near = logits.abs().numpy() <= 5e-3
    differ = cpu.masks_for_boxes(img, boxes) != gpu.masks_for_boxes(img,
                                                                    boxes)
    assert not (differ & ~near).any()
    g_cpu, g_gpu = cpu.generate(img), gpu.generate(img)
    assert g_cpu["masks"].shape == g_gpu["masks"].shape
    np.testing.assert_allclose(g_gpu["iou_preds"], g_cpu["iou_preds"],
                               rtol=0, atol=5e-3)
    assert (g_cpu["masks"] != g_gpu["masks"]).mean() <= 1e-3


def test_train_step_card_matches_cpu(dev):
    """chip_smoke.py's phase 10a: one train step of the full-width network
    (64x64, B=2, T=4, num_ref_frames 2, 3 objects, it 0) on the card and on
    the CPU from the same weights, batch and draws; the total loss within
    1e-4 relative, every gradient within 1e-3 of its tensor's largest, the
    updates within 1e-2 * lr where the gradient is clear of 0 and within
    2 * lr anywhere; a tensor that misses in f32 (ReLU inputs within f32
    rounding of the kink) must agree in float64 between the devices within
    1e-4 of its largest (chip_smoke.F64_GRAD_REL)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from deva_tpu_torch.models.network import DEVANetwork, init_weights
    chip_smoke.phase_train_parity(init_weights(DEVANetwork(), seed=0).eval(),
                                  dev)
