"""The host side and the index logic of deva_tpu_torch's approx kernels, on
the CPU: a numpy emulation of denom_readout.cu's in-kernel k-th largest
select (radix passes over the order-preserving key of the float) held
bitwise to `threshold` (torch.topk), an emulation of its warp compaction of
the qualifying groups in rounds held to the plain support, its row and
column indexing and shared memory from the source's own constants, and the
argument checks that run before the kernel library is built. The kernels
themselves run only on a card (tests/test_torch_cuda.py)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deva_tpu_torch.ops import approx_kernels as apx

CSRC = Path(apx.__file__).resolve().parents[1] / "csrc"
# denom_readout.cu's limits, read from the source: qcat channels, histogram
# bins, groups per round, tokens per group, candidate group maxima, query
# rows per block, value vectors per lane per column block
DR = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                          (CSRC / "denom_readout.cu").read_text()).group(1))
      for name in ("KC_MAX", "BINS", "GCAP", "GROUP_MAX", "CCAP", "ROWS",
                   "VPL")}


def order_key(x: np.ndarray) -> np.ndarray:
    """denom_readout.cu's order_key: uint32 keys in the order of the floats
    (-0 below +0)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def key_float(key: int) -> np.float32:
    k = np.uint32(key)
    u = k & np.uint32(0x7FFFFFFF) if k & 0x80000000 else ~k
    return np.array([u], np.uint32).view(np.float32)[0]


def kth_largest(row: np.ndarray, kk: int) -> np.float32:
    """The kernel's select, step for step: four passes of 8 bits; in each, a
    256-bin histogram of the keys that match the prefix so far, lane l
    owning digits 255 - 8l - j (j = 0..7), an inclusive scan over the lanes,
    and the one (lane, j) whose running count first reaches `remaining`."""
    keys = order_key(row).astype(np.int64)
    prefix, mask, remaining = 0, 0, kk
    for shift in (24, 16, 8, 0):
        hit = (keys & mask) == prefix
        hist = np.bincount((keys[hit] >> shift) & 255, minlength=256)
        c = hist[255 - 8 * np.arange(32)[:, None] - np.arange(8)[None, :]]
        mine = c.sum(1)
        before_lane = np.cumsum(mine) - mine
        found = []
        for lane in range(32):
            before = int(before_lane[lane])
            for j in range(8):
                if before < remaining <= before + int(c[lane, j]):
                    found.append((255 - 8 * lane - j, remaining - before))
                before += int(c[lane, j])
        assert len(found) == 1, found  # exactly one lane finds the digit
        digit, remaining = found[0]
        prefix |= digit << shift
        mask |= 255 << shift
    return key_float(prefix)


def kernel_threshold(row: np.ndarray, kk: int, ccap: int) -> np.float32:
    """denom_readout.cu's whole path to th: each lane's max over its float4
    columns (lane + 32t), the kk-th largest lane max (ties by lane) as a
    lower bound when kk <= 32, the entries at or above it as candidates, and
    the select over the candidates, or over the row when they overflow."""
    lmax = row.reshape(-1, 32, 4).max(axis=(0, 2))  # [lane]
    lo = -np.inf
    if kk <= 32:
        order = sorted(range(32), key=lambda lane: (-lmax[lane], lane))
        lo = lmax[order[kk - 1]]
    cand = row[row >= lo]
    assert len(cand) >= kk
    return kth_largest(row if len(cand) > ccap else cand, kk)


def _rows(rng, nseg: int) -> dict:
    """Rows of group maxima: random, heavy ties, +-0, -inf tails, rows with
    fewer finite entries than k, all -inf, negative values."""
    f = lambda a: np.asarray(a, np.float32)
    rnd = f(rng.standard_normal(nseg))
    ties = f(rng.integers(-3, 4, nseg) * 0.5)
    zeros = f(np.where(rng.random(nseg) < 0.5, 0.0, -0.0))
    zeros[:5] = 1.0
    short = np.full(nseg, -np.inf, np.float32)
    short[rng.choice(nseg, 7, replace=False)] = rng.standard_normal(7)
    tail = rnd.copy()
    tail[nseg // 3:] = -np.inf
    neg = -np.abs(rnd) - 1
    return {"random": rnd, "ties": ties, "zeros": zeros, "short": short,
            "tail": tail, "empty": np.full(nseg, -np.inf, np.float32),
            "negative": f(neg), "tiny": f(rnd * 1e-38)}


@pytest.mark.parametrize("nseg", [128, 512, 4224])
@pytest.mark.parametrize("k", [1, 12, 30, 64, 129, 5000])
def test_kth_largest_select_is_bitwise_topk(nseg, k):
    """The emulated select gives bitwise the th of `threshold` (the
    min(k, nseg)-th largest, torch.topk) on every kind of row, k above the
    row's finite entries and above nseg included."""
    rows = _rows(np.random.default_rng(nseg * 7 + k), nseg)
    seg = torch.from_numpy(np.stack(list(rows.values())))
    _, th = apx.threshold(seg, k)
    kk = min(k, nseg)
    for i, (name, row) in enumerate(rows.items()):
        got = kth_largest(row, kk)
        assert np.array_equal(
            np.array([got]).view(np.uint32),
            np.array([kernel_threshold(row, kk, DR["CCAP"])]).view(
                np.uint32)), name  # the candidates change nothing
        want = th[i, 0].numpy()
        if name == "zeros" and got == 0 and want == 0:
            # -0 and +0 tie as values, and torch.topk may give either
            assert got == want
        else:
            assert np.array_equal(np.array([got]).view(np.uint32),
                                  np.array([want]).view(np.uint32)), \
                (name, got, want)


def test_kth_largest_of_zeros_of_one_sign_keeps_the_sign():
    for z in (0.0, -0.0):
        row = np.full(128, z, np.float32)
        row[:3] = 2.0
        got = kth_largest(row, 10)
        want = apx.threshold(torch.from_numpy(row)[None], 10)[1][0, 0]
        assert np.signbit(got) == bool(torch.signbit(want)) == \
            bool(np.signbit(np.float32(z)))


def compact_rounds(row: np.ndarray, th: float, gcap: int):
    """denom_readout.cu's `compact`, round by round: 32 groups a step, a
    ballot of max >= th and > -inf, the qualifying groups in group order;
    a round stops before the step that would overflow gcap."""
    rounds, pos, nseg = [], 0, len(row)
    while True:
        groups = []
        while pos < nseg:
            g = np.arange(pos, min(pos + 32, nseg))
            hit = g[(row[g] >= th) & (row[g] > -np.inf)]
            if len(groups) + len(hit) > gcap:
                break
            groups += hit.tolist()
            pos += 32
        rounds.append(groups)
        if pos >= nseg:
            return rounds


@pytest.mark.parametrize("n,copies,k", [(3000, 1, 30), (16712, 1, 30),
                                        (3000, 300, 12), (2000, 50, 30)])
def test_compaction_rounds_hold_the_plain_support(n, copies, k):
    """Every round holds at most GCAP groups; the rounds together are the
    qualifying groups in order; their members hold every token of the plain
    support (sim >= th), and each qualifying group holds one."""
    rng = np.random.default_rng(n + copies)
    base = rng.standard_normal((n // copies, 16)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (copies, 1))[:n])
    qk = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    ops = apx.prep2(qk, None, mk, None, None)
    geom = apx.Geometry.of(n, 512)
    seg = apx.segmax_plain(ops, geom)
    _, th = apx.threshold(seg, k)
    sim = apx.similarity2_plain(ops)
    for q in range(qk.shape[0]):
        row, t = seg[q].numpy(), float(th[q, 0])
        rounds = compact_rounds(row, t, DR["GCAP"])
        assert all(len(r) <= DR["GCAP"] for r in rounds)
        flat = [g for r in rounds for g in r]
        want = np.nonzero((row >= t) & (row > -np.inf))[0].tolist()
        assert flat == want
        members = {(g // geom.width) * geom.n_tile + j * geom.width +
                   g % geom.width for g in flat for j in range(geom.group)}
        support = set(torch.nonzero(sim[q] >= t).flatten().tolist())
        assert support <= members
        for g in flat:
            toks = [(g // geom.width) * geom.n_tile + j * geom.width +
                    g % geom.width for j in range(geom.group)]
            assert any(x in support for x in toks if x < n)
        if copies == 300:
            assert len(rounds) > 1  # ties overflow one round


@pytest.mark.parametrize("q", [1, 31, 32, 33, 1619, 1620, 1621, 8100])
@pytest.mark.parametrize("o", [1, 2, 3, 6])
def test_denom_readout_launch_covers_rows_and_columns(q, o):
    """For ragged Q and C = o*512 (and one float less), the kernel's indexing
    as written in denom_readout.cu: the grid of ceil(Q / ROWS) blocks gives
    each query row exactly one warp (q = block * ROWS + warp, warps past Q
    leave), and lane l's VPL vectors of V floats at col0 + (v*32 + l)*V, over
    column blocks of 32*VPL*V, give each column exactly one lane."""
    rows, vpl = DR["ROWS"], DR["VPL"]
    blocks = -(-q // rows)
    qs = (np.arange(blocks)[:, None] * rows + np.arange(rows)[None, :])
    qs = qs[qs < q]
    assert np.array_equal(np.sort(qs), np.arange(q))
    for c in (o * 512, o * 512 - 1):
        for v in ((4, 1) if c % 4 == 0 else (1,)):
            cols = []
            for col0 in range(0, c, 32 * vpl * v):
                start = col0 + (np.arange(vpl)[:, None] * 32 +
                                np.arange(32)[None, :]).ravel() * v
                start = start[start < c]
                cols.append((start[:, None] + np.arange(v)).ravel())
            cols = np.concatenate(cols)
            assert np.array_equal(np.sort(cols), np.arange(c)), (c, v)


def test_every_geometry_suits_the_kernels():
    """segmax.cu takes widths that are multiples of its 64 group columns;
    denom_readout.cu rows of group maxima whose length is a multiple of 4."""
    gt = int(re.search(r"constexpr int GT = (\d+);",
                       (CSRC / "segmax.cu").read_text()).group(1))
    for n_tile in (512, 1024):
        for n in range(1, 40_000, 97):
            g = apx.Geometry.of(n, n_tile)
            assert g.width % gt == 0 and g.nseg % 4 == 0, (n, g)


def test_denom_readout_shared_memory_fits_the_sm():
    """denom_readout.cu's shared words per warp, from its own constants: a
    block of ROWS warps fits an SM of the H100 (227 KB)."""
    src = (CSRC / "denom_readout.cu").read_text()
    assert "WARP_WORDS = KC_MAX + BINS + GCAP + 2 * SCAP + 2 * CCAP" in src
    assert "SCAP = GCAP * GROUP_MAX" in src
    words = (DR["KC_MAX"] + DR["BINS"] + DR["GCAP"] +
             2 * DR["GCAP"] * DR["GROUP_MAX"] + 2 * DR["CCAP"])
    assert DR["ROWS"] * words * 4 <= 232448


def _ops(q=10, n=300, ck=8):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return apx.prep2(t(q, ck), t(q, ck).abs(), t(n, ck), None, None)


@pytest.mark.parametrize("case", ["k0", "seg_shape", "th_shape",
                                  "misaligned"])
def test_wrappers_reject_before_building(case):
    ops = _ops()
    geom = apx.Geometry.of(300, 512)
    seg = torch.zeros((10, geom.nseg))
    values = torch.zeros((300, 64))
    if case == "k0":
        call = lambda: apx._denom_readout_cuda(ops, geom, seg, values, 0)
    elif case == "seg_shape":
        call = lambda: apx._denom_readout_cuda(ops, geom, seg[:, :64],
                                               values, 30)
    elif case == "th_shape":
        call = lambda: apx._denom_readout_cuda(ops, geom, seg, values, 30,
                                               torch.zeros(10))
    else:
        buf = torch.zeros(10 * 16 + 1)
        call = lambda: apx._segmax_cuda(
            ops._replace(qcat=buf[1:].view(10, 16)), geom)
    with pytest.raises(ValueError):
        call()
