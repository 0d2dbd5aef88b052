"""The index logic of deva_tpu_torch's topk_readout kernel, on the CPU: a
numpy emulation of csrc/topk_readout.cu's query tiles, hash dedup of the
tile's rows, slots claimed in any order, the staged rows and the overflow
past CAP, with the two-segment addressing, held bitwise to an
r-ordered f32 sum and within 1e-5 of the plain twin; its grid coverage and
shared memory from the source's own constants; the wrappers' argument
checks (which run before the kernel library is built); and the exact path's
callers, which read the value rings in place. The kernel itself runs only
on a card (tests/test_torch_cuda.py)."""
import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from deva_tpu_torch.ops import attention_kernels as ak

torch.set_num_threads(2)

SOURCE = Path(ak.__file__).resolve().parents[1] / "csrc" / "topk_readout.cu"
# the kernel's constants, read from the source: queries per block, columns
# per block, staged row segments, the bound on k, threads per block, blocks
# resident per SM
RD = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                          SOURCE.read_text()).group(1))
      for name in ("QT", "CS", "CAP", "K_MAX", "THREADS", "MIN_BLOCKS")}


def fmaf(a, b, c):
    """f32 a*b + c, the product exact (f64) and the sum rounded to f32: the
    same arithmetic on both sides of every bitwise comparison here."""
    return (np.float64(a) * b.astype(np.float64) +
            c.astype(np.float64)).astype(np.float32)


def table_bits(pairs: int) -> int:
    bits = 1
    while (1 << bits) < 2 * pairs:
        bits += 1
    return bits


def ring_row(segs, i):
    """Row i of the ring given as segments: V_a[i] for i < n_a, else
    V_b[i - n_a]."""
    for seg in segs:
        if i < len(seg):
            return seg[i]
        i -= len(seg)
    raise IndexError(i)


def dedup_tile(rows, n, rng):
    """The kernel's dedup of one tile's pairs (rows in pair order): inserts
    into a linear-probing table in a random order (the threads race); the
    pair that inserts a row claims the next slot. Returns (slot per pair,
    -1 outside [0, n); the row of each slot)."""
    bits = table_bits(len(rows))
    key = np.full(1 << bits, -1, np.int64)
    slot_at = np.full(1 << bits, -1, np.int64)
    slots = np.full(len(rows), -1)
    uniq = []
    for p in rng.permutation(len(rows)):
        i = int(rows[p])
        if not 0 <= i < n:
            continue
        h = ((i * 2654435761) & 0xFFFFFFFF) >> (32 - bits)
        probes = 0
        while key[h] not in (-1, i):
            h = (h + 1) & ((1 << bits) - 1)
            probes += 1
            assert probes < len(key)
        if key[h] == -1:
            key[h], slot_at[h] = i, len(uniq)
            uniq.append(i)
        slots[p] = slot_at[h]
    return slots, np.array(uniq, np.int64)


def emulate(idx, w, segs, seed=0):
    """topk_readout.cu block by block, a block being a tile of QT queries
    and a slice of CS columns that dedups its tile itself: -> (out [Q, C],
    U per tile)."""
    qt, cs, cap = RD["QT"], RD["CS"], RD["CAP"]
    q, k = idx.shape
    n = sum(len(s) for s in segs)
    c = segs[0].shape[1]
    out = np.zeros((q, c), np.float32)
    rng = np.random.default_rng(seed)
    per_tile = []
    for q0 in range(0, q, qt):
        qn = min(qt, q - q0)
        wts = w[q0:q0 + qn].ravel()
        for col0 in range(0, c, cs):
            width = min(cs, c - col0)
            # each block races to its own slots
            slots, uniq = dedup_tile(idx[q0:q0 + qn].ravel(), n, rng)
            staged = np.zeros((cap, width), np.float32)
            for u in range(min(len(uniq), cap)):
                staged[u] = ring_row(segs, uniq[u])[col0:col0 + width]
            for ql in range(qn):
                acc = np.zeros(width, np.float32)
                for r in range(k):
                    s = slots[ql * k + r]
                    if s < 0:  # the zero row, with weight 0
                        continue
                    v = staged[s] if s < cap else \
                        ring_row(segs, uniq[s])[col0:col0 + width]
                    acc = fmaf(wts[ql * k + r], v, acc)
                out[q0 + ql, col0:col0 + width] = acc
        per_tile.append(len(uniq))
    return out, per_tile


def ordered_sum(idx, w, ring):
    """out[q] = sum over r in order of fmaf(w, ring[idx]), skipping indices
    outside the ring."""
    out = np.zeros((idx.shape[0], ring.shape[1]), np.float32)
    for q in range(idx.shape[0]):
        acc = np.zeros(ring.shape[1], np.float32)
        for r in range(idx.shape[1]):
            i = idx[q, r]
            if 0 <= i < len(ring):
                acc = fmaf(w[q, r], ring[i], acc)
        out[q] = acc
    return out


def make_case(case, rng, q=37, k=30, n=300):
    """Index lists: shared by every query of a tile, all distinct (past
    CAP), repeated within a query, out of the ring, or random."""
    if case == "all_shared":
        idx = np.tile(rng.choice(n, k, replace=False), (q, 1))
    elif case == "all_distinct":
        n = max(n, q * k)
        idx = rng.permutation(n)[:q * k].reshape(q, k)
    elif case == "duplicates":
        idx = rng.integers(0, n, (q, k))
        idx[:, k // 2:] = idx[:, :k - k // 2]  # every row twice
        idx[3] = idx[3, 0]  # one query: one row k times
    elif case == "out_of_range":
        idx = rng.integers(0, n, (q, k))
        idx[rng.random((q, k)) < 0.2] = -1
        idx[0, :4] = [-7, n, n + 5, 2 ** 31 - 1]
        idx[1] = -1  # a query with no row at all
    else:
        idx = rng.integers(0, n, (q, k))
    w = rng.uniform(0, 1, (q, k)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    return idx.astype(np.int32), w, n


@pytest.mark.parametrize("split", ["none", "at_0", "middle", "at_n"])
@pytest.mark.parametrize("case", ["all_shared", "all_distinct", "duplicates",
                                  "out_of_range", "random"])
def test_emulated_kernel_is_the_ordered_sum(case, split):
    """For Q = 37 (not a multiple of QT) and C = 300 (a partial column
    slice): the emulated kernel is bitwise the r-ordered f32 sum, on one
    ring and on two segments split at 0, in the middle and at n; and within
    1e-5 of topk_readout_plain on the same segments."""
    rng = np.random.default_rng(zlib.crc32(f"{case} {split}".encode()))
    idx, w, n = make_case(case, rng)
    ring = rng.standard_normal((n, 300)).astype(np.float32)
    at = {"none": None, "at_0": 0, "middle": n // 2 + 3, "at_n": n}[split]
    segs = [ring] if at is None else [ring[:at], ring[at:]]
    want = ordered_sum(idx, w, ring)
    for seed in (0, 1):  # two orders of the threads' claims
        got, per_tile = emulate(idx, w, segs, seed)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    values = [torch.from_numpy(s) for s in segs]
    plain = ak.topk_readout_plain(torch.from_numpy(idx), torch.from_numpy(w),
                                  values[0] if at is None else values)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)
    if case == "all_shared":
        assert per_tile == [30] * len(per_tile)
    if case == "all_distinct":
        assert max(per_tile) == RD["QT"] * 30 > RD["CAP"]  # overflow


def test_two_segment_plain_is_bitwise_the_concatenated_ring():
    rng = np.random.default_rng(3)
    idx, w, n = make_case("out_of_range", rng, q=50, k=12, n=700)
    ring = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
    idx, w = torch.from_numpy(idx), torch.from_numpy(w)
    one = ak.topk_readout(idx, w, ring)
    for at in (0, 1, 512, n - 1, n):
        two = ak.topk_readout(idx, w, (ring[:at], ring[at:]))
        assert torch.equal(one.view(torch.int32), two.view(torch.int32)), at


@pytest.mark.parametrize("q", [1, 15, 16, 17, 1620])
@pytest.mark.parametrize("c", [1024, 1536, 30, 1030])
def test_launch_covers_queries_and_columns(q, c):
    """As topk_readout.cu indexes them: a grid of ceil(Q/QT) x ceil(C/CS)
    blocks whose threads own ITEMS (query, vector) items each (item
    tid + i * THREADS), skipping queries past the tile and vectors past the
    slice, gives every (query, column) exactly one item, for the vector
    path (C % 4 == 0) and the scalar one."""
    qt, cs, threads = RD["QT"], RD["CS"], RD["THREADS"]
    for vw in ((4, 1) if c % 4 == 0 else (1,)):
        sv = cs // vw
        items = -(-qt * sv // threads)
        seen = np.zeros((q, c), np.int64)
        for q0 in range(0, q, qt):
            qn = min(qt, q - q0)
            for col0 in range(0, c, cs):
                units = min(cs, c - col0) // vw
                ql, u = np.divmod(np.arange(items * threads), sv)
                keep = (ql < qn) & (u < units)
                cols = col0 + u[keep, None] * vw + np.arange(vw)
                np.add.at(seen, (q0 + ql[keep, None], cols), 1)
        assert (seen == 1).all(), (q, c, vw)


def test_shared_memory_fits_the_resident_blocks():
    """A block's shared memory (staged rows; each pair's row pointer,
    weight and slot row; a table of twice the pairs rounded up to a power
    of two, keys and slots; the zero row and the claim counter), with the
    1 KB the H100 reserves per block: MIN_BLOCKS blocks fit an SM's 228 KB
    at k <= 32 (the serving k is 30), and one block at k = K_MAX."""
    def smem(k):
        pairs = RD["QT"] * k
        return RD["CAP"] * RD["CS"] * 4 + pairs * 16 + 8 * (1 << table_bits(
            pairs)) + RD["CS"] * 4 + 4 + 1024
    assert RD["MIN_BLOCKS"] * smem(32) <= 233472
    assert smem(RD["K_MAX"]) <= 233472
    src = SOURCE.read_text()
    assert "2654435761u" in src and "(32 - bits)" in src  # dedup_tile's hash
    assert RD["CS"] % 4 == 0 and RD["K_MAX"] == ak.K_MAX


@pytest.mark.parametrize("case", ["three_segments", "columns", "dtype",
                                  "non_contiguous"])
def test_wrapper_rejects_before_building(case):
    idx = torch.zeros((4, 3), dtype=torch.int32)
    w = torch.zeros((4, 3))
    a, b = torch.zeros((5, 8)), torch.zeros((6, 8))
    values = {"three_segments": (a, b, b), "columns": (a, b[:, :4]),
              "dtype": (a, b.double()),
              "non_contiguous": (a, torch.zeros((6, 16))[:, ::2])}[case]
    error = TypeError if case == "dtype" else ValueError
    with pytest.raises(error):
        ak._topk_readout_cuda(idx, w, values)


def _engine_with_long_term():
    """A memory engine on the CPU fed 7 frames of seeded tokens: its first
    bucket has consolidated into long-term memory."""
    from deva_tpu_torch.config import InferenceConfig
    from deva_tpu_torch.inference.memory import MemoryEngine
    hw, ck, cv, o_cap = 8, 16, 8, 4
    engine = MemoryEngine(InferenceConfig(
        top_k=6, enable_long_term=True, enable_long_term_count_usage=True,
        max_mid_term_frames=3, min_mid_term_frames=1, num_prototypes=4,
        max_long_term_elements=12), cv, ck, cv, o_cap, device="cpu")
    rng = np.random.default_rng(12)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    for _ in range(7):
        engine.add_memory(key=t(rng.standard_normal((hw, ck))),
                          shrinkage=t(rng.uniform(1, 2, (hw,))),
                          value=t(rng.standard_normal((o_cap, hw, cv))),
                          selection=t(rng.uniform(0, 1, (hw, ck))),
                          obj_ids=[1, 2])
    assert engine.long_buckets[0].size > 0
    qk = t(rng.standard_normal((hw, ck)))
    qe = t(rng.uniform(0, 1, (hw, ck)))
    return engine, qk, qe


def _spy_cat(monkeypatch):
    """Records the tensors every torch.cat call joins."""
    joined = []
    real = torch.cat

    def cat(tensors, *args, **kwargs):
        joined.extend(tensors)
        return real(tensors, *args, **kwargs)

    monkeypatch.setattr(torch, "cat", cat)
    return joined


def test_attend_topk_two_rings_is_bitwise_the_concatenated_form():
    engine, qk, qe = _engine_with_long_term()
    lt, b = engine.long_buckets[0], engine.buckets[0]
    valid = torch.zeros(lt.cap + b.cap, dtype=torch.bool)  # the engine's
    valid[:lt.size] = True
    valid[lt.cap:lt.cap + b.size] = True
    mk = torch.cat([lt.key, b.key])
    ms = torch.cat([lt.shrinkage, b.shrinkage])
    one = ak.attend_topk(mk, ms, torch.cat([lt.value, b.value]), qk, qe, 6,
                         valid, return_usage=True)
    two = ak.attend_topk(mk, ms, (lt.value, b.value), qk, qe, 6, valid,
                         return_usage=True)
    for x, y in zip(one, two):
        assert torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32))


def test_exact_callers_read_the_value_rings_in_place(monkeypatch):
    """Neither the fused step's [long-term ; working] attention nor the
    composed MemoryEngine.match_memory concatenates a value ring (3-D
    [n, O, Cv]) with the exact method; the keys, shrinkage and validity
    still are (they belong to sim_topk)."""
    from deva_tpu_torch.inference.fused_step import FusedStepper
    engine, qk, qe = _engine_with_long_term()
    lt, b = engine.long_buckets[0], engine.buckets[0]
    stepper = FusedStepper(model=None, top_k=6, topk_method="exact")
    joined = _spy_cat(monkeypatch)
    rd, work_u, lt_u = stepper._attend_rings(qk, qe, b, lt, use_lt=True,
                                             work_usage=True)
    assert rd.shape == (b.o_cap, qk.shape[0], 8) and lt_u.shape == (lt.cap,)
    assert joined and all(x.dim() < 3 for x in joined), \
        [tuple(x.shape) for x in joined]
    joined.clear()
    out = engine.match_memory(qk, qe, {1: 0, 2: 1})
    assert out.shape == (engine.o_cap, qk.shape[0], 8)
    assert joined and all(x.dim() < 3 for x in joined), \
        [tuple(x.shape) for x in joined]
