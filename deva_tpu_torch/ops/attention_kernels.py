"""Fused exact top-k memory attention: similarity + masked top-k, softmax over
the k values, sparse readout, usage. No dense [Q, N] matrix is built.

Port of the exact path of deva_tpu/ops/pallas_attention.py (`sim_topk`,
`topk_readout`, `attend_pallas`). Each function has its plain PyTorch twin
here (`*_plain`), with the same semantics:

- `sim_topk` -> (values [Q, K] descending, indices [Q, K] int32), with
  K = min(top_k, N): a ring of fewer tokens than top_k keeps all of them
  (as deva_tpu's Pallas route, which pads N and softmaxes over the real
  tokens), and an empty ring raises, on both devices. Ties go to the lowest
  index. Invalid slots are -inf; in a row with fewer valid tokens than K
  the -inf slots carry the lowest invalid indices, so every index is in
  range.
- `topk_readout` -> out[q] = sum_k w[q, k] * V[idx[q, k]], [Q, C] f32. The
  ring V may be one [N, C] tensor or a pair of segments (V_a, V_b), read in
  place: row i is V_a[i] for i < n_a, else V_b[i - n_a].
- `attend_topk` -> the composite of `attend_pallas`: out [O, Q, Cv] and,
  optionally, per-token usage [N] (the scatter-add of the weights). Its
  values may likewise be a pair of [n_i, O, Cv] rings ([long-term ;
  working]), which it never concatenates.

A video axis: every function also takes B videos at once, each with its
own rings (the batched propagator's lockstep step): qk/qe [B, Q, Ck], mk
[B, N, Ck], ms and valid [B, N], values [B, N, O, Cv] (or two segments
[B, n_a, O, Cv], [B, n_b, O, Cv]), indices and weights [B, Q, K]; results
gain the same leading B (out [B, O, Q, Cv], usage [B, N]). Indices are local
to their video. On a CUDA device one launch of each kernel serves all B
videos (a grid dimension, per-video bases), and each video's result is
bitwise that of its own launch; 2-D calls are the single-video form.

Ring dtypes: the rings (mk, ms and the value segments) may be f32 or bf16,
one dtype per call; the queries qk and qe f32 or bf16, widened to f32 by
the wrapper (Q x Ck, small). On bf16 rings sim_topk widens each key at
load, exactly, and topk_readout rounds each weight to bf16 before the
product (deva_tpu's `aff.astype(v_ref.dtype)`,
pallas_attention.py:265) and sums in f32; the twins do the same. Any other
dtype raises: a wrapper never casts a ring to make a call work.

Dispatch is by device only. Tensors on the CPU take the plain version.
Tensors on a CUDA device launch the hand-written kernels of
deva_tpu_torch/csrc (built by cuda_build at first use) or raise: there is no
fallback. Each launch of a kernel adds one to its entry in `LAUNCHES`, which
also counts the two kernels of the approx method (ops/approx_kernels.py), so
one reset and one read cover all four.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from deva_tpu_torch.ops import memory_attention as ma
from deva_tpu_torch.ops.cuda_build import KernelError

# launches of each kernel since the last reset_launch_counts()
LAUNCHES = {"sim_topk": 0, "topk_readout": 0, "segmax": 0,
            "denom_readout": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors) -> bool:
    """True if every given tensor is on a CUDA device, False if every one is
    on the CPU; raises for a mix or another device."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise KernelError(f"tensors on mixed or unsupported devices: {kinds}")


# the dtypes a ring may have on the card, and the code the kernels take
RING_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name}: expected shape {tuple(shape)}, "
                          f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise KernelError(f"{name}: must be contiguous")


def _ring_dtype(rings, name: str) -> torch.dtype:
    """The one dtype of the ring tensors given (None entries skipped);
    raises TypeError for a dtype the kernels do not take or for a mix."""
    kinds = {t.dtype for t in rings if t is not None}
    if len(kinds) != 1 or not kinds <= RING_DTYPES.keys():
        raise TypeError(f"{name}: ring tensors must all be float32 or all "
                        f"bfloat16, got {sorted(map(str, kinds))}")
    return kinds.pop()


def _widen_query(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A bf16 query side (qk or qe, Q x Ck) widened to f32, exactly; any
    other tensor as it is (the caller's checks reject a wrong dtype)."""
    return t.float() if t is not None and t.dtype == torch.bfloat16 else t


def _videos(t: torch.Tensor, ndim: int):
    """The leading video shape of t: () for the single-video form (ndim
    dimensions), (B,) for B videos (ndim + 1); raises for anything else."""
    if t.dim() == ndim:
        return ()
    if t.dim() == ndim + 1:
        return (t.shape[0],)
    raise ValueError(f"expected {ndim} or {ndim + 1} dimensions, got "
                     f"{tuple(t.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# --------------------------------------------------------------------------
# sim_topk
# --------------------------------------------------------------------------

def _check_ring(n: int) -> None:
    if n == 0:
        raise ValueError("sim_topk: the ring holds no token")


def sim_topk_plain(qk, qe, mk, ms, valid, top_k: int):
    """Plain twin of sim_topk: the dense similarity and a stable sort (which
    keeps min(top_k, N) entries), per video when given B."""
    _check_ring(mk.shape[-2])
    sim = ma.mask_invalid(ma.get_similarity(mk, ms, qk, qe), valid)
    values, indices = ma.topk_sorted(sim, top_k)
    return values, indices.to(torch.int32)


# tiles and bounds of csrc/sim_topk.cu (tests/test_torch_sim_topk_plan.py
# holds them to the source): queries per block, tokens per tile, key
# channels, k, token-axis splits
QT, NT, CK_MAX, K_MAX, MAX_SPLITS = 64, 64, 64, 64, 32
# the fewest tiles a split of the token axis may hold (see _sim_topk_plan)
MIN_SPLIT_TILES = 3


def _sim_topk_plan(q: int, n: int, k: int, sms: int, videos: int = 1):
    """(splits, split_len) of the token axis for sim_topk's selection kernel.
    Each split is a run of whole NT-token tiles, the last one possibly
    short; together they cover n and none is empty. The plan aims at about
    2.25 blocks of QT queries per SM (of `sms`), but gives no split fewer
    than MIN_SPLIT_TILES tiles: the first tiles of every split take a full
    sort per row, so short splits multiply the selection work. Set from a
    sweep on the H100 at q=1620, k=30 (PERF.md): at each ring size it is
    within 5% of the fastest plan. k does not enter the rule. With B
    `videos` the grid holds B times the query tiles, so they count B times.
    The result does not depend on the plan."""
    n_tiles = -(-n // NT)
    q_tiles = videos * -(-q // QT)
    target = min(MAX_SPLITS, -(-9 * sms // (4 * q_tiles)))
    split_len = max(MIN_SPLIT_TILES, -(-n_tiles // target)) * NT
    return -(-n // split_len), split_len


def msv_divisor(ck: int) -> float:
    """The f32 divisor of msv = ms / d: what torch's `ms / math.sqrt(ck)`
    divides an f32 tensor by (the Python float rounded to f32)."""
    return ctypes.c_float(math.sqrt(ck)).value


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sim_topk_cuda(qk, qe, mk, ms, valid, top_k: int, plan=None):
    """Launches csrc/sim_topk.cu, the port of the Pallas `_sim_topk_kernel`
    and its candidate merge (deva_tpu/ops/pallas_attention.py:177-242): a
    selection kernel and a merge kernel, and no other device work, for one
    video or B (a grid dimension). bf16 rings are widened to f32 as each
    token tile is loaded. It is bound by the f32 FFMA rate (2*Q*N*Ck FFMAs
    per video, no TF32) and by the selection; it keeps a running top-k per
    query in shared memory, merges each tile into it with warp-wide bitonic
    or rank merges, and splits the token axis across blocks by `plan`
    ((splits, split_len), by default _sim_topk_plan's; see the source
    note)."""
    lead = _videos(qk, 2)
    q, ck = qk.shape[-2:]
    n = mk.shape[-2]
    if ck > CK_MAX:
        raise KernelError(f"sim_topk: key dim {ck} > {CK_MAX}")
    if not 1 <= top_k <= K_MAX:
        raise KernelError(f"sim_topk: top_k={top_k} outside [1, {K_MAX}]")
    _check_ring(n)
    top_k = min(top_k, n)  # as the twin's sort-and-slice
    f32 = torch.float32
    qk, qe = _widen_query(qk), _widen_query(qe)
    _require(qk, "qk", f32, (*lead, q, ck))
    rdt = _ring_dtype((mk, ms), "sim_topk")
    _require(mk, "mk", rdt, (*lead, n, ck))
    if qe is not None:
        _require(qe, "qe", f32, (*lead, q, ck))
    if ms is not None:
        _require(ms, "ms", rdt, (*lead, n))
    if valid is not None:
        _require(valid, "valid", torch.bool, (*lead, n))
        valid = valid.view(torch.uint8)
    from deva_tpu_torch.ops import cuda_build
    lib = cuda_build.load()
    dev = qk.device
    b = lead[0] if lead else 1
    splits, split_len = plan or _sim_topk_plan(q, n, top_k,
                                               _sm_count(dev.index), b)
    # two allocations: the output pair (values as f32 bits) and the
    # per-split lists
    out = torch.empty((2, *lead, q, top_k), dtype=torch.int32, device=dev)
    scratch = torch.empty((b, splits, q, top_k, 2), dtype=torch.int32,
                          device=dev)
    err = lib.deva_sim_topk(
        _ptr(qk), _ptr(qe), _ptr(mk), _ptr(ms), _ptr(valid), RING_DTYPES[rdt],
        b, q, n, ck, top_k, splits, split_len, msv_divisor(ck), _ptr(scratch),
        _ptr(out[0]), _ptr(out[1]), _stream(dev))
    if err != 0:
        raise KernelError(f"sim_topk kernel launch failed: CUDA error {err}")
    LAUNCHES["sim_topk"] += 1
    return out[0].view(f32), out[1]


def sim_topk(qk: torch.Tensor, qe: Optional[torch.Tensor], mk: torch.Tensor,
             ms: Optional[torch.Tensor], valid: Optional[torch.Tensor],
             top_k: int):
    """Exact masked top-k of the (never materialized) similarity.
    qk/qe: [Q, Ck]; mk: [N, Ck]; ms: [N] or None; valid: [N] bool or None
    (each with a leading B for B videos). Returns (values [Q, K] sorted
    descending, indices [Q, K] int32), K = min(top_k, N); raises for an
    empty ring."""
    if _on_cuda(qk, qe, mk, ms, valid):
        return _sim_topk_cuda(qk, qe, mk, ms, valid, top_k)
    return sim_topk_plain(qk, qe, mk, ms, valid, top_k)


# --------------------------------------------------------------------------
# topk_readout
# --------------------------------------------------------------------------

def _segments(values):
    """A ring given as one tensor or as a pair of segments -> a tuple."""
    return tuple(values) if isinstance(values, (tuple, list)) else (values,)


def _rows(seg: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """seg [..., n, C] at row indices local [..., Q, K] (in [0, n)), f32
    -> [..., Q, K, C]; per video when seg has a leading B."""
    seg = seg.float()
    if seg.dim() == 2:
        return seg[local]
    videos = torch.arange(seg.shape[0], device=seg.device)[:, None, None]
    return seg[videos, local]


def topk_readout_plain(indices, weights, values):
    """Plain twin of topk_readout: gather the k rows and sum. With two
    segments each row is gathered from its own segment by index arithmetic,
    so the result is bitwise that on the concatenated ring. Indices outside
    the ring contribute nothing. Each weight is rounded to the ring's dtype
    before the product."""
    idx = indices.long()
    rows, start = None, 0  # rows: [..., Q, K, C]
    for seg in _segments(values):
        n = seg.shape[-2]
        if n:
            local = idx - start
            got = _rows(seg, local.clamp(0, n - 1))
            rows = got if rows is None else torch.where(
                ((local >= 0) & (local < n))[..., None], got, rows)
        start += n
    w = weights.to(_segments(values)[0].dtype).float()
    w = torch.where((idx >= 0) & (idx < start), w, torch.zeros_like(w))
    return torch.einsum("...qk,...qkc->...qc", w, rows)


def _topk_readout_cuda(indices, weights, values):
    """Launches csrc/topk_readout.cu, the port of the Pallas
    `_readout_kernel` (deva_tpu/ops/pallas_attention.py:249-305), for one
    video or B (a grid dimension). It is bound by the bytes of the value
    rows; a block of 16 queries stages the first 64 distinct rows of its
    queries in shared memory with cp.async, once each, and reads the others
    from global memory (see the source note). A ring in two segments is read
    in place. bf16 rows are widened at load and each weight rounded to bf16
    first. The 16-byte path needs C % 4 (f32) or C % 8 (bf16) and aligned
    segments; then every video's base is aligned too."""
    from deva_tpu_torch.ops import cuda_build
    lead = _videos(indices, 2)
    q, k = indices.shape[-2:]
    segs = _segments(values)
    if len(segs) not in (1, 2):
        raise KernelError(f"topk_readout: {len(segs)} ring segments")
    c = segs[0].shape[-1]
    _require(indices, "indices", torch.int32, (*lead, q, k))
    _require(weights, "weights", torch.float32, (*lead, q, k))
    rdt = _ring_dtype(segs, "topk_readout")
    for i, seg in enumerate(segs):
        _require(seg, f"values[{i}]", rdt, (*lead, seg.shape[-2], c))
    (va, n_a), (vb, n_b) = [(s, s.shape[-2]) for s in segs] + \
        [(None, 0)] * (2 - len(segs))
    lib = cuda_build.load()
    out = torch.empty((*lead, q, c), dtype=torch.float32, device=va.device)
    # the 16-byte path: whole 16-byte vectors per row, aligned segments
    vec = c % (16 // va.element_size()) == 0 and \
        all(s.data_ptr() % 16 == 0 for s in segs)
    err = lib.deva_topk_readout(_ptr(indices), _ptr(weights), _ptr(va), n_a,
                                _ptr(vb), n_b, RING_DTYPES[rdt],
                                lead[0] if lead else 1, q, k, c, int(vec),
                                _ptr(out), _stream(va.device))
    if err != 0:
        raise KernelError(
            f"topk_readout kernel launch failed: CUDA error {err}")
    LAUNCHES["topk_readout"] += 1
    return out


def topk_readout(indices: torch.Tensor, weights: torch.Tensor,
                 values) -> torch.Tensor:
    """indices/weights: [Q, K] (token ids and weights); values: the ring,
    [N, C] (token-major, C = O*Cv), or a pair of segments [n_a, C], [n_b, C]
    read as their concatenation. Returns [Q, C] f32. With a leading B on
    every tensor, B videos at once."""
    if _on_cuda(indices, weights, *_segments(values)):
        return _topk_readout_cuda(indices, weights, values)
    return topk_readout_plain(indices, weights, values)


# --------------------------------------------------------------------------
# the composite
# --------------------------------------------------------------------------

def _attend(select, read, mk, ms, values, qk, qe, top_k, valid,
            return_usage):
    segs = _segments(values)
    lead = _videos(qk, 2)
    o, cv = segs[0].shape[-2:]
    n = sum(v.shape[-3] for v in segs)
    q = qk.shape[-2]
    gv, gi = select(qk, qe, mk, ms, valid, top_k)
    w = ma.softmax_topk_values(gv)
    flat = tuple(v.reshape(*v.shape[:-2], o * cv) for v in segs)  # views
    out = read(gi, w, flat[0] if len(flat) == 1 else flat)
    out = out.reshape(*lead, q, o, cv).transpose(-3, -2)
    if return_usage:
        usage = torch.zeros((*lead, n), dtype=torch.float32,
                            device=qk.device)
        if lead:  # each video's usage in its own row
            at = gi.long() + n * torch.arange(lead[0], device=qk.device)[
                :, None, None]
            usage.view(-1).index_add_(0, at.reshape(-1), w.reshape(-1))
        else:
            usage.index_add_(0, gi.reshape(-1).long(), w.reshape(-1))
        return out, usage
    return out


def attend_topk_plain(mk, ms, values, qk, qe, top_k: int, valid=None,
                      return_usage: bool = False):
    """Plain twin of attend_topk."""
    return _attend(sim_topk_plain, topk_readout_plain, mk, ms, values, qk, qe,
                   top_k, valid, return_usage)


def attend_topk(mk: torch.Tensor, ms: Optional[torch.Tensor],
                values: torch.Tensor, qk: torch.Tensor,
                qe: Optional[torch.Tensor], top_k: int,
                valid: Optional[torch.Tensor] = None,
                return_usage: bool = False):
    """Exact top-k attention with no dense [Q, N] affinity (the composite of
    pallas_attention.attend_pallas). values: [N, O, Cv] token-major, or a
    pair of rings [n_a, O, Cv], [n_b, O, Cv] read in place as their
    concatenation (mk, ms and valid cover all n_a + n_b tokens). Returns out
    [O, Q, Cv] (f32) and optionally the per-token usage [N]. With a leading
    B on every tensor, B videos in one launch of each kernel (out [B, O, Q,
    Cv], usage [B, N])."""
    return _attend(sim_topk, topk_readout, mk, ms, values, qk, qe, top_k,
                   valid, return_usage)
