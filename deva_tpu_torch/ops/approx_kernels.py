"""Fused threshold-approx memory attention: group maxima of the similarity,
a threshold, then the softmax and readout over the threshold's support. No
dense [Q, N] matrix is built on a CUDA device.

Port of the approx half of deva_tpu/ops/pallas_attention.py (`_prep2`,
`_segmax_pass`, `_denom_readout_pass`, `attend_pallas_approx_multi`,
`attend_pallas_approx`). Semantics:

- The similarity takes the one-product form
  (qcat . mcat - sub) * msv with qcat = [2*qk*qe ; -qe], mcat = [mk ; mk^2]
  and sub = sum(qe*qk^2), or qcat = 2*qk, mcat = mk, sub = sum(mk^2) without
  a selection (`prep2`); invalid and padded slots are -inf.
- `segmax`: the token axis is cut into tiles of `n_tile` tokens, and group g
  of a tile is {g, g+W, g+2W, ...} with W = n_tile >> folds (`Geometry`).
  The result [Q, nseg] holds each group's max.
- `denom_readout`: rmax = the row max of the group maxima (0 if not
  finite), th = the min(k, nseg)-th largest group max (`threshold`), exact,
  as deva_tpu's interpret mode takes it (on a TPU deva_tpu takes it with
  approx_max_k, which can only lower it); then e = exp(sim - rmax) where
  sim >= th, aff = e / max(sum e, 1e-30), out = aff @ V, usage = aff summed
  over queries. The support contains the exact top-k; a row with fewer than
  k valid tokens keeps all of them, and a row with none gives zeros. The
  CUDA kernel takes rmax and th itself, so nothing runs between the two
  kernels.

A video axis, as in attention_kernels.py: every function also takes B
videos with their own rings (a leading B on every operand: qcat [B, Q, Kc],
mcat [B, N, Kc], seg [B, Q, nseg], out [B, Q, C], usage [B, N], rmax and th
[B, Q, 1]); on a CUDA device one launch of each kernel serves them all, and
each video's rmax, th and group maxima are bitwise those of its own launch.
The geometry (N, n_tile) is shared; rmax and th are per query row, so per
video without further work.

Ring dtypes: mk and ms may be f32 or bf16; `prep2` builds mcat in f32 from
the widened keys, as deva_tpu's `_prep2` does (pallas_attention.py:388-394;
mk^2 of a bf16 key is exact in f32), so segmax and denom_readout see the
same float per (q, n) on either ring. The value ring may be f32 or bf16:
on bf16, denom_readout rounds the normalised weight aff = e * invd to bf16
before the product (pallas_attention.py:524-532), sums in f32, and takes
usage from the f32 aff; the twin does the same.

Dispatch is by device only, as in attention_kernels.py: CPU tensors take the
plain twins (`*_plain`), CUDA tensors launch csrc/segmax.cu and
csrc/denom_readout.cu or raise. Launches count in attention_kernels.LAUNCHES.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from deva_tpu_torch.ops import memory_attention as ma
from deva_tpu_torch.ops.attention_kernels import (LAUNCHES, RING_DTYPES,
                                                  _on_cuda, _ptr, _require,
                                                  _ring_dtype, _stream,
                                                  _videos)
from deva_tpu_torch.ops.cuda_build import KernelError


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Geometry(NamedTuple):
    """The group partition of the token axis (pallas_attention.py:380-386,
    464-475)."""
    n: int          # ring tokens
    n_tile: int     # tokens per tile
    folds: int      # a group holds 2**folds tokens, W apart

    @classmethod
    def of(cls, n: int, n_tile: int) -> "Geometry":
        """Rings shorter than n_tile use one tile of round_up(max(n, 128),
        128); folds is the largest of 2 or 1 that leaves W a multiple of
        128, else 0."""
        if n < n_tile:
            n_tile = _round_up(max(n, 128), 128)
        folds = next((f for f in (2, 1) if (n_tile >> f) % 128 == 0), 0)
        return cls(n, n_tile, folds)

    @property
    def width(self) -> int:
        return self.n_tile >> self.folds

    @property
    def group(self) -> int:
        return 1 << self.folds

    @property
    def tiles(self) -> int:
        return -(-self.n // self.n_tile)

    @property
    def nseg(self) -> int:
        return self.tiles * self.width


def default_n_tile(c: int, itemsize: int) -> int:
    """The adaptive tile width of attend_pallas_approx_multi: 1024 tokens
    when a value row (round_up(C, 128) * itemsize bytes) takes at most 3072
    bytes, else 512."""
    return 1024 if _round_up(c, 128) * itemsize <= 3072 else 512


class Operands(NamedTuple):
    """`prep2`'s operands, unpadded: qcat [Q, Kc], mcat [N, Kc], bsq [Q]
    (with a selection) or msq [N] (without one), msv [N], valid [N] bool or
    None; each with a leading B for B videos."""
    qcat: torch.Tensor
    mcat: torch.Tensor
    bsq: Optional[torch.Tensor]
    msq: Optional[torch.Tensor]
    msv: torch.Tensor
    valid: Optional[torch.Tensor]


def prep2(qk, qe, mk, ms, valid) -> Operands:
    """The operands of the one-product similarity (pallas_attention.py:
    380-415), in the same operation order; per video for B videos."""
    ck = qk.shape[-1]
    qk = qk.float()
    mk = mk.float()
    if qe is not None:
        qe = qe.float()
        qcat = torch.cat([2.0 * qk * qe, -qe], dim=-1)
        mcat = torch.cat([mk, mk * mk], dim=-1)
        bsq = torch.sum(qe * qk * qk, dim=-1)
        msq = None
    else:
        qcat = (2.0 * qk).contiguous()
        mcat = mk.contiguous()
        bsq = None
        msq = torch.sum(mk * mk, dim=-1)
    msv = ms.float() / math.sqrt(ck) if ms is not None else \
        torch.full(mk.shape[:-1], 1.0 / math.sqrt(ck), device=mk.device)
    return Operands(qcat, mcat, bsq, msq, msv.contiguous(), valid)


def similarity2_plain(ops: Operands) -> torch.Tensor:
    """The dense [Q, N] similarity of the pair ([B, Q, N] for B videos),
    -inf on invalid slots."""
    sim = ops.qcat @ ops.mcat.transpose(-1, -2)
    sub = ops.bsq[..., :, None] if ops.bsq is not None else \
        ops.msq[..., None, :]
    return ma.mask_invalid((sim - sub) * ops.msv[..., None, :], ops.valid)


def _check_cuda_operands(ops: Operands, kernel: str):
    """Raises for operands the kernels do not take; returns the leading
    video shape (() or (B,))."""
    lead = _videos(ops.qcat, 2)
    q, kc = ops.qcat.shape[-2:]
    n = ops.mcat.shape[-2]
    if kc > 128 or kc % 4:
        raise KernelError(f"{kernel}: operand width {kc} must be a multiple "
                          "of 4 and at most 128")
    f32 = torch.float32
    _require(ops.qcat, "qcat", f32, (*lead, q, kc))
    _require(ops.mcat, "mcat", f32, (*lead, n, kc))
    if ops.qcat.data_ptr() % 16 or ops.mcat.data_ptr() % 16:
        raise KernelError(f"{kernel}: qcat and mcat must be 16-byte aligned")
    _require(ops.msv, "msv", f32, (*lead, n))
    if ops.bsq is not None:
        _require(ops.bsq, "bsq", f32, (*lead, q))
    else:
        _require(ops.msq, "msq", f32, (*lead, n))
    if ops.valid is not None:
        _require(ops.valid, "valid", torch.bool, (*lead, n))
    return lead


def _valid_u8(ops: Operands):
    return None if ops.valid is None else ops.valid.view(torch.uint8)


# --------------------------------------------------------------------------
# segmax
# --------------------------------------------------------------------------

def segmax_plain(ops: Operands, geom: Geometry) -> torch.Tensor:
    """Plain twin of segmax: the dense similarity, padded with -inf to whole
    tiles and reduced over each tile's strided groups."""
    sim = similarity2_plain(ops)
    lead, q = sim.shape[:-2], sim.shape[-2]
    pad = geom.tiles * geom.n_tile - geom.n
    sim = torch.nn.functional.pad(sim, (0, pad), value=float("-inf"))
    return sim.reshape(*lead, q, geom.tiles, geom.group, geom.width) \
              .amax(-2).reshape(*lead, q, geom.nseg)


def _segmax_cuda(ops: Operands, geom: Geometry) -> torch.Tensor:
    """Launches csrc/segmax.cu, the port of the Pallas `_segmax_kernel`
    (deva_tpu/ops/pallas_attention.py:451-488), for one video or B (a grid
    dimension). It is bound by the f32 FFMA rate (Q*N*Kc FFMAs per video,
    no TF32); it folds each tile to its group maxima in registers, so only
    [Q, nseg] reaches device memory (see the source note)."""
    from deva_tpu_torch.ops import cuda_build
    lead = _check_cuda_operands(ops, "segmax")
    q, kc = ops.qcat.shape[-2:]
    out = torch.empty((*lead, q, geom.nseg), dtype=torch.float32,
                      device=ops.qcat.device)
    err = cuda_build.load().deva_segmax(
        _ptr(ops.qcat), _ptr(ops.mcat), _ptr(ops.bsq), _ptr(ops.msq),
        _ptr(ops.msv), _ptr(_valid_u8(ops)), lead[0] if lead else 1, q,
        geom.n, kc, geom.n_tile, geom.folds, _ptr(out), _stream(out.device))
    if err != 0:
        raise KernelError(f"segmax kernel launch failed: CUDA error {err}")
    LAUNCHES["segmax"] += 1
    return out


def segmax(ops: Operands, geom: Geometry) -> torch.Tensor:
    """Group maxima of the similarity: [Q, geom.nseg] f32 ([B, Q, nseg] for
    B videos)."""
    if _on_cuda(*ops):
        return _segmax_cuda(ops, geom)
    return segmax_plain(ops, geom)


def threshold(seg: torch.Tensor, top_k: int):
    """-> (rmax [Q, 1], th [Q, 1]) from the group maxima: the row max,
    clamped to 0 when not finite, and the min(k, nseg)-th largest group max
    (pallas_attention.py:627-643, its exact branch). The CPU route's; the
    CUDA denom_readout takes both itself, bitwise the same."""
    rmax = seg.amax(dim=-1, keepdim=True)
    rmax = torch.where(torch.isfinite(rmax), rmax, torch.zeros_like(rmax))
    kk = min(top_k, seg.shape[-1])
    th = torch.topk(seg, kk, dim=-1).values[..., -1:]
    return rmax.contiguous(), th.contiguous()


# --------------------------------------------------------------------------
# denom_readout
# --------------------------------------------------------------------------

def _support_weights(sim, rmax, th):
    """aff [Q, N] of the threshold softmax over the dense similarity."""
    e = torch.where(sim >= th, torch.exp(sim - rmax), torch.zeros_like(sim))
    den = e.sum(dim=-1, keepdim=True)
    return e * (1.0 / torch.clamp(den, min=1e-30))


def denom_readout_plain(ops: Operands, geom: Geometry, seg, rmax, th,
                        values2d):
    """The dense form of denom_readout at a given rmax and th [Q, 1]: e,
    the denominator, aff @ V and aff.sum(0); aff is rounded to the value
    ring's dtype for the product only. (seg and geom are what the kernel
    reads to find the support; the dense form needs neither.)"""
    aff = _support_weights(similarity2_plain(ops), rmax, th)
    return aff.to(values2d.dtype).float() @ values2d.float(), \
        aff.sum(dim=-2)


def gap_threshold(sim: torch.Tensor, th: torch.Tensor,
                  eps: float = 1e-3) -> torch.Tensor:
    """For checking denom_readout against its twin: per row, a threshold at
    or below th [Q, 1] that lies in a gap wider than 2*eps between two of
    the row's similarities sim [Q, N] (th itself where there is none). Which
    entries reach it does not depend on how a similarity was rounded, so the
    kernel and the twin keep the same support."""
    s = sim.sort(dim=-1, descending=True).values
    ok = (s[..., :-1] <= th) & (s[..., :-1] - s[..., 1:] > 2 * eps)
    first = ok.float().argmax(dim=-1, keepdim=True)
    mid = (s.gather(-1, first) + s.gather(-1, first + 1)) / 2
    return torch.where(ok.any(-1, keepdim=True), mid, th)


def _denom_readout_cuda(ops: Operands, geom: Geometry, seg, values2d,
                        top_k: int, th=None):
    """Launches csrc/denom_readout.cu, the port of the Pallas
    `_denom_readout_kernel` (deva_tpu/ops/pallas_attention.py:491-575) with
    the row max and threshold taken between deva_tpu's two kernels, for one
    video or B (a grid dimension). It is bound by the bytes of the group
    maxima and of the support's value rows; instead of the TPU's dense
    affinity-times-values product, a warp per query selects th from the
    candidates of its row of group maxima (those at or above a lower bound
    from the lanes' maxima), recomputes the support's similarities with
    segmax's device function and gathers their rows (see the source note).
    bf16 value rows are widened at load, each normalised weight rounded to
    bf16 first."""
    from deva_tpu_torch.ops import cuda_build
    lead = _check_cuda_operands(ops, "denom_readout")
    q, kc = ops.qcat.shape[-2:]
    n, c = values2d.shape[-2:]
    if top_k < 1:
        raise KernelError(f"denom_readout: top_k={top_k} < 1")
    f32 = torch.float32
    _require(seg, "segmax", f32, (*lead, q, geom.nseg))
    rdt = _ring_dtype((values2d,), "denom_readout")
    _require(values2d, "values", rdt, (*lead, geom.n, c))
    if th is not None:
        _require(th, "th", f32, (*lead, q, 1))
    dev = values2d.device
    # the 16-byte path: whole 16-byte vectors per row, an aligned ring
    vec = c % (16 // values2d.element_size()) == 0 and \
        values2d.data_ptr() % 16 == 0
    out = torch.empty((*lead, q, c), dtype=f32, device=dev)
    usage = torch.zeros((*lead, n), dtype=f32, device=dev)
    used = torch.empty((2, *lead, q, 1), dtype=f32, device=dev)  # rmax, th
    err = cuda_build.load().deva_denom_readout(
        _ptr(ops.qcat), _ptr(ops.mcat), _ptr(ops.bsq), _ptr(ops.msq),
        _ptr(ops.msv), _ptr(_valid_u8(ops)), _ptr(seg), _ptr(th),
        _ptr(values2d), RING_DTYPES[rdt], lead[0] if lead else 1, q, n, kc,
        geom.n_tile, geom.folds, c, top_k, int(vec), _ptr(out), _ptr(usage),
        _ptr(used[0]), _ptr(used[1]), _stream(dev))
    if err != 0:
        raise KernelError(
            f"denom_readout kernel launch failed: CUDA error {err}")
    LAUNCHES["denom_readout"] += 1
    return out, usage, used[0], used[1]


def _denom_readout_twin(ops: Operands, geom: Geometry, seg, values2d,
                        top_k: int, th=None):
    """Plain twin of denom_readout: `threshold`, then denom_readout_plain."""
    rmax, th_k = threshold(seg, top_k)
    th = th_k if th is None else th
    out, usage = denom_readout_plain(ops, geom, seg, rmax, th, values2d)
    return out, usage, rmax, th


def denom_readout(ops: Operands, geom: Geometry, seg: torch.Tensor,
                  values2d: torch.Tensor, top_k: int,
                  th: Optional[torch.Tensor] = None):
    """Threshold softmax + readout from the group maxima seg: out [Q, C]
    f32, usage [N] f32, and the rmax [Q, 1] and th [Q, 1] it used. th, if
    given, replaces the k-th largest group max. values2d: [N, C]
    token-major (C = O*Cv). A leading B on every tensor: B videos."""
    if _on_cuda(*ops, seg, values2d, th):
        return _denom_readout_cuda(ops, geom, seg, values2d, top_k, th)
    return _denom_readout_twin(ops, geom, seg, values2d, top_k, th)


def sim2_at(ops: Operands, idx: torch.Tensor) -> torch.Tensor:
    """The pair's similarity at tokens idx [Q, K] -> [Q, K], -inf where an
    index lies outside [0, N): on a CUDA device, the very floats the kernels
    compare with th (a check of the support, not a step of the path)."""
    if not _on_cuda(*ops, idx):
        n = ops.mcat.shape[0]
        sim = torch.nn.functional.pad(similarity2_plain(ops), (0, 1),
                                      value=float("-inf"))
        idx = idx.long()
        return sim.gather(1, torch.where((idx >= 0) & (idx < n), idx, n))
    from deva_tpu_torch.ops import cuda_build
    _check_cuda_operands(ops, "sim2_at")
    q, kc = ops.qcat.shape
    _require(idx, "idx", torch.int32, (q, idx.shape[1]))
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    err = cuda_build.load().deva_sim2_at(
        _ptr(ops.qcat), _ptr(ops.mcat), _ptr(ops.bsq), _ptr(ops.msq),
        _ptr(ops.msv), _ptr(_valid_u8(ops)), _ptr(idx), q, ops.mcat.shape[0],
        kc, idx.shape[1], _ptr(out), _stream(idx.device))
    if err != 0:
        raise KernelError(f"sim2_at kernel launch failed: CUDA error {err}")
    return out


# --------------------------------------------------------------------------
# the composites
# --------------------------------------------------------------------------

def _concat_rings(rings):
    """[(mk, ms|None, values, valid|None), ...] -> one ring, as
    attend_pallas_approx_multi concatenates them (pallas_attention.py:
    597-609), along the token axis (axis 1 for B videos)."""
    if len(rings) == 1:
        return rings[0]
    mk = torch.cat([r[0] for r in rings], dim=-2)
    ms = None if all(r[1] is None for r in rings) else torch.cat(
        [r[1] if r[1] is not None else
         torch.ones(r[0].shape[:-1], dtype=r[0].dtype, device=r[0].device)
         for r in rings], dim=-1)
    values = torch.cat([r[2] for r in rings], dim=-3)
    valid = None if all(r[3] is None for r in rings) else torch.cat(
        [r[3] if r[3] is not None else
         torch.ones(r[0].shape[:-1], dtype=torch.bool, device=r[0].device)
         for r in rings], dim=-1)
    return mk, ms, values, valid


def _attend_multi(seg_fn, dr_fn, rings, qk, qe, top_k, return_usage, n_tile):
    lead = _videos(qk, 2)
    q = qk.shape[-2]
    mk, ms, values, valid = _concat_rings(rings)
    n, o, cv = values.shape[-3:]
    if n_tile is None:
        n_tile = default_n_tile(o * cv, values.element_size())
    geom = Geometry.of(n, n_tile)
    ops = prep2(qk, qe, mk, ms, valid)
    seg = seg_fn(ops, geom)
    out, usage, _, _ = dr_fn(ops, geom, seg,
                             values.reshape(*lead, n, o * cv), top_k)
    out = out.reshape(*lead, q, o, cv).transpose(-3, -2)
    if not return_usage:
        return out
    lens = [r[0].shape[-2] for r in rings]
    return out, list(torch.split(usage, lens, dim=-1))


def attend_approx_multi(rings: Sequence, qk: torch.Tensor,
                        qe: Optional[torch.Tensor], top_k: int,
                        return_usage: bool = False,
                        n_tile: Optional[int] = None):
    """Threshold-approx attention over several rings at once (the serving
    shape is [long-term ring ; working ring]), concatenated on the token
    axis. rings: sequence of (mk [N, Ck], ms [N] | None, values [N, O, Cv],
    valid [N] | None). Returns out [O, Q, Cv] (f32) and, with return_usage,
    one usage [N_i] per ring. n_tile defaults to deva_tpu's adaptive
    width. With a leading B on every tensor, B videos in one launch of each
    kernel (out [B, O, Q, Cv], usage [B, N_i])."""
    return _attend_multi(segmax, denom_readout, rings, qk, qe, top_k,
                         return_usage, n_tile)


def attend_approx_multi_plain(rings: Sequence, qk, qe, top_k: int,
                              return_usage: bool = False,
                              n_tile: Optional[int] = None):
    """Plain twin of attend_approx_multi."""
    return _attend_multi(segmax_plain, _denom_readout_twin, rings, qk, qe,
                         top_k, return_usage, n_tile)


def attend_approx(mk: torch.Tensor, ms: Optional[torch.Tensor],
                  values: torch.Tensor, qk: torch.Tensor,
                  qe: Optional[torch.Tensor], top_k: int,
                  valid: Optional[torch.Tensor] = None,
                  return_usage: bool = False,
                  n_tile: Optional[int] = None):
    """Single-ring form (attend_pallas_approx), with attend_topk's signature.
    values: [N, O, Cv] token-major. When N <= 128 a group is one token, so
    the result is exact top-k (ties included)."""
    res = attend_approx_multi([(mk, ms, values, valid)], qk, qe, top_k,
                              return_usage, n_tile)
    if return_usage:
        out, (usage,) = res
        return out, usage
    return res
