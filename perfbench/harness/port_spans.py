"""The spans and counters a traced run puts around the port's calls.

Nothing here edits the port: the model's four modes are wrapped on the
model object, the attention entries and the kernels' launch functions on
their classes and modules in this process (harness/trace.py). Only a
`--trace 1` run installs them.
"""
from __future__ import annotations

import torch

from harness.trace import MODES, Tracer


def _lead(t: torch.Tensor, ndim: int) -> int:
    return t.shape[0] if t.dim() == ndim + 1 else 1


def _valid_tokens(tracer, launch, valid, b, n):
    if valid is None:
        launch["nv"] = b * n
    else:
        tracer.count_on_device(launch, "nv", lambda: valid.sum())


def install(tracer: Tracer, net) -> None:
    if not tracer.enabled:
        return
    from deva_tpu_torch.inference import batched, fused_step, memory
    from deva_tpu_torch.ops import approx_kernels as apx
    from deva_tpu_torch.ops import attention_kernels as ak

    for mode in MODES:
        tracer.wrap(net, mode, "pb.mode." + mode)
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.register_forward_hook(tracer.flops_hook)
    for owner, attr in ((batched.BatchedPropagator, "_attend_and_count"),
                        (fused_step.FusedStepper, "_attend_rings"),
                        (memory.MemoryEngine, "match_memory")):
        tracer.wrap(owner, attr, "pb.attention")

    def sim_topk(args, kwargs, out):
        qk, qe, mk, ms, valid, top_k = args[:6]
        b, (q, ck), n = _lead(qk, 2), qk.shape[-2:], mk.shape[-2]
        launch = {"b": b, "q": q, "n": n, "ck": ck, "k": out[0].shape[-1],
                  "isz": mk.element_size()}
        _valid_tokens(tracer, launch, valid, b, n)
        tracer.launches["sim_topk"].append(launch)

    def topk_readout(args, kwargs, out):
        indices, weights, values = args[:3]
        segs = tuple(values) if isinstance(values, (tuple, list)) else \
            (values,)
        b, (q, k) = _lead(indices, 2), indices.shape[-2:]
        ntot = sum(s.shape[-2] for s in segs)
        launch = {"b": b, "q": q, "k": k, "c": segs[0].shape[-1],
                  "isz": segs[0].element_size()}

        def rows():
            # the distinct (video, row) pairs the indices name
            idx = indices.long().clamp(0, ntot - 1).reshape(b, -1) + \
                ntot * torch.arange(b, device=indices.device)[:, None]
            mark = torch.zeros(b * ntot, dtype=torch.bool,
                               device=indices.device)
            mark[idx.reshape(-1)] = True
            return mark.sum()

        tracer.count_on_device(launch, "rows", rows)
        tracer.launches["topk_readout"].append(launch)

    def segmax(args, kwargs, out):
        ops, geom = args[:2]
        b, (q, kc) = _lead(ops.qcat, 2), ops.qcat.shape[-2:]
        launch = {"b": b, "q": q, "n": geom.n, "kc": kc, "nseg": geom.nseg}
        _valid_tokens(tracer, launch, ops.valid, b, geom.n)
        tracer.launches["segmax"].append(launch)

    def denom_readout(args, kwargs, out):
        ops, geom, seg, values2d = args[:4]
        th = out[3]
        b, (q, kc) = _lead(ops.qcat, 2), ops.qcat.shape[-2:]
        launch = {"b": b, "q": q, "n": geom.n, "kc": kc, "nseg": geom.nseg,
                  "c": values2d.shape[-1], "isz": values2d.element_size()}
        _valid_tokens(tracer, launch, ops.valid, b, geom.n)
        # the groups whose maximum reaches the threshold each hold at least
        # one entry of the support, and each such group column at least one
        # value row: lower bounds of the work these inputs need
        hit = lambda: (seg >= th) & torch.isfinite(seg)
        tracer.count_on_device(launch, "entries", lambda: hit().sum())
        tracer.count_on_device(launch, "rows",
                               lambda: hit().any(-2).sum())
        tracer.launches["denom_readout"].append(launch)

    for module, attr, kernel, on_call in (
            (ak, "_sim_topk_cuda", "sim_topk", sim_topk),
            (ak, "_topk_readout_cuda", "topk_readout", topk_readout),
            (apx, "_segmax_cuda", "segmax", segmax),
            (apx, "_denom_readout_cuda", "denom_readout", denom_readout)):
        tracer.wrap(module, attr, "pb.kernel." + kernel, on_call)
