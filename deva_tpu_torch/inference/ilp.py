"""Exact solver for the in-clip consensus integer program.

A copy of deva_tpu/inference/ilp.py, its pure-Python branch-and-bound path
only: deva_tpu's native hook (deva_tpu/utils/native.py, mwis_solve of
native/devac.cpp) is not ported, so the port builds no host library. Both
solve the program exactly, so the selections agree wherever the optimum is
unique.

The reference maximizes  2 * sum_i (sum_j iou[j,i]) x_i  -  sum_i x_i  over
binary x with the constraint that no two selected segments overlap (IoU>0.5)
(reference:deva/inference/consensus_automatic.py:28-79, gurobi with a PuLP/CBC
fallback). The objective is linear, so this is a maximum-weight independent
set with weights w_i = 2*support_i - 1 on the conflict graph. Neither gurobi
nor pulp is available here; the conflict graph is tiny (segments within
num_voting_frames frames, conflicts only among IoU>0.5 pairs), so we solve
exactly with branch-and-bound per connected component, with a greedy fallback
for pathological components.
"""
from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np


def _components(n: int, adj: List[Set[int]]) -> List[List[int]]:
    seen = [False] * n
    comps = []
    for s in range(n):
        if seen[s]:
            continue
        stack, comp = [s], []
        seen[s] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        comps.append(comp)
    return comps


def _solve_component(nodes: List[int], adj: List[Set[int]],
                     w: np.ndarray, budget: int = 200000) -> List[int]:
    """Exact B&B over one component; returns selected node list."""
    nodes = sorted(nodes, key=lambda u: -w[u])
    best_val = -np.inf
    best_sel: List[int] = []
    calls = 0

    suffix = np.zeros(len(nodes) + 1)
    for i in range(len(nodes) - 1, -1, -1):
        suffix[i] = suffix[i + 1] + max(0.0, w[nodes[i]])

    def rec(i: int, cur: float, sel: List[int], banned: Set[int]):
        nonlocal best_val, best_sel, calls
        calls += 1
        if calls > budget:
            return
        if cur + suffix[i] <= best_val:
            return
        if i == len(nodes):
            if cur > best_val:
                best_val = cur
                best_sel = list(sel)
            return
        u = nodes[i]
        if u not in banned and w[u] > -np.inf:
            sel.append(u)
            rec(i + 1, cur + w[u],
                sel, banned | (adj[u] - banned))
            sel.pop()
        rec(i + 1, cur, sel, banned)

    rec(0, 0.0, [], set())
    if calls > budget:
        # greedy fallback: take positive-weight nodes best-first
        sel, banned = [], set()
        for u in nodes:
            if w[u] > 0 and u not in banned:
                sel.append(u)
                banned |= adj[u]
        return sel
    return best_sel


def solve_consensus_ilp(pairwise_iou: np.ndarray,
                        conflict: np.ndarray) -> List[bool]:
    """pairwise_iou: symmetric [N, N] support matrix; conflict: bool [N, N]
    (IoU>0.5 pairs that cannot both be selected). Returns selection flags.

    Maximizes 2*sum_i support_i*x_i - sum_i x_i s.t. x_i + x_j <= 1 on
    conflict edges — identical to the reference's program."""
    n = pairwise_iou.shape[0]
    if n == 0:
        return []
    w = 2.0 * pairwise_iou.sum(axis=0) - 1.0

    adj: List[Set[int]] = [set(np.nonzero(conflict[i])[0].tolist()) - {i}
                           for i in range(n)]
    selected = np.zeros(n, dtype=bool)
    for comp in _components(n, adj):
        for u in _solve_component(comp, adj, w):
            selected[u] = True
    return selected.tolist()
