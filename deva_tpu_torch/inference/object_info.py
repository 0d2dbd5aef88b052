"""Per-object metadata (host-side).

A copy of deva_tpu/inference/object_info.py (host-only code: the port
imports nothing of deva_tpu, whose package import loads jax).

Behavioral anchor: reference:deva/inference/object_info.py:7-62 — immutable id,
category/score votes, isthing flag, and a poke counter for missed detections.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np


class ObjectInfo:
    def __init__(self,
                 id: int,
                 category_id: Optional[int] = None,
                 isthing: Optional[bool] = None,
                 score: Optional[float] = None):
        self.id = id
        self.category_ids = [category_id]
        self.scores = [score]
        self.isthing = isthing
        self.poke_count = 0  # detections since this object was last seen

    def poke(self) -> None:
        self.poke_count += 1

    def unpoke(self) -> None:
        self.poke_count = 0

    def merge(self, other: "ObjectInfo") -> None:
        self.category_ids.extend(other.category_ids)
        self.scores.extend(other.scores)

    def vote_category_id(self) -> Optional[int]:
        votes = [c for c in self.category_ids if c is not None]
        if not votes:
            return None
        # mode with smallest-value tie-break (scipy.stats.mode semantics,
        # reference:object_info.py:32-37)
        counts = Counter(votes)
        best = max(counts.values())
        return int(min(k for k, v in counts.items() if v == best))

    def vote_score(self) -> Optional[float]:
        votes = [s for s in self.scores if s is not None]
        return float(np.mean(votes)) if votes else None

    def copy_meta_info(self, other: "ObjectInfo") -> None:
        self.category_ids = other.category_ids
        self.scores = other.scores
        self.isthing = other.isthing

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return self.id == other.id

    def __repr__(self):
        return (f"(ID: {self.id}, cat: {self.category_ids}, "
                f"isthing: {self.isthing}, score: {self.scores})")
