"""Per-frame image feature cache.

A copy of deva_tpu/inference/feature_store.py (host-only code: the port
imports nothing of deva_tpu, whose package import loads jax).

Behavioral anchor: reference:deva/inference/image_feature_store.py:7-48 — a
memo cache {frame_idx: features} so consensus voting and propagation share one
encode per frame; deletion is caller-managed.
"""
from __future__ import annotations

import warnings
from typing import Dict, Tuple


class ImageFeatureStore:
    def __init__(self, encode_fn, key_fn):
        """encode_fn(image[1,H,W,3]) -> (ms_features, key_feat)
        key_fn(key_feat) -> (key, shrinkage, selection)"""
        self._encode = encode_fn
        self._key = key_fn
        self._store: Dict[int, Tuple] = {}

    def _compute(self, ti: int, image) -> None:
        ms, feat = self._encode(image)
        key, shrinkage, selection = self._key(feat)
        self._store[ti] = (ms, key, shrinkage, selection)

    def get_features(self, ti: int, image):
        if ti not in self._store:
            self._compute(ti, image)
        ms, key, shrinkage, selection = self._store[ti]
        return ms, key, shrinkage, selection

    def delete(self, ti: int) -> None:
        self._store.pop(ti, None)

    def __len__(self):
        return len(self._store)

    def __del__(self):
        if len(self._store) > 0:
            warnings.warn(f"Leaking {self._store.keys()} in the feature store")
