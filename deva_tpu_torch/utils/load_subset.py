"""Val video filter lists (dataset metadata, stored under subsets/).

A copy of deva_tpu/utils/load_subset.py (host-only code: the port imports
nothing of deva_tpu), with the list the referring drivers read; the training
lists come with the training port.

Behavioral anchor: reference:deva/utils/load_subset.py:8-23.
"""
import os

_SUBSET_DIR = os.path.join(os.path.dirname(__file__), "subsets")


def _load(name: str) -> set:
    with open(os.path.join(_SUBSET_DIR, name)) as f:
        return set(f.read().splitlines())


def load_referring_yv_val() -> set:
    return _load("referring-youtubevos-val.txt")
