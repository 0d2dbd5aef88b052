"""Train/val video filter lists (dataset metadata, stored under subsets/).

A copy of deva_tpu/utils/load_subset.py (host-only code: the port imports
nothing of deva_tpu): the training lists and the one the referring drivers
read.

Behavioral anchor: reference:deva/utils/load_subset.py:8-23.
"""
import os

_SUBSET_DIR = os.path.join(os.path.dirname(__file__), "subsets")


def _load(name: str) -> set:
    with open(os.path.join(_SUBSET_DIR, name)) as f:
        return set(f.read().splitlines())


def load_sub_davis() -> set:
    return _load("davis_subset.txt")


def load_sub_yv() -> set:
    return _load("yv_subset.txt")


def load_referring_yv_val() -> set:
    return _load("referring-youtubevos-val.txt")
