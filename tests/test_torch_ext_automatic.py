"""deva_tpu_torch's automatic frame processor
(ext/automatic_processor.py: estimate_forward_mask, auto_segment over the
unclaimed points, incorporate_detection with incremental=True) against
deva_tpu's: semi-online, and online with a perfect forward prediction.
The set-up, the comparison and its budgets are
tests/test_torch_ext_processors.py's (check_processor): the synthetic
generator of tests/test_ext_processors.py, the same seeded weights, frames
and object-id generators; saved id maps equal on at least 99% of their
pixels, differing only where the forward predictions paint another id or
deva_tpu's top two probabilities lie within 2 x 3e-3; the probabilities
within 3e-3 elsewhere; equal object tables, JSON segments, and image
encodes on every frame (estimate_forward_mask's encode of frame curr_ti + 1
is the one that the following step or incorporate_detection reuses).
"""
from test_torch_ext_processors import (check_processor,
                                       check_processor_perfect_forward)
from torch_detection_common import models  # noqa: F401


def test_automatic_processor_matches_deva_tpu(tmp_path, models):
    check_processor(tmp_path, models, "auto", "semionline")


def test_automatic_processor_strict_perfect_forward(tmp_path, models):
    check_processor_perfect_forward(tmp_path, models, "auto")
