"""Kernels: csrc/segmax.cu's share of its roofline over the window's launches
(perfbench/rooflines/segmax.py), in percent."""
from harness.readers import roofline_pct


def read(record):
    return roofline_pct(record, "segmax")
