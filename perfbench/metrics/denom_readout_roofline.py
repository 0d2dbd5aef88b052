"""Kernels: csrc/denom_readout.cu's share of its roofline over the window's launches
(perfbench/rooflines/denom_readout.py), in percent."""
from harness.readers import roofline_pct


def read(record):
    return roofline_pct(record, "denom_readout")
