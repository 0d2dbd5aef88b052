"""Kernels: csrc/sim_topk.cu's share of its roofline over the window's launches
(perfbench/rooflines/sim_topk.py), in percent."""
from harness.readers import roofline_pct


def read(record):
    return roofline_pct(record, "sim_topk")
