"""Whole step: the window's operations (convolutions and dense layers from
their shapes, attention kernels from perfbench/rooflines) over the window's
seconds times the compute dtype's dense peak (perfbench/rooflines/
peaks.json), in percent."""
from harness.readers import step_flops


def read(record):
    if not record["window_s"] or not record["flops"]:
        return None
    return 100.0 * step_flops(record) / (record["window_s"] *
                                         record["peak_flops"])
