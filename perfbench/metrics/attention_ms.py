"""Attention: device ms of the kernels launched inside the port's attention
entries (BatchedPropagator._attend_and_count, FusedStepper._attend_rings,
MemoryEngine.match_memory), per frame completed."""
from harness.readers import kernel_ms_per_frame


def read(record):
    return kernel_ms_per_frame(record, ("pb.attention",))
