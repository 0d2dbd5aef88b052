"""Batched / fused step: host ms inside step_all or step_block until it
returns (the device may still be working), per frame completed."""
from harness.readers import host_ms_per


def read(record):
    return host_ms_per(record, "pb.step", "frame")
