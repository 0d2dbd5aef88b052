"""Model modes: device ms of the kernels launched inside encode_image,
transform_key, encode_mask and segment, per frame completed."""
from harness.readers import MODE_SPANS, kernel_ms_per_frame


def read(record):
    return kernel_ms_per_frame(record, MODE_SPANS)
