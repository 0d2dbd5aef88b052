from deva_tpu_torch.ops.pad import pad_divide_by, unpad
from deva_tpu_torch.ops.resize import downsample_area, upsample_bilinear
from deva_tpu_torch.ops.aggregate import aggregate_logits

__all__ = [
    "pad_divide_by", "unpad", "downsample_area", "upsample_bilinear",
    "aggregate_logits",
]
