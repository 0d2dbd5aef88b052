"""Typed configuration for reference.

Same fields and defaults as deva_tpu/config.py. Two dtypes are configurable,
each on its own:
- ModelConfig.dtype, the compute dtype of the convolutions and dense layers
  (parameters stay float32; attention, logit aggregation and the final
  prediction conv stay float32, as in deva_tpu);
- InferenceConfig.ring_dtype, the storage dtype of the memory rings' keys,
  shrinkage, selection and values (usage counts stay float32).
Each takes 'float32' or 'bfloat16'. 'auto' resolves to float32 on every
device: deva_tpu resolves it to bfloat16 only on a TPU, so on a GPU bf16
runs only when asked for ('bfloat16', or --amp in eval_vos_torch.py), as
it does in deva_tpu off the TPU. Any other name raises.
"""
from __future__ import annotations

import dataclasses

from typing import Optional

import torch


def resolve_topk_method(method: Optional[str]) -> str:
    """None/'auto'/'exact' -> 'exact'; 'approx' -> 'approx'; else raise.
    The top-k dispatch rule of the whole port (InferenceConfig's comment)."""
    if method in (None, "auto", "exact"):
        return "exact"
    if method == "approx":
        return "approx"
    raise ValueError(f"unknown top-k method {method!r}")


def resolve_dtype(name: str) -> str:
    """'auto' -> 'float32' (every backend); other names pass through."""
    return "float32" if name == "auto" else name


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _torch_dtype(name: str) -> torch.dtype:
    name = resolve_dtype(name)
    if name not in _DTYPES:
        raise NotImplementedError(
            f"dtype {name!r}: deva_tpu_torch takes 'float32', 'bfloat16' "
            "or 'auto'")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (deva_tpu/config.py:ModelConfig)."""
    pix_feat_dim: int = 512
    key_dim: int = 64
    value_dim: int = 512
    dtype: str = "auto"

    def __post_init__(self):
        _torch_dtype(self.dtype)  # raises for a dtype the port lacks

    @property
    def compute_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Inference-time knobs (deva_tpu/config.py:InferenceConfig)."""
    mem_every: int = 5
    top_k: int = 30
    # long-term memory (XMem-style)
    enable_long_term: bool = True
    enable_long_term_count_usage: bool = False
    max_mid_term_frames: int = 10    # T_max
    min_mid_term_frames: int = 5     # T_min
    num_prototypes: int = 128        # P
    max_long_term_elements: int = 10000  # LT_max

    # image sizing: resize shorter side to `size` (-1 keeps original)
    size: int = 480

    # 'auto' and 'exact' resolve to exact top-k; 'approx' is deva_tpu's
    # threshold method (the support {sim >= t} contains the exact top-k).
    # The fused step (inference/fused_step.py) takes
    # ops/attention_kernels.attend_topk for the one and
    # ops/approx_kernels.attend_approx{,_multi} for the other.
    topk_method: str = "auto"
    ring_dtype: str = "auto"

    obj_pad_buckets: tuple = (1, 2, 3, 4, 8, 16, 32, 64, 128, 256)

    def __post_init__(self):
        _torch_dtype(self.ring_dtype)  # raises for a dtype the port lacks

    def resolve_topk_method(self) -> str:
        """'auto' and 'exact' -> 'exact'; 'approx' -> 'approx'."""
        return resolve_topk_method(self.topk_method)

    @property
    def ring_torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.ring_dtype)

    def pad_objects(self, n: int) -> int:
        for b in self.obj_pad_buckets:
            if n <= b:
                return b
        return n  # beyond the largest bucket: exact (rare)
