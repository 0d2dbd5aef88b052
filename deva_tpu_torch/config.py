"""Typed configuration for deva_tpu_torch.

Same fields and defaults as deva_tpu/config.py, so command-line flags and
`flat_config` match between the two packages. Two dtypes are configurable,
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

    # detection fusion (InferenceCore.incorporate_detection and
    # evaluation/eval_with_detections_torch.py)
    max_missed_detection_count: int = 10
    max_num_objects: int = -1
    detection_every: int = 5
    num_voting_frames: int = 3

    # Attention dispatch, one rule for the whole port:
    # - topk_method: 'auto' and 'exact' resolve to exact top-k on every
    #   device; 'approx' is deva_tpu's threshold method (the support
    #   {sim >= t} contains the exact top-k).
    # - The fused step (inference/fused_step.py) has one attention route per
    #   method, deva_tpu's FusedStepper(use_pallas=True): exact goes to
    #   ops/attention_kernels.attend_topk, approx to
    #   ops/approx_kernels.attend_approx{,_multi}. A CUDA tensor launches the
    #   hand-written kernels of deva_tpu_torch/csrc, a CPU tensor takes their
    #   plain PyTorch twins. So use_pallas_attention is kept for flat_config
    #   and command-line parity and changes nothing here; deva_tpu's v5e
    #   shape policy (FusedStepper.PALLAS_MIN_TOKENS) is not ported.
    # - The composed path (MemoryEngine.match_memory) follows deva_tpu's
    #   memory.py: exact through attend_topk, approx through the dense
    #   threshold form of ops/memory_attention.topk_softmax.
    use_pallas_attention: object = "auto"
    topk_method: str = "auto"
    # InferenceCore.step_chunk: encode a block's frames as one batch and
    # attend with all their query rows at once (FusedStepper._run_preenc)
    preencode_blocks: bool = False
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (deva_tpu/config.py:TrainConfig; per-stage
    values: reference:deva/utils/configuration.py:45-64)."""
    batch_size: int = 16
    num_frames: int = 8
    num_ref_frames: int = 3
    lr: float = 1e-5
    weight_decay: float = 0.05
    iterations: int = 150_000
    steps: tuple = (120_000, 140_000)
    gamma: float = 0.1
    clip_grad_norm: float = 3.0
    deep_update_prob: float = 0.2
    max_num_obj: int = 3
    # bootstrapped CE schedule (reference:deva/model/losses.py:24-45)
    start_warm: int = 20_000
    end_warm: int = 70_000
    amp_dtype: str = "bfloat16"
    # recompute each sub-module call of the unrolled recurrence in the
    # backward pass (torch.utils.checkpoint) instead of keeping its
    # activations: more operations, far less activation memory. The same
    # numbers.
    remat: bool = False


def flat_config(model: ModelConfig = ModelConfig(),
                infer: InferenceConfig = InferenceConfig()) -> dict:
    """A reference-style flat dict view of both configs."""
    d = dataclasses.asdict(model)
    d.update(dataclasses.asdict(infer))
    return d
