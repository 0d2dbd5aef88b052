"""deva_tpu_torch: the PyTorch + CUDA port of deva_tpu, for NVIDIA Hopper.

A second package beside deva_tpu (the JAX reference, which it is held
against in tests/test_torch_*.py). It imports torch, never jax, flax or
deva_tpu. The memory attention of the propagation path runs in hand-written
CUDA kernels (deva_tpu_torch/csrc, built at first use); everything else is
plain PyTorch.
"""

from deva_tpu_torch.config import InferenceConfig, ModelConfig

_LAZY = {
    "DEVANetwork": "deva_tpu_torch.models.network",
    "InferenceCore": "deva_tpu_torch.inference.core",
    "MemoryEngine": "deva_tpu_torch.inference.memory",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ModelConfig", "InferenceConfig", *_LAZY]
__version__ = "0.1.0"
