from deva_tpu_torch.inference.core import InferenceCore
from deva_tpu_torch.inference.object_info import ObjectInfo

__all__ = ["InferenceCore", "ObjectInfo"]
