from deva_tpu_torch.training.data.static_dataset import StaticTransformDataset
from deva_tpu_torch.training.data.vos_dataset import VOSDataset

__all__ = ["VOSDataset", "StaticTransformDataset"]
