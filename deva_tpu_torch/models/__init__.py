from deva_tpu_torch.models.network import DEVANetwork

__all__ = ["DEVANetwork"]
