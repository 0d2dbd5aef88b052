from deva_tpu_torch.data.video_reader import VideoReader

__all__ = ["VideoReader"]
