from perceptor_tpu_torch.drawers.jpeg.codec import (
    compress_jpeg,
    decompress_jpeg,
    diff_round,
    quality_to_factor,
)
from perceptor_tpu_torch.drawers.jpeg.jpeg import JPEG

__all__ = ["JPEG", "compress_jpeg", "decompress_jpeg", "diff_round", "quality_to_factor"]
