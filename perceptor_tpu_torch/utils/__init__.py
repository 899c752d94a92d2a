from perceptor_tpu_torch.utils.cache import cache
from perceptor_tpu_torch.utils.gradients import combine_gradients, nonzero_mean, nonzero_scale
from perceptor_tpu_torch.utils.pil_image import pil_image

__all__ = ["cache", "pil_image", "nonzero_mean", "nonzero_scale", "combine_gradients"]
