from perceptor_tpu_torch.utils.cache import cache
from perceptor_tpu_torch.utils.gradients import combine_gradients, nonzero_mean, nonzero_scale

__all__ = ["cache", "nonzero_mean", "nonzero_scale", "combine_gradients"]
