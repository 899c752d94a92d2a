from perceptor_tpu_torch.utils.cache import cache
from perceptor_tpu_torch.utils.gradients import combine_gradients, nonzero_mean, nonzero_scale
from perceptor_tpu_torch.utils.pil_image import pil_image
from perceptor_tpu_torch.utils.profiling import (
    StepTimer,
    annotate,
    live_array_bytes,
    memory_stats,
    trace,
)
from perceptor_tpu_torch.utils.session import SessionManager, load_session, save_session
from perceptor_tpu_torch.utils import serving
from perceptor_tpu_torch.utils import stats

__all__ = ["cache", "pil_image", "nonzero_mean", "nonzero_scale", "combine_gradients",
           "StepTimer", "annotate", "trace", "memory_stats", "live_array_bytes",
           "save_session", "load_session", "SessionManager", "serving", "stats"]
