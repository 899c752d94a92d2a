from perceptor_tpu_torch.schedules.ddpm import scaled_linear_alphas_sigmas
from perceptor_tpu_torch.schedules.karras import indexed_schedule, karras_sigma_ramp

__all__ = ["indexed_schedule", "karras_sigma_ramp", "scaled_linear_alphas_sigmas"]
