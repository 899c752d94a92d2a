from perceptor_tpu_torch.schedules.cosine import (
    alpha_sigma_to_log_snr,
    alpha_sigma_to_t,
    get_ddpm_schedule,
    get_log_schedule,
    get_spliced_ddpm_cosine_schedule,
    log_snr_to_alpha_sigma,
    sigma_to_t,
    t_to_alpha_sigma,
)
from perceptor_tpu_torch.schedules.ddpm import linear_alphas_sigmas, scaled_linear_alphas_sigmas
from perceptor_tpu_torch.schedules.karras import (
    indexed_schedule,
    karras_sigma_ramp,
    velocity_schedule_ts,
)

__all__ = [
    "alpha_sigma_to_log_snr",
    "alpha_sigma_to_t",
    "get_ddpm_schedule",
    "get_log_schedule",
    "get_spliced_ddpm_cosine_schedule",
    "indexed_schedule",
    "karras_sigma_ramp",
    "linear_alphas_sigmas",
    "log_snr_to_alpha_sigma",
    "scaled_linear_alphas_sigmas",
    "sigma_to_t",
    "t_to_alpha_sigma",
    "velocity_schedule_ts",
]
